"""The per-layer metrics that read the program's own spans and counters
(``core/spans.py``): None on an untraced record and on a program without
the recorder, the right number on planted recorder totals, and, found by
name, each reported by a tiny CPU run whose window a CPU profiler arms."""

import contextlib
import json

import pytest
from torch.profiler import ProfilerActivity, profile

from ast_tpu_torch.utils import profiling
from benchmark.core import cli
from test_bench_harness import BENCH
from test_bench_train import run_cell

TRAIN = {"host_share.train.draws": 10.0, "host_share.train.forward": 20.0,
         "host_share.train.backward": 30.0,
         "host_share.train.optimizer": 4.0,
         "host_share.train.feed_wait": 15.0,
         "feed_ms_per_step.train": 20.0, "h2d_mb_per_step.train": 2.5,
         "frame_use.train": 75.0}
DECODE = {"host_share.decode.setup": 10.0, "host_share.decode.issue": 50.0,
          "host_share.decode.drain_wait": 20.0,
          "host_share.decode.collect": 9.0,
          "host_share.decode.feed_wait": 3.0, "frame_use.decode": 50.0}
UNDER = {"host_share.train.feed_wait": "train.epoch",
         "host_share.decode.feed_wait": "decode.pass"}


def _spans(**secs):
    return {k.replace("_", ".", 1) if k.startswith(("train_", "decode_",
                                                    "feed_")) else k:
            {"s": s, "n": n} for k, (s, n) in secs.items()}


PLANTED = {
    "train": {"spans": _spans(
        train_epoch=(3.0, 1), train_step=(2.0, 10), train_draws=(0.3, 10),
        train_forward=(0.6, 10), train_backward=(0.9, 10),
        train_optimizer=(0.12, 10), feed_wait=(0.45, 12),
        feed_assemble=(0.05, 11), feed_stage=(0.15, 10)),
        "counters": {"feed.h2d_bytes": 25e6, "train.frames_real": 300,
                     "train.frames_padded": 400}},
    "decode": {"spans": _spans(
        decode_pass=(3.0, 1), decode_setup=(0.3, 1), decode_issue=(1.5, 5),
        decode_drain_wait=(0.6, 5), decode_collect=(0.27, 5),
        feed_wait=(0.09, 6), feed_stage=(0.2, 5)),
        "counters": {"feed.h2d_bytes": 1e6, "decode.frames_real": 100,
                     "decode.frames_padded": 200}},
}


def _new_metrics():
    bench = json.load(open(f"{BENCH}/../BENCHMARK.json"))
    return {m["name"]: m for m in bench["per_layer"]
            if m["name"] in {**TRAIN, **DECODE}}


def test_every_new_metric_is_listed_with_its_cells():
    got = _new_metrics()
    assert set(got) == set(TRAIN) | set(DECODE)
    for name, m in got.items():
        train = name in TRAIN
        assert m["moves"] == ("train_utts_per_s" if train
                              else "decode_utts_per_s")
        assert all(("train" in w) == train for w in m["workloads"])


@pytest.mark.parametrize("name", sorted({**TRAIN, **DECODE}))
def test_reader_none_untraced_and_right_on_planted_totals(name,
                                                          monkeypatch):
    kind = "train" if name in TRAIN else "decode"
    read = cli.load_metric(BENCH, name)
    asked = []

    def planted(under=None):
        asked.append(under)
        return PLANTED[kind]
    monkeypatch.setattr(profiling, "totals", planted)
    traced = {"kind": kind, "window_s": 3.0, "busy_s": 1.0}
    # untraced (no busy_s), the other kind, nothing recorded
    assert read({"kind": kind, "window_s": 3.0, "utts": 5}) is None
    assert read(dict(traced, kind="serve")) is None
    assert read(traced) == pytest.approx({**TRAIN, **DECODE}[name])
    assert asked[-1] == UNDER.get(name)
    if name.startswith("host_share"):
        # other spans recorded, none of this one's: none of the window
        monkeypatch.setattr(profiling, "totals", lambda under=None: {
            "spans": {"x": {"s": 1.0, "n": 1}}, "counters": {}})
        assert read(traced) == 0.0
    monkeypatch.setattr(profiling, "totals",
                        lambda under=None: {"spans": {}, "counters": {}})
    assert read(traced) is None
    # a program without the recorder (the parent of this benchmark)
    monkeypatch.delattr(profiling, "totals")
    assert read(traced) is None


def _profiled_window(self, timers=None):
    """The window under a CPU profile (it arms the program's
    recorder), with a device busy time of 0."""
    @contextlib.contextmanager
    def window():
        win = cli._Window()
        with timers if timers is not None else contextlib.nullcontext():
            with profile(activities=[ProfilerActivity.CPU]):
                yield win
        win.busy_s = 0.0
    return window()


@pytest.fixture
def armed_window(monkeypatch):
    profiling.reset()
    monkeypatch.setattr(cli.Context, "window", _profiled_window)
    yield
    profiling.reset()


def test_a_traced_training_run_reports_every_train_metric(bench_root,
                                                          armed_window):
    lines = {}
    for cell in ("tiny.train", "tiny_g2.train"):
        profiling.reset()
        lines[cell] = run_cell(bench_root, cell, trace=1)
    for line in lines.values():
        assert line["correct"], line["checks"]
        got = {k: v["value"] for k, v in line["metrics"].items()
               if k in TRAIN}
        assert set(got) == set(TRAIN)
        shares = [got[k] for k in TRAIN if k.startswith("host_share")]
        assert all(0 <= s <= 100 for s in shares) and sum(shares) <= 100
        assert 0 < got["frame_use.train"] <= 100
        assert got["feed_ms_per_step.train"] > 0
        assert not set(line["metrics"]) & set(DECODE)
    # hbm_cache (tiny_g2): indices, masks and targets cross, not features
    mb = {c: line["metrics"]["h2d_mb_per_step.train"]["value"]
          for c, line in lines.items()}
    assert mb["tiny_g2.train"] < mb["tiny.train"] / 5


def test_a_traced_decode_run_reports_every_decode_metric(bench_root,
                                                         armed_window):
    line = run_cell(bench_root, "tiny.decode", trace=1, seconds=3.0)
    assert line["correct"], line["checks"]
    got = {k: v["value"] for k, v in line["metrics"].items()
           if k in DECODE}
    assert set(got) == set(DECODE)
    shares = [got[k] for k in DECODE if k.startswith("host_share")]
    assert all(0 <= s <= 100 for s in shares) and sum(shares) <= 100
    assert 0 < got["frame_use.decode"] <= 100
    assert not set(line["metrics"]) & set(TRAIN)


def test_untraced_and_cpu_traced_runs_report_none_of_them(bench_root):
    """Without a profile the recorder holds nothing: a CPU run's
    traced line (no device trace) and an untraced line leave them out."""
    profiling.reset()
    for trace in (0, 1):
        line = run_cell(bench_root, "tiny.train", trace=trace)
        assert not set(line["metrics"]) & set(TRAIN)
    assert profiling.RECORDER.spans() == []
