"""The port's spans and counters (``ast_tpu_torch.utils.profiling``):
disarmed without a profile, on the profiler's clock when armed,
parents across the feed's worker threads, ``idle_by_span``'s arithmetic,
and every span and counter of ``NN.train_epoch`` and the decodes with
their counts.  One test runs on the card only: a span around a
synchronised kernel encloses the kernel's device span
(``python -m pytest tests/test_torch_spans.py -m chip --noconftest``
there: this directory's conftest imports JAX)."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ast_tpu_torch.train import trainer
from ast_tpu_torch.train.trainer import NN, Prefetcher
from ast_tpu_torch.utils import profiling
from ast_tpu_torch.utils.profiling import (
    RECORDER, Recorder, SpanRecord, idle_by_span)

TRAIN, DEV = "tiny_train", "tiny_dev"
S = 10 ** 9     # ns a second


@pytest.fixture(autouse=True)
def clean_recorder():
    RECORDER.reset()
    yield
    RECORDER.reset()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _no_record_function(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered while disarmed")
    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        refuse)


def _tiny(root, **extras):
    from tests.conftest import make_tiny_experiment
    exp = make_tiny_experiment(str(root), n_train=14, n_dev=5, batch_size=4)
    path = os.path.join(exp, "train_cfg.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["extras"].update(extras)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return exp


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_disarmed_span_records_nothing_and_enters_no_record_function(
        monkeypatch):
    _no_record_function(monkeypatch)
    rec = Recorder()
    assert not profiling.armed()
    with rec.span("a", epoch=1):
        with rec.span("b"):
            rec.count("c", 3)
    # one shared do-nothing context: nothing is made per span
    assert rec.span("a") is rec.span("b")
    assert rec.current() is None
    assert rec.spans() == [] and rec.counters() == {}
    assert rec.totals() == {"spans": {}, "counters": {}}


def test_disarmed_epoch_and_decode_record_nothing(tmp_path, monkeypatch):
    """The whole training and decode path, no profile: no span,
    no counter, no ``record_function``."""
    nn = NN(_tiny(tmp_path), "cpu")
    _no_record_function(monkeypatch)
    nn.train_epoch(TRAIN, epoch=1)
    nn.decode_beam_set(DEV, 2, 2)
    nn.predict(DEV)
    assert RECORDER.spans() == [] and RECORDER.counters() == {}


def test_span_shares_the_profilers_clock():
    """A span opened inside ``record_function("outer")`` lies within the
    profiler's ``start_ns()``-``end_ns()`` of ``outer``, and its own
    ``record_function`` is in the trace."""
    rec = Recorder()
    with _cpu_profile() as prof:
        assert profiling.armed()
        with record_function("outer"):
            with rec.span("inner", rows=4):
                torch.ones(64).sum()
    assert not profiling.armed()
    (inner,) = rec.spans()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    outer = events["outer"]
    assert outer.start_ns() <= inner.start_ns < inner.end_ns \
        <= outer.end_ns()
    assert "inner" in events
    assert inner.attrs == {"rows": 4}


def test_parents_nest_and_an_exception_closes_the_span():
    rec = Recorder()
    with _cpu_profile():
        with rec.span("a"):
            with rec.span("b"):
                rec.count("n", 2)
                rec.count("n")
            with pytest.raises(ValueError):
                with rec.span("c"):
                    raise ValueError
            with rec.span("b"):
                pass
    by_name = {}
    for r in rec.spans():
        by_name.setdefault(r.name, []).append(r)
    (a,), bs, (c,) = by_name["a"], by_name["b"], by_name["c"]
    assert a.parent is None and c.parent == a.id
    assert [b.parent for b in bs] == [a.id, a.id]
    assert c.end_ns is not None and c.end_ns >= c.start_ns
    tot = rec.totals()
    assert tot["spans"]["b"]["n"] == 2 and tot["counters"] == {"n": 3}
    assert rec.totals(under="a")["spans"].keys() == {"b", "c"}
    rec.reset()
    assert rec.spans() == [] and rec.counters() == {}


def test_feed_workers_take_the_starters_span_as_parent():
    items = list(range(7))
    with _cpu_profile():
        with profiling.span("outer"):
            got = list(Prefetcher(iter(items), lambda x: 2 * x, depth=4,
                                  workers=3))
    assert got == [2 * x for x in items]
    spans = RECORDER.spans()
    (outer,) = [r for r in spans if r.name == "outer"]
    worker = [r for r in spans if r.name in ("feed.assemble", "feed.stage")]
    assert {r.parent for r in worker} == {outer.id}
    assert {r.thread for r in worker}.isdisjoint({outer.thread})
    tot = RECORDER.totals(under="outer")["spans"]
    # one stage an item; a pull an item, and the pulls that found the
    # stream's end
    assert tot["feed.stage"]["n"] == len(items)
    assert len(items) < tot["feed.assemble"]["n"] <= len(items) + 3
    assert tot["feed.wait"]["n"] >= len(items)
    waits = [r for r in spans if r.name == "feed.wait"]
    assert {r.thread for r in waits} == {outer.thread}


def test_many_threads_lose_no_span_nor_count():
    """More threads than cores, a switch every microsecond: every span
    and every count of every thread is in the totals, each id once."""
    import sys
    import threading

    rec, n_threads, n_each = Recorder(), 16, 200

    def work():
        for _ in range(n_each):
            with rec.span("w"):
                rec.count("n")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    tot = rec.totals()
    assert tot["spans"]["w"]["n"] == n_threads * n_each
    assert tot["counters"] == {"n": n_threads * n_each}
    assert len({r.id for r in rec.spans()}) == n_threads * n_each


# ---------------------------------------------------------------------------
# idle_by_span
# ---------------------------------------------------------------------------

def _rec(i, name, a, b, thread, parent):
    return SpanRecord(i, name, a * S, b * S, thread, parent, {})


@pytest.mark.parametrize("order", ["sorted", "reversed"])
def test_idle_by_span_on_hand_made_spans(order):
    """Device busy over [0,10], [20,40], [60,70] of a 120 s window: idle
    [10,20], [40,60], [70,120], each piece put down to the innermost
    main-thread span open over it, past the outer span's end to
    ``(none)``."""
    device = [(0, 10 * S), (20 * S, 30 * S), (25 * S, 40 * S),
              (60 * S, 70 * S)]
    spans = [_rec(1, "R", 0, 100, 1, None), _rec(2, "A", 5, 50, 1, 1),
             _rec(3, "A1", 15, 35, 1, 2), _rec(4, "B", 55, 90, 1, 1),
             # a worker's feed span over [35, 65] and one that is not feed
             _rec(5, "feed.stage", 35, 65, 2, 1),
             _rec(6, "other", 0, 120, 2, 1)]
    if order == "reversed":
        device, spans = device[::-1], spans[::-1]
    out = idle_by_span(device, spans, window=(0, 120 * S))
    assert out["window_s"] == 120 and out["busy_s"] == 40
    assert out["idle_s"] == 80
    assert out["idle_by_span"] == pytest.approx(
        {"A": 15, "A1": 5, "R": 15, "B": 25, "(none)": 20})
    assert list(out["idle_by_span"])[:2] == ["B", "(none)"]
    assert out["idle_feed_worker_s"] == pytest.approx(20)
    assert out["idle_feed_worker_share"] == pytest.approx(20 / 80)
    # without a window: the extent of the main thread's spans
    assert idle_by_span(device, spans)["window_s"] == 100


def test_idle_by_span_with_no_device_work():
    spans = [_rec(1, "R", 2, 6, 1, None), _rec(2, "A", 3, 4, 1, 1)]
    out = idle_by_span([], spans)
    assert out["idle_s"] == 4 and out["busy_s"] == 0
    assert out["idle_by_span"] == pytest.approx({"R": 3, "A": 1})
    assert out["idle_feed_worker_share"] == 0


def test_profile_trace_writes_the_idle_by_span_file(tmp_path):
    with profiling.profile_trace(str(tmp_path)):
        with profiling.span("work"):
            torch.ones(8).sum()
    names = sorted(os.listdir(tmp_path))
    assert [n.split("_")[0] for n in names] == ["idle", "trace"]
    with open(tmp_path / names[0]) as f:
        out = json.load(f)
    assert out["totals"]["spans"]["work"]["n"] == 1
    assert out["idle_s"] <= out["window_s"]


# ---------------------------------------------------------------------------
# the program's spans and counters
# ---------------------------------------------------------------------------

def _epoch_items(nn, epoch):
    """The epoch's host batches and the Prefetcher's items (runs)."""
    G = nn.steps_per_dispatch
    batches = list(nn.data_loader.get_batch(
        4, TRAIN, train=True, labels=True, epoch=epoch, group_runs=G,
        tail_shrink=nn.tail_shrink, index_cache=nn._cache(TRAIN)))
    runs = list(trainer._group_stream(iter(batches), G)) if G > 1 \
        else [[b] for b in batches]
    return batches, runs


def _frames(batches):
    T = [b["drop_mask"].shape[1] if b.get("X") is None else b["X"].shape[1]
         for b in batches]
    return (sum(int(np.sum(b["frame_len"])) for b in batches),
            sum(int(b["rows"]) * t for b, t in zip(batches, T)))


@pytest.mark.parametrize("extras", [
    {}, {"steps_per_dispatch": 2}, {"hbm_cache": True}],
    ids=["host", "g2", "hbm_cache"])
def test_train_epoch_records_every_span_and_counter(tmp_path, extras):
    nn = NN(_tiny(tmp_path, **extras), "cpu")
    batches, runs = _epoch_items(nn, 1)
    with _cpu_profile():
        nn.train_epoch(TRAIN, epoch=1)
    tot = RECORDER.totals()
    spans, counters = tot["spans"], tot["counters"]
    steps = len(batches)
    assert steps == nn.timer.n_steps
    for name, n in [("train.epoch", 1), ("train.loss_sync", 1),
                    ("train.step", steps), ("train.draws", steps),
                    ("train.forward", steps), ("train.backward", steps),
                    ("train.all_reduce", steps),
                    ("train.optimizer", steps), ("feed.stage", len(runs))]:
        assert spans[name]["n"] == n, name
    # every stage on its kernels' route (their plain versions on the CPU)
    assert counters["train.plain_stages"] == 0
    assert spans["feed.wait"]["n"] >= len(runs)
    assert spans["feed.assemble"]["n"] > len(runs)
    assert counters["feed.h2d_bytes"] == nn.epoch_h2d_bytes > 0
    real, padded = _frames(batches)
    assert counters["train.frames_real"] == real
    assert counters["train.frames_padded"] == padded
    assert 0 < real < padded
    # the step's pieces lie inside it, the steps inside the epoch
    inside = RECORDER.totals(under="train.step")["spans"]
    assert inside.keys() == {"train.draws", "train.forward",
                             "train.backward", "train.all_reduce",
                             "train.optimizer"}
    assert RECORDER.totals(under="train.backward")["spans"].keys() == {
        "train.all_reduce"}
    inside.pop("train.all_reduce")
    assert RECORDER.totals(under="train.epoch")["spans"].keys() \
        == spans.keys() - {"train.epoch"}
    assert sum(inside[k]["s"] for k in inside) <= spans["train.step"]["s"]


def test_hbm_cache_moves_fewer_bytes_a_step(tmp_path):
    per_step = {}
    for name, extras in [("host", {}), ("cache", {"hbm_cache": True})]:
        nn = NN(_tiny(tmp_path / name, **extras), "cpu")
        RECORDER.reset()
        with _cpu_profile():
            nn.train_epoch(TRAIN, epoch=1)
        tot = RECORDER.totals()
        per_step[name] = (tot["counters"]["feed.h2d_bytes"]
                          / tot["spans"]["train.step"]["n"])
    assert per_step["cache"] < per_step["host"] / 5


@pytest.mark.parametrize("how", ["beam", "greedy"])
def test_decode_records_every_span_and_counter(tmp_path, how):
    nn = NN(_tiny(tmp_path), "cpu")
    batches = list(nn.data_loader.get_batch(
        4, DEV, train=False, labels=False, epoch=None,
        tail_shrink=nn.tail_shrink))
    with _cpu_profile():
        if how == "beam":
            nn.decode_beam_set(DEV, 2, 2)
        else:
            nn.predict(DEV)
    tot = RECORDER.totals()
    spans, counters = tot["spans"], tot["counters"]
    n = len(batches)
    for name, want in [("decode.pass", 1), ("decode.setup", 1),
                       ("decode.issue", n), ("decode.drain_wait", n),
                       ("decode.collect", n), ("feed.stage", n)]:
        assert spans[name]["n"] == want, name
    under = RECORDER.totals(under="decode.pass")["spans"]
    assert under["feed.wait"]["n"] >= n
    assert not {k for k in spans if k.startswith("train.")}
    real, padded = _frames(batches)
    assert counters["decode.frames_real"] == real
    assert counters["decode.frames_padded"] == padded
    assert counters["feed.h2d_bytes"] > 0


def _profile_files(logdir):
    names = sorted(os.listdir(logdir))
    assert [n.split("_")[0] for n in names] == ["idle", "trace"]
    with open(os.path.join(logdir, names[0])) as f:
        out = json.load(f)
    with open(os.path.join(logdir, names[1])) as f:
        trace = {e.get("name") for e in json.load(f)["traceEvents"]}
    return out, trace


@pytest.mark.parametrize("cli", ["train", "beam"])
def test_cli_profile_writes_trace_and_idle_by_span(tmp_path, cli):
    """``--profile LOGDIR``: the Chrome trace holds the spans, and the
    idle-by-span file their totals; the recorder is disarmed after."""
    exp = _tiny(tmp_path / "exp")
    logdir = str(tmp_path / "prof")
    if cli == "train":
        from ast_tpu_torch.cli import train
        train.main(["-m", exp, "-e", "1", "--profile", logdir,
                    "--device", "cpu"])
        names = {"train.epoch", "train.step", "train.forward",
                 "feed.stage"}
    else:
        from ast_tpu_torch.cli import beam
        beam.main(["-m", exp, "-n", "2", "-k", "2", "-s", DEV, "-w", "0.6",
                   "--profile", logdir, "--device", "cpu"])
        names = {"decode.pass", "decode.setup", "decode.issue",
                 "decode.drain_wait", "decode.collect", "feed.stage"}
    out, trace = _profile_files(logdir)
    assert names <= set(out["totals"]["spans"]) and names <= trace
    assert out["idle_s"] <= out["window_s"]
    assert sum(out["idle_by_span"].values()) == pytest.approx(out["idle_s"])
    assert not profiling.armed()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.chip
def test_span_encloses_its_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.randn(2048, 2048, device="cuda")
    (x @ x).sum().item()        # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with profiling.span("matmul"):
            y = x @ x
            torch.cuda.synchronize()
    del y
    (sp,) = [r for r in RECORDER.spans() if r.name == "matmul"]
    device = profiling.trace_device_spans(prof)
    assert device
    a, b, name = max(device, key=lambda d: d[1] - d[0])
    assert sp.start_ns <= a < b <= sp.end_ns, (sp, a, b, name)
