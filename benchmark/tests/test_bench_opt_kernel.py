"""``opt_kernel_share.train``: the share of a traced window's training
steps whose optimizer update ran through the program's optimizer kernel
(the counter ``train.opt_kernel_updates`` over the ``train.step``
spans).  Listed for the two training cells; None untraced, in a decode
run and on a program without the counter; the right share on planted
recorder totals."""

import json

import pytest

from ast_tpu_torch.utils import profiling
from benchmark.core import cli
from test_bench_harness import BENCH

NAME = "opt_kernel_share.train"
TRACED = {"kind": "train", "window_s": 3.0, "busy_s": 1.0}


def _totals(steps, updates=None):
    counters = {"feed.h2d_bytes": 1e6}
    if updates is not None:
        counters["train.opt_kernel_updates"] = updates
    return {"spans": {"train.step": {"s": 2.0, "n": steps},
                      "train.optimizer": {"s": 0.1, "n": steps}},
            "counters": counters}


def test_listed_for_the_training_cells():
    bench = json.load(open(f"{BENCH}/../BENCHMARK.json"))
    (m,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert m == {"name": NAME, "unit": "%", "better": "higher",
                 "source": "program_counter", "layer": "model step",
                 "moves": "train_utts_per_s",
                 "workloads": ["es_en_20h.train_fisher20h",
                               "es_en_20h_bf16.train_fisher20h_g4"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert set(m["workloads"]) <= cells


@pytest.mark.parametrize("steps,updates,want", [
    (10, 10, 100.0), (8, 2, 25.0), (10, 0, 0.0), (10, None, None)],
    ids=["every_step", "a_quarter", "none", "no_counter"])
def test_reads_the_counter_over_the_steps(steps, updates, want,
                                          monkeypatch):
    read = cli.load_metric(BENCH, NAME)
    monkeypatch.setattr(profiling, "totals",
                        lambda under=None: _totals(steps, updates))
    got = read(TRACED)
    assert got == (None if want is None else pytest.approx(want))
    # untraced, a decode run
    assert read({"kind": "train", "window_s": 3.0, "utts": 5}) is None
    assert read(dict(TRACED, kind="decode")) is None


def test_none_without_the_recorder_or_the_steps(monkeypatch):
    read = cli.load_metric(BENCH, NAME)
    monkeypatch.setattr(profiling, "totals", lambda under=None: {
        "spans": {}, "counters": {"train.opt_kernel_updates": 3}})
    assert read(TRACED) is None
    # a program without the recorder
    monkeypatch.delattr(profiling, "totals")
    assert read(TRACED) is None
