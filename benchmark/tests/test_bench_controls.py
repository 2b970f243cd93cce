"""Each cell's control, at a size a test run holds: the plain reference
one precision lower put in the program's place (TF32 for the float32
cells, FP8 for the bfloat16 one) comes out not correct under the cell's
own limits, while the program at the same tiny size comes out correct
under them.  (The limits were set from the readings at the cells' own
sizes on the card, ``PERF.md``.)"""

import argparse
import json
import os
import time

import pytest
import torch

from benchmark.core import cli

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def limits(cell):
    with open(os.path.join(BENCH, "workloads", f"{cell}.json")) as f:
        return json.load(f)["limits"]


def calibrate(root, cell, seed, control, config=None, mix=None):
    spec = json.loads((root / "workloads" / f"{cell}.json").read_text())
    cfg = json.loads((root / "configs" / f"{spec['config']}.json")
                     .read_text())
    traffic = json.loads((root / "traffic" / f"{spec['traffic']}.json")
                         .read_text())
    cfg.update(config or {})
    traffic.update(mix or {})
    driver = cli._load(str(root / "traffic" / f"{traffic['driver']}.py"),
                       f"benchmark_driver_{traffic['driver']}")
    ctx = cli.Context(str(root), cell, spec, cfg, traffic,
                      argparse.Namespace(seed=seed, seconds=0, trace=0),
                      torch.device("cpu"), time.perf_counter())
    out = driver.calibrate(ctx, [control])
    return out["readings"], out[control]


def fails(readings, lim):
    return any(readings[k] > v for k, v in lim.items())


@pytest.mark.parametrize("tiny,cell,control", [
    ("tiny.train", "es_en_20h.train_fisher20h", "tf32"),
    ("tiny_bf16.train", "es_en_20h_bf16.train_fisher20h_g4", "fp8")])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_training_control_is_not_correct(bench_root, tiny, cell, control,
                                         seed):
    program, low = calibrate(bench_root, tiny, seed, control)
    lim = limits(cell)
    assert not fails(program, lim), program
    assert fails(low, lim), low


@pytest.mark.parametrize("seed", [1, 3, 4])
def test_beam_control_is_not_correct(bench_root, seed):
    """At a vocabulary of 1,004 the beam's K-th and K+1-th tokens come
    near enough for TF32 to reorder them."""
    program, low = calibrate(bench_root, "tiny.decode", seed, "tf32",
                             config={"vocab_size": 1004},
                             mix={"sample": 40, "max_pred": 30})
    lim = limits("es_en_20h.beam5_dev")
    assert not fails(program, lim), program
    assert fails(low, lim), low
