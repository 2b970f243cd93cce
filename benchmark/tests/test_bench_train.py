"""The training driver end to end on the CPU at a tiny size: a sound run
comes out correct, and the timed path broken underneath comes out not
correct."""

import io
import json
import time

import pytest

from benchmark.core import cli


def run_cell(root, cell, seed=11, seconds=1.0, trace=0):
    out, err = io.StringIO(), io.StringIO()
    rc = cli.run(["--workload", cell, "--seed", str(seed), "--seconds",
                  str(seconds), "--trace", str(trace)], time.perf_counter(),
                 root=str(root), bench_path=str(root.parent /
                                                "BENCHMARK.json"),
                 device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["tiny.train", "tiny_g2.train"])
def test_train_cell_correct(bench_root, cell):
    line = run_cell(bench_root, cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_utts_per_s", "setup_s"}
    assert list(line)[-1] == "checks"
