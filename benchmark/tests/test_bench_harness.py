"""The harness's own arithmetic and its contract with files: a cell, a
configuration, a mix and a per-layer metric added as files are found
with no code edited; a rate over a window that holds a stall; the
modules that the harness and the reference import."""

import ast
import json
import os
import time

import pytest
import torch

from benchmark.core import cli
from benchmark.core.probes import Deadline, StopWindow
from test_bench_train import run_cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_files_dropped_in_are_found(bench_root):
    """A new configuration, mix, cell and per-layer metric, as files and
    entries only."""
    cfg = json.loads((bench_root / "configs" / "tiny.json").read_text())
    cfg["train_cfg"]["batch_size"] = 8
    (bench_root / "configs" / "tiny_b8.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_root / "traffic" / "tiny_train.json")
                     .read_text())
    mix["corpus"]["seed"] = 9
    (bench_root / "traffic" / "tiny_other.json").write_text(json.dumps(mix))
    (bench_root / "workloads" / "tiny_b8.other.json").write_text(json.dumps(
        {"config": "tiny_b8", "traffic": "tiny_other", "chips": 1,
         "limits": {"feed": 0, "loss": 1e-4, "grad": 1e-3,
                    "change": 1e-3}}))
    (bench_root / "metrics" / "steps.train.py").write_text(
        "def read(rec):\n    return float(rec['attempted'])\n")
    path = bench_root.parent / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["per_layer"].append(
        {"name": "steps.train", "unit": "steps", "better": "higher",
         "source": "program_counter", "layer": "model step",
         "moves": "train_utts_per_s", "workloads": ["tiny_b8.other"]})
    path.write_text(json.dumps(bench))
    line = run_cell(bench_root, "tiny_b8.other", trace=1)
    assert line["correct"], line["checks"]
    assert line["metrics"]["steps.train"]["value"] == line["attempted"]
    assert "steps.train" not in run_cell(bench_root, "tiny.train",
                                         trace=1)["metrics"]


def test_rate_counts_a_stall_in_the_window():
    """The window ends at the first call boundary past its end, the
    device drained, and the rate is the work over all of it: a stall
    inside the window lowers the rate by its whole length."""
    read = cli.load_metric(BENCH, "train_utts_per_s")
    deadline = Deadline(torch.device("cpu"))
    t0 = time.perf_counter()
    deadline.at = t0 + 0.3
    utts = 0
    with pytest.raises(StopWindow):
        for i in range(10 ** 6):
            deadline.check()
            time.sleep(0.25 if i == 3 else 0.005)
            utts += 32
    window = deadline.t_end - t0
    rate = read({"kind": "train", "utts": utts, "window_s": window})
    assert window >= 0.3 and window < 0.3 + 0.25 + 0.1
    assert rate == pytest.approx(utts / window)
    assert rate < utts / (window - 0.25) * 0.75


def test_forbidden_modules_compares_whole_top_level_names():
    names = {"ast_tpu_torch", "ast_tpu_torch.ops", "ast_tpu.ops", "jax",
             "jaxlib.xla", "flax", "jaxtyping", "benchmark.core"}
    assert cli.forbidden_modules(names) == ["ast_tpu.ops", "flax", "jax",
                                            "jaxlib.xla"]


def _imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(sub=""):
    for root, _, files in os.walk(os.path.join(BENCH, sub)):
        if "tests" in root.split(os.sep) or ".cache" in root:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_harness_imports_no_jax_nor_the_jax_package():
    for path in _sources():
        bad = _imports(path) & set(cli.FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    allowed = {"torch", "numpy", "benchmark", "math", "random", "hashlib",
               "dataclasses", "typing"}
    for path in _sources("reference"):
        names = _imports(path)
        assert names <= allowed, (path, names - allowed)
        src = open(path).read()
        assert "benchmark.core" not in src and "benchmark.traffic" not in src


def test_a_run_loads_no_jax(bench_root):
    """The harness's own end-of-run check: a run that loaded one of the
    names prints no result and fails."""
    import io
    import sys
    out, err = io.StringIO(), io.StringIO()
    saved = sys.modules.get("jax")
    try:
        sys.modules["jax"] = sys.modules["json"]
        rc = cli.run(["--workload", "tiny.train", "--seed", "1",
                      "--seconds", "0.5"], time.perf_counter(),
                     root=str(bench_root),
                     bench_path=str(bench_root.parent / "BENCHMARK.json"),
                     device="cpu", out=out, err=err)
    finally:
        if saved is None:
            del sys.modules["jax"]
        else:
            sys.modules["jax"] = saved
    assert rc != 0 and out.getvalue() == ""
    assert "jax" in err.getvalue()
