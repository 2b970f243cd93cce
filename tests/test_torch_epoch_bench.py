"""scripts/torch_trainer_epoch_bench.py, the port's epoch benchmark,
against ast_tpu's scripts/trainer_epoch_bench.py on the CPU: its copies
of EPOCH_BUCKETS, FLAGSHIP_MCFG and _decile_spread, its corpus (byte for
byte, on a two-bucket subset) and its configs; and one tiny run of the
script on the CPU through its entry point.  No tolerance: everything
compared is equal."""

import copy
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import bench
import __graft_entry__
from tests.conftest import TINY_MODEL_CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


port = _script("torch_trainer_epoch_bench")
ref = _script("trainer_epoch_bench")

# a short bucket and the 1,680-frame one, at reduced counts
SUBSET = [(0, 3, 80, 16), (19, 2, 1680, 96)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tests: several test workers
    with a torch thread a core each oversubscribe the cores, which slows
    these small steps many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_constants_equal_ast_tpu():
    assert port.EPOCH_BUCKETS == bench.EPOCH_BUCKETS
    assert port.FLAGSHIP_MCFG == __graft_entry__.FLAGSHIP_MCFG
    assert port.VOCAB_WORDS == ref.VOCAB_WORDS
    assert sum(n for _, n, _, _ in port.EPOCH_BUCKETS) == 17306
    for v in ([], [3.0], [1.0, 2.0, 4.0, 8.0], [5.5, 5.25, 5.75]):
        assert port._decile_spread(v) == bench._decile_spread(v)


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_corpus_byte_equal_on_a_bucket_subset(tmp_path, monkeypatch):
    """Every file of the corpus (features, pickles, references) byte-equal
    to ast_tpu's over the same buckets."""
    monkeypatch.setattr(bench, "EPOCH_BUCKETS", SUBSET)
    n_ref = ref.build_corpus(str(tmp_path / "ref"), log=lambda *a: None)
    n_port = port.build_corpus(str(tmp_path / "port"), log=lambda *a: None,
                               buckets=port.parse_buckets("0:3,19:2"))
    assert n_port == n_ref == 5
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "ref")
    assert sorted(got) == sorted(want) and len(got) > 15
    for k in want:
        assert got[k] == want[k], k


def test_configs_equal_ast_tpu_at_bf16(tmp_path):
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "exp"))
    kw = dict(transfer_dtype="bfloat16", prefetch_workers=3, hbm_cache=True,
              hbm_cache_dtype="bfloat16")
    exp = ref.write_configs(root, 32, 4, **kw)
    want = {n: open(os.path.join(exp, n)).read()
            for n in ("train_cfg.json", "model_cfg.json")}
    assert port.write_configs(root, 32, 4, **kw) == exp
    for n, text in want.items():
        assert open(os.path.join(exp, n)).read() == text, n
    port.write_configs(root, 32, 1, compute_dtype="float32", remat=True)
    with open(os.path.join(exp, "train_cfg.json")) as f:
        extras = json.load(f)["extras"]
    assert extras["compute_dtype"] == "float32" and extras["remat"]


def test_parse_buckets():
    assert port.parse_buckets(None) is None
    assert port.parse_buckets("19:2,0:3") == [SUBSET[1], SUBSET[0]]


def test_bench_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The script end to end on two buckets, with the tiny model in
    FLAGSHIP_MCFG's place: one line an epoch, then its JSON object with
    bench.py's keys; a CPU run names itself and reads no device metric."""
    tiny = copy.deepcopy(TINY_MODEL_CFG)
    tiny["rnn_config"]["dec_vocab_size"] = 1098
    tiny["dropout"] = {"embed": 0.3, "rnn": 0.3, "out": 0}
    monkeypatch.setattr(port, "FLAGSHIP_MCFG", tiny)
    out = port.main(["--device", "cpu", "--buckets", "0:8,1:6",
                     "--batch", "4", "--g", "2", "--epochs", "3",
                     "--root", str(tmp_path), "--hbm-cache",
                     "--transfer-dtype", "bfloat16", "--remat"])
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1]) == out
    assert sum(ln.startswith("epoch ") for ln in lines) == 3
    for k in ("metric", "value", "unit", "config",
              "trainer_epochs_utts_per_sec", "trainer_epoch_seconds",
              "trainer_spread", "device", "steps_per_epoch",
              "device_busy_ms_per_step", "idle_share", "peak_mib",
              "h2d_bytes_per_step"):
        assert k in out, k
    assert out["metric"].endswith("_cpu") and out["device"]["name"] == "cpu"
    assert out["device_busy_ms_per_step"] is None and out["peak_mib"] is None
    assert len(out["trainer_epochs_utts_per_sec"]) == 2
    assert out["steps_per_epoch"] == 4          # 8 / 4 + 6 / 4 rounded up
    assert out["value"] > 0 and "hbm_cache" in out["config"]
    # hbm_cache: indices, the dropout mask and targets cross, no features
    assert out["h2d_bytes_per_step"] < 4 * 160 * 13
