"""Fixtures of the benchmark's CPU tests: a copy of ``benchmark/`` with a
tiny configuration and mixes (the harness's own code, the model cut to
a size a CPU run holds), and the marker of the tests that need a card."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_MODEL = {
    "dropout": {"embed": 0.3, "rnn": 0.3, "out": 0},
    "rnn_config": {"bi_rnn": True, "enc_layers": 2, "dec_layers": 2,
                   "hidden_units": 32, "embedding_units": 16,
                   "attn_units": 32, "n_attn": 1, "feed_attn": True,
                   "ln": False},
    "cnn_config": {"bn": True, "cnn_layers": [
        {"in_channels": None, "out_channels": 8, "ksize": [9, 13],
         "stride": [2, 13], "pad": [4, 0]},
        {"in_channels": None, "out_channels": 16, "ksize": [9, 1],
         "stride": [2, 1], "pad": [4, 0]}]},
}
TINY_BUCKETS = [[0, 9, 80, 16], [1, 6, 160, 16], [2, 5, 240, 32]]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


def tiny_config(base="es_en_20h", **extras):
    with open(os.path.join(BENCH, "configs", f"{base}.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny"
    cfg["vocab_size"] = 24
    cfg["model_cfg"] = json.loads(json.dumps(TINY_MODEL))
    cfg["train_cfg"]["batch_size"] = 4
    cfg["train_cfg"]["data"]["buckets_num"] = 3
    cfg["train_cfg"]["extras"].update(extras)
    return cfg


@pytest.fixture
def bench_root(tmp_path):
    return make_bench_root(tmp_path)


def make_bench_root(tmp_path):
    """A copy of benchmark/ and BENCHMARK.json under tmp_path with the
    tiny cells: tiny.train (es_en_20h's recipe), tiny_g2.train (the bf16
    configuration's feed, G = 2, at f32), tiny.decode."""
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        ".cache", "__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    cfgs = {"tiny": tiny_config(),
            "tiny_g2": tiny_config(hbm_cache=True, steps_per_dispatch=2),
            "tiny_bf16": tiny_config("es_en_20h_bf16")}
    for name, cfg in cfgs.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    corpus = {"seed": 3, "feat_dim": 13,
              "buckets": TINY_BUCKETS}
    (root / "traffic" / "tiny_train.json").write_text(json.dumps(
        {"driver": "train", "corpus": corpus}))
    (root / "traffic" / "tiny_dev.json").write_text(json.dumps(
        {"driver": "decode", "beam": [3, 3], "batch": 4, "max_pred": 12,
         "sample": 6, "corpus": corpus}))
    limits = {"train": {"feed": 0, "loss": 1e-4, "grad": 1e-3,
                        "change": 1e-3},
              "decode": {"token": 1e-3, "score": 1e-4, "order": 0,
                         "dup": 0}}
    for cell, cfg, mix, kind in [
            ("tiny.train", "tiny", "tiny_train", "train"),
            ("tiny_g2.train", "tiny_g2", "tiny_train", "train"),
            ("tiny_bf16.train", "tiny_bf16", "tiny_train", "train"),
            ("tiny.decode", "tiny", "tiny_dev", "decode")]:
        (root / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"config": cfg, "traffic": mix, "chips": 1,
             "limits": limits[kind]}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    tiny = {"train": ["tiny.train", "tiny_g2.train", "tiny_bf16.train"],
            "beam5": ["tiny.decode"]}
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if "workloads" in m:
                kind = next(k for k in tiny if k in m["workloads"][0])
                m["workloads"] = tiny[kind]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
