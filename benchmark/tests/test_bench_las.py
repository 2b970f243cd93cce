"""The LAS cell and the data-parallel cell at a tiny size on the CPU: the
harness finds their configuration, mixes, drivers and metrics; the LAS
reference agrees with the program; the LAS cell's control (FP8) and
faults read not correct under its limits while the program reads
correct; the wide decoder's cost equals ``kernel_cost`` at He == H; the
dp4 driver trains two gloo ranks against the reference over their
global batch."""

import json
import os

import pytest

from conftest import REPO
from benchmark.yardstick.kernel_cost import kernel_cost
from benchmark.yardstick.kernel_cost_wide import kernel_cost_wide
from test_bench_controls import calibrate, fails, limits
from test_bench_faults import frozen_state
from test_bench_train import run_cell

LAS = "las_6_1280_bf16.train_librispeech960"
DP4 = "es_en_20h.train_fisher20h_dp4"
TINY_LAS_MODEL = {
    "dropout": {"embed": 0.3, "rnn": 0.3, "out": 0},
    "rnn_config": {"bi_rnn": True, "enc_layers": 2, "enc_units": 32,
                   "enc_stacking": "joint", "dec_layers": 2,
                   "hidden_units": 32, "embedding_units": 16,
                   "attn_units": 32, "n_attn": 1, "feed_attn": True,
                   "ln": False},
    "cnn_config": {"bn": True, "plane_bins": 8, "cnn_layers": [
        {"in_channels": 3, "out_channels": 4, "ksize": [3, 3],
         "stride": [2, 2], "pad": [1, 1]},
        {"in_channels": None, "out_channels": 4, "ksize": [3, 3],
         "stride": [2, 2], "pad": [1, 1]}]},
}


def _add(root, cells):
    """The tiny LAS cells (``tiny_las.train``, bf16 as the full-size
    cell, and ``tiny_las32.train`` at f32, whose program readings lie
    far under the cell's limits at any seed) and the tiny two-rank cell
    (``tiny_dp2.train``) in ``root``, reported by the metrics that
    report their full-size cells."""
    cfg = json.loads((root / "configs" / "las_6_1280_bf16.json")
                     .read_text())
    cfg["model_cfg"] = json.loads(json.dumps(TINY_LAS_MODEL))
    cfg["vocab_size"] = 24
    tcfg = cfg["train_cfg"]
    tcfg["batch_size"] = 4
    tcfg["data"].update(buckets_num=3, buckets_width=80, max_pred=32)
    tcfg["data"]["spec_augment"].update(freq_width=3, time_width=5)
    (root / "configs" / "tiny_las.json").write_text(json.dumps(cfg))
    tcfg["extras"]["compute_dtype"] = "float32"
    (root / "configs" / "tiny_las32.json").write_text(json.dumps(cfg))
    corpus = {"seed": 3, "feat_dim": 24,
              "buckets": [[0, 9, 80, 16], [1, 6, 160, 16], [2, 5, 240, 32]]}
    (root / "traffic" / "tiny_las_train.json").write_text(json.dumps(
        {"driver": "train_las", "corpus": corpus}))
    mix = json.loads((root / "traffic" / "tiny_train.json").read_text())
    (root / "traffic" / "tiny_dp2_train.json").write_text(json.dumps(
        dict(mix, driver="train_dp4", ranks=2, rows_per_rank=2)))
    for cell, config, traffic, full in (
            ("tiny_las.train", "tiny_las", "tiny_las_train", LAS),
            ("tiny_las32.train", "tiny_las32", "tiny_las_train", LAS),
            ("tiny_dp2.train", "tiny", "tiny_dp2_train", DP4)):
        (root / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"config": config, "traffic": traffic, "chips": 1,
             "limits": limits(full)}))
    path = root.parent / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        full_bench = json.load(f)
    for group in ("end_to_end", "per_layer"):
        for m, full_m in zip(bench[group], full_bench[group]):
            for cell, full in cells:
                if full in full_m.get("workloads", []):
                    m["workloads"].append(cell)
    path.write_text(json.dumps(bench))


@pytest.fixture
def las_root(bench_root):
    _add(bench_root, [("tiny_las.train", LAS), ("tiny_las32.train", LAS),
                      ("tiny_dp2.train", DP4)])
    return bench_root


def test_las_cell_is_found_and_correct(las_root):
    line = run_cell(las_root, "tiny_las32.train")
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_utts_per_s", "setup_s"}
    assert set(line["checks"]) == set(limits(LAS))


def test_las_trace_reports_its_host_metrics_only_on_the_card(las_root):
    """On the CPU the window is not traced: the per-layer metrics that
    read the trace, the spans or the kernels' timers read nothing."""
    line = run_cell(las_root, "tiny_las32.train", trace=1)
    assert line["correct"], line["checks"]
    assert not set(line["metrics"]) & {
        "plain_route_share.train", "host_share.train.enc_layer",
        "k3_wide_roofline", "k4_wide_roofline", "k1_train_roofline"}


@pytest.mark.parametrize("seed", [1, 2])
def test_las_reference_agrees_with_the_program_at_f32(las_root, seed):
    program, _ = calibrate(las_root, "tiny_las32.train", seed, "half")
    assert program["feed"] == 0
    assert program["loss"] < 1e-5 and program["grad"] < 1e-4, program
    assert program["change"] < 1e-4, program


@pytest.mark.parametrize("control", ["fp8", "half"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_las_control_and_half_batch_are_not_correct(las_root, control,
                                                    seed):
    program, low = calibrate(las_root, "tiny_las.train", seed, control)
    lim = limits(LAS)
    assert not fails(program, lim), program
    assert fails(low, lim), low


@pytest.mark.parametrize("control", ["tf32", "half"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_dp4_limits_fail_the_tf32_control_and_half_batch(bench_root, control,
                                                         seed):
    """The four-rank cell's limits (set from its four-rank readings) read
    the one-process program correct and the TF32 control and the
    half-batch fault not correct, on the tiny es_en model."""
    program, low = calibrate(bench_root, "tiny.train", seed, control)
    lim = limits(DP4)
    assert not fails(program, lim), program
    assert fails(low, lim), low


def half_batch(monkeypatch):
    """``test_bench_faults``' half-batch fault, the rows' frame counts
    (SpecAugment's time masks) cut with them."""
    from ast_tpu_torch.train import trainer

    step = trainer.NN.train_step

    def half(self, batch, seed):
        n = max(1, batch["n_real"] // 2)
        cut = {k: batch[k][:n] for k in ("X", "y", "rows_idx", "drop_mask",
                                          "frame_len")
               if batch.get(k) is not None}
        return step(self, dict(batch, n_real=n, **cut), seed)
    monkeypatch.setattr(trainer.NN, "train_step", half)


@pytest.mark.parametrize("fault", [frozen_state, half_batch])
def test_las_faults_are_not_correct(las_root, monkeypatch, fault):
    fault(monkeypatch)
    assert not run_cell(las_root, "tiny_las32.train")["correct"]


def test_las_driver_gives_no_result_without_joint_stacking(
        las_root, monkeypatch):
    """A program that ignores ``enc_stacking`` would train another
    model: ``train_las`` stops before its set-up."""
    from ast_tpu_torch.models import seq2seq

    init = seq2seq.init_model

    def direction_stacked(mcfg, *a, **kw):
        mcfg = dict(mcfg, rnn_config=dict(mcfg["rnn_config"],
                                          enc_stacking="direction"))
        return init(mcfg, *a, **kw)
    monkeypatch.setattr(seq2seq, "init_model", direction_stacked)
    with pytest.raises(SystemExit, match="no result"):
        run_cell(las_root, "tiny_las32.train")


@pytest.mark.parametrize("d", [
    dict(B=32, T=160, H=512, L=3, E=128, A=512, V=1098, U=48, n_logits=9),
    dict(B=64, T=875, H=1280, L=2, E=512, A=1280, V=16384, U=144,
         n_logits=30, wbytes=2)])
@pytest.mark.parametrize("key", ["k3", "k4"])
def test_wide_cost_is_kernel_cost_at_equal_widths(key, d):
    assert kernel_cost_wide(key, dict(d, He=d["H"])) == kernel_cost(key, d)
    assert kernel_cost_wide(key, d) == kernel_cost(key, d)
    wide = kernel_cost_wide(key, dict(d, He=2 * d["H"]))
    assert wide[0] > kernel_cost(key, d)[0]
    assert wide[1] > kernel_cost(key, d)[1]


def test_dp_driver_trains_two_gloo_ranks_against_the_reference(las_root):
    line = run_cell(las_root, "tiny_dp2.train")
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"train_utts_per_s", "setup_s"}
    assert line["checks"]["feed"]["value"] == 0


TRACED = {"kind": "train", "window_s": 3.0, "busy_s": 1.0}


def _totals(spans=(), counters=None):
    got = {"spans": {"train.step": {"s": 2.0, "n": 10}},
           "counters": dict(counters or {})}
    got["spans"].update({k: {"s": 0.3, "n": 10} for k in spans})
    return got


@pytest.mark.parametrize("name,spans,counters,want", [
    ("plain_route_share.train", (), {"train.plain_stages": 0}, 0.0),
    ("plain_route_share.train", (), {"train.plain_stages": 4}, 20.0),
    ("plain_route_share.train", (), None, None),
    ("host_share.train.enc_layer", ("train.enc_layer",), None, 10.0),
    ("host_share.train.enc_layer", (), None, None),
    ("host_share.train.all_reduce", ("train.all_reduce",), None, 10.0),
    ("host_share.train.all_reduce", (), None, None)])
def test_new_span_and_counter_readers(monkeypatch, name, spans, counters,
                                      want):
    """Each reads its span or counter from a traced window, and nothing
    where the program records none (a program without them, as this
    PR's parent, reads None)."""
    from ast_tpu_torch.utils import profiling
    from benchmark.core import cli

    read = cli.load_metric(os.path.join(REPO, "benchmark"), name)
    monkeypatch.setattr(profiling, "totals",
                        lambda under=None: _totals(spans, counters))
    got = read(TRACED)
    assert got == (None if want is None else pytest.approx(want))
    assert read({"kind": "train", "window_s": 3.0, "utts": 5}) is None


def test_allreduce_share_reads_the_traced_nccl_time():
    from benchmark.core import cli

    read = cli.load_metric(os.path.join(REPO, "benchmark"),
                           "allreduce_share.train")
    assert read(dict(TRACED, allreduce_s=0.25)) == pytest.approx(25.0)
    assert read(TRACED) is None
    assert read({"kind": "train", "window_s": 3.0}) is None
