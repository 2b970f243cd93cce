"""ast_tpu_torch's pretrain-and-transfer workflow against ast_tpu's, on
the CPU: the Chainer checkpoint conversions, the checkpoint tools
(``list_checkpoints``, ``average_checkpoints``, ``transfer_params``), the
``copy_params`` CLI, every entry point on a reference experiment
directory, and the WER and unigram precision / recall scorers.

Tolerances: every comparison is bit-equal (key remapping, copies and the
same float64 sums), except where a model runs: the first training loss
after resuming a Chainer checkpoint within 1e-5 relative (as
``tests/test_torch_train.py``'s loss) and beam scores within 1e-4 (as
``tests/test_torch_beam_cli.py``).
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ast_tpu.cli import beam as jax_beam
from ast_tpu.cli import copy_params as jax_copy
from ast_tpu.cli import export_model as jax_export
from ast_tpu.cli import infer as jax_infer
from ast_tpu.cli import serve as jax_serve
from ast_tpu.config import Config as JaxConfig
from ast_tpu.eval import metrics as jax_metrics
from ast_tpu.eval import wer as jax_wer
from ast_tpu.models import seq2seq as jax_seq2seq
from ast_tpu.train import chainer_import as jax_ci
from ast_tpu.train import checkpoint as jax_ckpt
from ast_tpu.train.trainer import NN as JaxNN
from ast_tpu_torch import checkpoint as ckpt
from ast_tpu_torch import eval as port_eval
from ast_tpu_torch.checkpoint import flatten
from ast_tpu_torch.cli import beam, copy_params, export_model, infer, serve
from ast_tpu_torch.cli import train as train_cli
from ast_tpu_torch.eval import metrics, wer
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.ops.lstm import lstm_gates
from ast_tpu_torch.params import tree_map
from ast_tpu_torch.symbols import SYMBOLS
from ast_tpu_torch.train import chainer_import as ci
from ast_tpu_torch.train.optimizer import build_optimizer
from ast_tpu_torch.train.trainer import NN, to_numpy
from tests.conftest import TINY_MODEL_CFG, make_tiny_experiment
from tests.test_torch_train import _jax_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 12
TRAIN, DEV = "tiny_train", "tiny_dev"


def _mcfg(cnn=None, **rnn_over):
    mcfg = jax.tree.map(lambda x: x, TINY_MODEL_CFG)
    mcfg["rnn_config"] = dict(mcfg["rnn_config"], dec_vocab_size=V,
                              **rnn_over)
    mcfg["cnn_config"] = dict(mcfg["cnn_config"], **(cnn or {}))
    return mcfg


def _jax_init(mcfg, seed):
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(seed), mcfg)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def _jax_flat(tree):
    return jax_ckpt._flatten(jax.tree.map(np.asarray, tree))


def _assert_flat_equal(got, want):
    """Two flat dicts: the same keys, dtypes and values, bit for bit."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _assert_trees_equal(got, want):
    _assert_flat_equal(flatten(got), _jax_flat(want))


def _write_chainer(path, params, state):
    """A file as the reference writes it: an open handle handed to
    numpy.savez_compressed, so no .npz suffix."""
    with open(path, "wb") as f:
        np.savez_compressed(f, **jax_ci.ast_to_chainer(params, state))


# ---------------------------------------------------------------------------
# 1. the Chainer conversions
# ---------------------------------------------------------------------------

VARIANTS = {
    "tiny": ({}, {}),
    "ln_proj_2heads": ({}, {"ln": True, "linear_proj": True, "n_attn": 2}),
    "unidirectional": ({}, {"bi_rnn": False}),
    "unidirectional_ln": ({}, {"bi_rnn": False, "ln": True}),
    "linear_proj": ({}, {"linear_proj": True}),
    "text_encoder": ({}, {"enc_vocab_size": 10}),
    "no_bn": ({"bn": False}, {}),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_chainer_conversions_match_ast_tpu(variant):
    """ast_to_chainer and chainer_to_ast give ast_tpu's arrays both ways,
    and the round trip is the identity, for every variant ast_tpu's
    converter takes; the port's init_model builds each of them with the
    converted tree's leaves."""
    cnn, rnn = VARIANTS[variant]
    params, state = _jax_init(_mcfg(cnn, **rnn), seed=1)
    built = [flatten(to_numpy(t)) for t in
             seq2seq.init_model(_mcfg(cnn, **rnn), seed=1)]
    arrays = ci.ast_to_chainer(params, state)
    _assert_flat_equal(arrays, jax_ci.ast_to_chainer(params, state))
    assert ci.is_chainer_checkpoint(arrays)
    assert not ci.is_chainer_checkpoint(_jax_flat({"params": params}))
    back = ci.chainer_to_ast(arrays)
    _assert_flat_equal(flatten(back), _jax_flat(jax_ci.chainer_to_ast(arrays)))
    _assert_trees_equal(back["params"], params)
    _assert_trees_equal(back["state"], state)
    for got, want in zip(built, (flatten(back["params"]),
                                 flatten(back["state"]))):
        assert {k: np.shape(v) for k, v in got.items()} == \
            {k: np.shape(v) for k, v in want.items()}


def test_chainer_enc_only_layernorm_is_refused_as_ast_tpu():
    params, state = _jax_init(_mcfg(ln=True), seed=2)
    arrays = jax_ci.ast_to_chainer(params, state)
    for k in [k for k in arrays if k.startswith("L0_dec_ln/")]:
        del arrays[k]
    with pytest.raises(ValueError) as want:
        jax_ci.chainer_to_ast(arrays)
    with pytest.raises(ValueError) as got:
        ci.chainer_to_ast(arrays)
    assert str(got.value) == str(want.value)


def _chainer_lstm_step(up_w, up_b, lat_w, h, c, x):
    """Chainer's L.LSTM from its documented semantics: z = upward(x) +
    lateral(h), gates interleaved per unit in order (a, i, f, o), a the
    tanh cell candidate; c' = a*i + f*c; h' = o*tanh(c')."""
    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))
    z = x @ up_w.T + up_b + h @ lat_w.T
    r = z.reshape(z.shape[0], -1, 4)
    a, i, f, o = np.tanh(r[..., 0]), sig(r[..., 1]), sig(r[..., 2]), \
        sig(r[..., 3])
    c_new = a * i + f * c
    return o * np.tanh(c_new), c_new


def _decoder_archive(**over):
    """A minimal Chainer decoder around the arrays under test."""
    H = 4
    a = {"embed_dec/W": np.zeros((V, H), np.float32),
         "out/W": np.zeros((V, H), np.float32),
         "out/b": np.zeros((V,), np.float32),
         "attn_Wa/W": np.zeros((H, H), np.float32),
         "attn_Wa/b": np.zeros((H,), np.float32),
         "context/W": np.zeros((H, 2 * H), np.float32),
         "context/b": np.zeros((H,), np.float32)}
    a.update(over)
    return a


def test_lstm_gate_order_semantics():
    """The converted cell, run by the port's gate math, computes
    Chainer's cell."""
    rng = np.random.default_rng(0)
    H, IN, B = 5, 7, 3
    up_w = rng.normal(size=(4 * H, IN)).astype(np.float32)
    up_b = rng.normal(size=(4 * H,)).astype(np.float32)
    lat_w = rng.normal(size=(4 * H, H)).astype(np.float32)
    h, c = (rng.normal(size=(B, H)).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(B, IN)).astype(np.float32)
    h_ref, c_ref = _chainer_lstm_step(up_w, up_b, lat_w, h, c, x)
    p = ci.chainer_to_ast(_decoder_archive(**{
        "L0_dec/upward/W": up_w, "L0_dec/upward/b": up_b,
        "L0_dec/lateral/W": lat_w}))["params"]["dec"]["lstm"][0]
    z = (torch.from_numpy(x) @ torch.from_numpy(p["wx"])
         + torch.from_numpy(h) @ torch.from_numpy(p["wh"])
         + torch.from_numpy(p["b"]))
    h_new, c_new = lstm_gates(z, torch.from_numpy(c), H)
    np.testing.assert_allclose(h_new.numpy(), h_ref, atol=1e-6)
    np.testing.assert_allclose(c_new.numpy(), c_ref, atol=1e-6)


def test_linear_semantics():
    """Chainer's y = x @ W.T + b equals ours after the transpose."""
    rng = np.random.default_rng(1)
    W = rng.normal(size=(V, 4)).astype(np.float32)
    b = rng.normal(size=(V,)).astype(np.float32)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    dec = ci.chainer_to_ast(_decoder_archive(**{"out/W": W, "out/b": b}))
    dec = dec["params"]["dec"]
    np.testing.assert_allclose(x @ dec["out_w"] + dec["out_b"], x @ W.T + b,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# 2. the checkpoint module
# ---------------------------------------------------------------------------

def test_load_checkpoint_converts_a_chainer_archive(tmp_path):
    params, state = _jax_init(_mcfg(), seed=2)
    path = str(tmp_path / "seq2seq_3.model")
    _write_chainer(path, params, state)
    got = ckpt.load_checkpoint(path)
    assert set(got) == {"params", "state"}          # no optimizer state
    _assert_flat_equal(flatten(got), _jax_flat(jax_ckpt.load_checkpoint(path)))
    _assert_trees_equal(got["params"], params)
    assert ckpt.latest_checkpoint(str(tmp_path)) == (path, 3)


@pytest.mark.parametrize("names,want", [
    (["seq2seq_2.model", "seq2seq_2.model.npz"], "seq2seq_2.model.npz"),
    (["seq2seq_2.model.npz", "seq2seq_5.model", "seq2seq_inflight.npz",
      "seq2seq_avg_1-2.model.npz", "other.npz"], "seq2seq_5.model"),
    ([], None),
], ids=["ours-wins-a-tie", "newer-reference-wins", "empty"])
def test_list_and_latest_checkpoint_match_ast_tpu(tmp_path, names, want):
    for name in names:
        (tmp_path / name).write_bytes(b"x")
    d = str(tmp_path)
    assert ckpt.list_checkpoints(d) == jax_ckpt.list_checkpoints(d)
    assert ckpt.latest_checkpoint(d) == jax_ckpt.latest_checkpoint(d)
    if want is None:
        assert ckpt.latest_checkpoint(d) == (None, 0)
    else:
        assert ckpt.latest_checkpoint(d)[0] == os.path.join(d, want)


@pytest.mark.parametrize("groups", [("enc",), ("enc", "attn"),
                                    ("enc", "attn", "dec")],
                         ids=lambda g: ",".join(g))
def test_transfer_params_matches_ast_tpu(groups):
    """Both packages transfer into one NumPy target: whole trees equal;
    the copied groups and, with enc, the BN state are the donor's."""
    src_p, src_s = _jax_init(_mcfg(), seed=3)
    src_s = jax.tree.map(lambda a: a + 0.5, src_s)      # trained BN stats
    dst_p, dst_s = _jax_init(_mcfg(), seed=4)
    got = ckpt.transfer_params(src_p, dst_p, groups, src_s, dst_s)
    want = jax_ckpt.transfer_params(src_p, dst_p, groups, src_s, dst_s)
    _assert_flat_equal(flatten({"p": got[0], "s": got[1]}),
                       _jax_flat({"p": want[0], "s": want[1]}))
    for key in ("cnn", "enc", "attn", "dec"):
        donor = any(key in ckpt.TRANSFER_GROUPS[g] for g in groups)
        _assert_trees_equal(got[0][key], (src_p if donor else dst_p)[key])
    _assert_trees_equal(got[1], src_s if "enc" in groups else dst_s)


def test_transfer_params_refuses_other_shapes():
    """A decoder of another vocab: both packages refuse it, naming the
    group; a leaf of another shape alone gives ast_tpu's message."""
    src_p, _ = _jax_init(_mcfg(), seed=3)
    dst_p, _ = _jax_init(dict(_mcfg(), rnn_config=dict(
        _mcfg()["rnn_config"], dec_vocab_size=V + 3)), seed=4)
    for fn in (ckpt.transfer_params, jax_ckpt.transfer_params):
        with pytest.raises(ValueError, match="transferring 'dec'"):
            fn(src_p, dst_p, ("enc", "attn", "dec"))
    ckpt.transfer_params(src_p, dst_p, ("enc", "attn"))    # the rest fits
    bad = dict(src_p, attn=dict(src_p["attn"], context={
        "w": src_p["attn"]["context"]["w"][:, :4],
        "b": src_p["attn"]["context"]["b"]}))
    with pytest.raises(ValueError) as got:
        ckpt.transfer_params(bad, dst_p, ("attn",))
    with pytest.raises(ValueError) as want:
        jax_ckpt.transfer_params(bad, dst_p, ("attn",))
    assert str(got.value) == str(want.value)
    assert "'attn'" in str(got.value) and "(32, 4)" in str(got.value)
    shallow = dict(src_p, enc=dict(src_p["enc"], lstm=src_p["enc"]["lstm"][:1]))
    with pytest.raises(ValueError, match="enc"):
        ckpt.transfer_params(shallow, dst_p, ("enc",))


def test_average_checkpoints_matches_ast_tpu(tmp_path):
    """Three checkpoints, one of them a reference .model: params and BN
    state bit-equal to ast_tpu's mean and to NumPy's float64 mean, no
    optimizer state."""
    trees = [_jax_init(_mcfg(), seed=s) for s in (5, 6, 7)]
    trees = [(p, jax.tree.map(lambda a, i=i: a + i, s))
             for i, (p, s) in enumerate(trees)]
    paths = []
    for i, (p, s) in enumerate(trees):
        if i == 1:
            paths.append(str(tmp_path / f"seq2seq_{i + 1}.model"))
            _write_chainer(paths[-1], p, s)
        else:
            paths.append(jax_ckpt.checkpoint_path(str(tmp_path), i + 1))
            jax_ckpt.save_checkpoint(paths[-1], p, s,
                                     opt_state={"mu": np.ones(3)})
    got = ckpt.average_checkpoints(paths)
    want = jax_ckpt.average_checkpoints(paths)
    _assert_flat_equal(flatten({"p": got[0], "s": got[1]}),
                       _jax_flat({"p": want[0], "s": want[1]}))
    flat = [_jax_flat({"p": p, "s": s}) for p, s in trees]
    mean = {k: ((flat[0][k].astype(np.float64) + flat[1][k]
                 + flat[2][k]) / 3).astype(np.float32)
            for k in flat[0] if flat[0][k].dtype == np.float32}
    got_flat = flatten({"p": got[0], "s": got[1]})
    for k, v in mean.items():
        np.testing.assert_array_equal(got_flat[k], v, err_msg=k)
    with pytest.raises(ValueError, match="no checkpoints"):
        ckpt.average_checkpoints([])


# ---------------------------------------------------------------------------
# 3. the copy_params CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def donor(tmp_path_factory):
    """A donor experiment with checkpoints of epochs 1-3 (distinct BN
    stats) and two targets of the same model config."""
    root = tmp_path_factory.mktemp("transfer")
    exps = {name: make_tiny_experiment(str(root / name))
            for name in ("src", "port_dst", "jax_dst")}
    mcfg = JaxConfig(exps["src"]).model
    for epoch in (1, 2, 3):
        p, s = _jax_init(mcfg, seed=10 + epoch)
        s = jax.tree.map(lambda a, e=epoch: a + e, s)
        jax_ckpt.save_checkpoint(
            jax_ckpt.checkpoint_path(exps["src"], epoch), p, s,
            opt_state={"count": np.asarray(epoch)})
    return exps


def _lines(out):
    return [line for line in out.splitlines() if line]


def test_copy_params_cli_transfer(donor, capsys):
    """The port's output loads in both packages; its copied groups and BN
    state are the donor's, the rest the port's seed-0 init; ast_tpu's
    output loads in the port with the same copied groups."""
    src = donor["src"]
    out = copy_params.main(["--src", src, "--dst", donor["port_dst"],
                            "--groups", "enc,attn", "--device", "cpu"])
    port_lines = _lines(capsys.readouterr().out)
    jax_copy.main(["--src", src, "--dst", donor["jax_dst"],
                   "--groups", "enc,attn"])
    jax_lines = _lines(capsys.readouterr().out)
    assert out == ckpt.checkpoint_path(donor["port_dst"], 0)
    assert [line.replace(donor["port_dst"], "D") for line in port_lines] == \
        [line.replace(donor["jax_dst"], "D") for line in jax_lines]
    assert "encoder conv weights match donor: True" in port_lines

    ours = ckpt.load_checkpoint(out)
    assert set(ours) == {"params", "state"}      # the trainer starts afresh
    _assert_flat_equal(flatten(ours), _jax_flat(jax_ckpt.load_checkpoint(out)))
    donor_snap = ckpt.load_checkpoint(ckpt.checkpoint_path(src, 3))
    fresh = [tree_map(lambda t: t.numpy(), t) for t in seq2seq.init_model(
        JaxConfig(donor["port_dst"]).model, seed=0)]
    theirs = ckpt.load_checkpoint(ckpt.checkpoint_path(donor["jax_dst"], 0))
    for key in ("cnn", "enc", "attn"):
        _assert_flat_equal(flatten(ours["params"][key]),
                           flatten(donor_snap["params"][key]))
        _assert_flat_equal(flatten(theirs["params"][key]),
                           flatten(donor_snap["params"][key]))
    _assert_flat_equal(flatten(ours["params"]["dec"]),
                       flatten(fresh[0]["dec"]))
    _assert_flat_equal(flatten(ours["state"]), flatten(donor_snap["state"]))
    # the port's NN resumes it at epoch 0 with a fresh optimizer
    nn = NN(donor["port_dst"], "cpu")
    assert nn.max_epoch == 0 and nn.loaded_ckpt == out


def test_copy_params_cli_average(donor, tmp_path, capsys):
    src = donor["src"]
    out = copy_params.main(["--src", src, "--average", "last:2"])
    port_lines = _lines(capsys.readouterr().out)
    got = ckpt.load_checkpoint(out)
    os.remove(out)
    jax_copy.main(["--src", src, "--average", "last:2"])
    assert _lines(capsys.readouterr().out) == port_lines
    assert port_lines[0] == f"averaged epochs [2, 3] -> {out}"
    _assert_flat_equal(flatten(got), _jax_flat(jax_ckpt.load_checkpoint(out)))
    assert set(got) == {"params", "state"}
    want = ckpt.average_checkpoints([ckpt.checkpoint_path(src, e)
                                     for e in (2, 3)])
    _assert_flat_equal(flatten({"params": want[0], "state": want[1]}),
                       flatten(got))
    os.remove(out)
    named = str(tmp_path / "avg.npz")
    assert copy_params.main(["--src", src, "--average", "1,3",
                             "--out", named]) == named
    with pytest.raises(FileNotFoundError, match=r"epochs \[7\]"):
        copy_params.main(["--src", src, "--average", "1,7"])
    with pytest.raises(ValueError, match="K >= 1"):
        copy_params.main(["--src", src, "--average", "last:0"])


def test_copy_params_cli_export_chainer(donor, tmp_path, capsys):
    """Both packages' archives hold the same arrays under no .npz suffix;
    each package loads the other's back to the donor's tree."""
    src = donor["src"]
    port_out, jax_out = (str(tmp_path / f"{n}_seq2seq_3.model")
                         for n in ("port", "jax"))
    copy_params.main(["--src", src, "--export-chainer", port_out])
    port_lines = _lines(capsys.readouterr().out)
    jax_copy.main(["--src", src, "--export-chainer", jax_out])
    jax_lines = _lines(capsys.readouterr().out)
    assert [line.replace(port_out, "F") for line in port_lines] == \
        [line.replace(jax_out, "F") for line in jax_lines]
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(p) for p in (port_out, jax_out))
    with np.load(port_out) as a, np.load(jax_out) as b:
        _assert_flat_equal({k: a[k] for k in a.files},
                           {k: b[k] for k in b.files})
    donor_snap = ckpt.load_checkpoint(ckpt.checkpoint_path(src, 3))
    want = flatten({"params": donor_snap["params"],
                    "state": donor_snap["state"]})
    _assert_flat_equal(flatten(ckpt.load_checkpoint(jax_out)), want)
    _assert_flat_equal(_jax_flat(jax_ckpt.load_checkpoint(port_out)), want)
    with pytest.raises(SystemExit):
        copy_params.main(["--src", src])                 # no --dst
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        copy_params.main(["--src", str(empty), "--dst", src])


# ---------------------------------------------------------------------------
# 4. the entry points on a reference experiment directory
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_dir(tmp_path_factory):
    """A tiny experiment whose only checkpoint is a Chainer
    ``seq2seq_4.model``; its (params, state) and dev feature files."""
    root = tmp_path_factory.mktemp("reference_dir")
    exp = make_tiny_experiment(str(root), n_dev=5)
    p, s = _jax_init(JaxConfig(exp).model, seed=21)
    # EOS held back so the hypotheses are not all empty
    p["dec"]["out_b"] = p["dec"]["out_b"] + np.eye(
        1, p["dec"]["out_b"].shape[0], 2, dtype=np.float32)[0] * -2.0
    s = jax.tree.map(lambda a: a + 0.25, s)
    _write_chainer(os.path.join(exp, "seq2seq_4.model"), p, s)
    speech = os.path.join(str(root), "speech", DEV)
    paths = [os.path.join(speech, f) for f in sorted(os.listdir(speech))]
    return exp, p, s, paths


def test_nn_resumes_a_chainer_model(reference_dir, tmp_path):
    """NN resumes at the .model's epoch with its weights and a fresh
    optimizer, and the first training loss equals ast_tpu's resume."""
    exp, p, s, _ = reference_dir
    nn, ref = NN(exp, "cpu"), JaxNN(exp)
    assert nn.max_epoch == ref.max_epoch == 4
    assert nn.loaded_ckpt == os.path.join(exp, "seq2seq_4.model")
    _assert_trees_equal(to_numpy(nn.params), p)
    _assert_trees_equal(to_numpy(nn.state), s)
    fresh = build_optimizer(nn.cfg.train["optimizer"], nn.params,
                            seed=nn.seed)[1]
    _assert_flat_equal(flatten(to_numpy(nn.opt_state)),
                       flatten(to_numpy(fresh)))

    batch = next(iter(nn.data_loader.get_batch(
        4, TRAIN, train=True, labels=True, epoch=5, tail_shrink=8)))
    mcfg = jax.tree.map(lambda x: x, ref.mcfg)
    mcfg["rnn_config"] = dict(mcfg["rnn_config"], fused_encoder=True,
                              fused_decoder=True, fused_interpret=True)
    extras = nn.cfg.train["extras"]
    key = jax.random.PRNGKey(5)
    want, _ = jax_seq2seq.forward_loss(
        ref.params, ref.state, mcfg, jnp.asarray(batch["X"]),
        jnp.asarray(batch["y"]), key, train=True,
        n_real=float(batch["n_real"]), teach_ratio=extras["teach_ratio"],
        add_noise=extras["speech_noise"])
    draws = _jax_draws(key, batch["X"].shape, batch["y"].shape[1] - 1,
                       extras["teach_ratio"], extras["speech_noise"])
    got, _ = seq2seq.forward_loss(
        nn.params, nn.state, nn.mcfg, torch.from_numpy(batch["X"]),
        torch.from_numpy(batch["y"]).long(), float(batch["n_real"]), draws)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_train_cli_resumes_a_reference_dir(reference_dir, tmp_path):
    exp = make_tiny_experiment(str(tmp_path))
    _, p, s, _ = reference_dir
    _write_chainer(os.path.join(exp, "seq2seq_4.model"), p, s)
    train_cli.main(["-m", exp, "-e", "1", "--device", "cpu"])
    with open(os.path.join(exp, "train.log")) as f:
        rows = [line.split(", ") for line in f.read().splitlines()]
    assert [r[0] for r in rows] == ["5"] and np.isfinite(float(rows[0][1]))
    assert ckpt.latest_checkpoint(exp) == (ckpt.checkpoint_path(exp, 5), 5)
    snap = ckpt.load_checkpoint(ckpt.checkpoint_path(exp, 5))
    assert int(snap["opt"][2][0]) > 0       # AMSGrad's count: steps taken


@pytest.mark.parametrize("extra", [[], ["--beam", "3,3", "-w", "0.6"]],
                         ids=["greedy", "beam"])
def test_infer_cli_on_a_reference_dir(reference_dir, extra):
    exp, _, _, paths = reference_dir
    want = jax_infer.main(["-m", exp, "--batch", "2"] + extra + paths)
    got = infer.main(["-m", exp, "--batch", "2", "--device", "cpu"]
                     + extra + paths)
    assert got == want and any(got.values())


def test_beam_cli_on_a_reference_dir(reference_dir):
    exp = reference_dir[0]
    args = ["-m", exp, "-n", "3", "-k", "3", "-s", DEV, "-w", "0.6"]
    pkl = os.path.join(exp, f"{DEV}_beam_N-3_K-3.p")
    en = os.path.join(exp, f"{DEV}_beam_N-3_K-3_W-0.60.en")
    outs = []
    for run in (lambda: jax_beam.main(args),
                lambda: beam.main(args + ["--device", "cpu"])):
        bleu = run()
        with open(pkl, "rb") as f, open(en, "rb") as g:
            outs.append((f"{bleu:.2f}", pickle.load(f), g.read()))
        os.remove(pkl)
        os.remove(en)
    (ref_bleu, ref_beam, ref_text), (bleu, got_beam, text) = outs
    assert bleu == ref_bleu and text == ref_text and text.strip()
    assert list(got_beam) == list(ref_beam)
    for utt in ref_beam:
        for (g_ids, g_s), (r_ids, r_s) in zip(got_beam[utt], ref_beam[utt]):
            assert g_ids == r_ids and abs(g_s - r_s) < 1e-4, utt


def test_export_and_serve_a_reference_dir(reference_dir, tmp_path):
    """export_model takes the .model; the port's server decodes with it
    as ast_tpu's server does with ast_tpu's export."""
    exp, p, _, paths = reference_dir
    common = ["-m", exp, "--batch", "2", "--frames", "60"]
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    export_model.main(common + ["-o", port_dir])
    jax_export.main(common + ["--platforms", "cpu", "--dtype", "float32",
                              "-o", jax_dir])
    port = serve.ArtifactServer(port_dir, device="cpu")
    ref = jax_serve.ArtifactServer(jax_dir)
    for path in paths[:3]:
        x = np.load(path).astype(np.float32)[:60]
        got, want = port.decode({"features": x}), ref.decode({"features": x})
        assert (got["ids"], got["text"]) == (want["ids"], want["text"])


# ---------------------------------------------------------------------------
# 5. WER and unigram precision / recall
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ref,hyp,want", [
    ("a b c", "a b c", (0, 0, 0)),
    ("a", "b", (1, 0, 0)),
    ("a b c", "a c", (0, 0, 1)),
    ("a c", "a b c", (0, 1, 0)),
    ("", "x y", (0, 2, 0)),
    ("a b", "", (0, 0, 2)),
    ("a b", "b a", (2, 0, 0)),              # substitution first, as Kaldi
    ("a b c d", "x a b c", (0, 1, 1)),
], ids=["equal", "sub", "del", "ins", "empty-ref", "empty-hyp",
        "swap-ties-to-subs", "shift"])
def test_edit_stats_hand_cases(ref, hyp, want):
    assert wer.edit_stats(ref.split(), hyp.split()) == want
    assert jax_wer.edit_stats(ref.split(), hyp.split()) == want


def _random_corpus(seed, n=40):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(6)] + [SYMBOLS.UNK.decode(),
                                           SYMBOLS.EOS.decode()]
    refs, hyps = {}, {}
    for i in range(n):
        refs[f"u{i:03d}"] = list(rng.choice(words, rng.integers(0, 12)))
        if rng.random() > 0.1:              # some utterances lack a hyp
            hyps[f"u{i:03d}"] = list(rng.choice(words, rng.integers(0, 12)))
    return refs, hyps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corpus_wer_matches_ast_tpu(seed):
    refs, hyps = _random_corpus(seed)
    got = wer.corpus_wer(refs, hyps)
    assert got == jax_wer.corpus_wer(refs, hyps)
    assert wer.format_report(got) == jax_wer.format_report(got)
    assert got["n_utts"] == len(refs) and got["errors"] > 0


def _write_trn(path, table):
    with open(path, "w", encoding="utf-8") as f:
        for utt, toks in table.items():
            f.write(f"{' '.join(toks)} ({utt})\n")


@pytest.mark.parametrize("hyp_format", ["trn", "lines"])
def test_wer_cli_matches_ast_tpu(tmp_path, capsys, hyp_format):
    """The trn round trip and the CLI (in process and as ``python -m``),
    with hypotheses as a trn file or as lines ordered by --ids."""
    refs, hyps = _random_corpus(3, n=12)
    ref_path, hyp_path = str(tmp_path / "dev.clean.wer"), str(tmp_path / "h")
    _write_trn(ref_path, refs)
    assert wer.read_trn(ref_path) == refs == jax_wer.read_trn(ref_path)
    argv = [ref_path, hyp_path, "--per-utt"]
    if hyp_format == "trn":
        _write_trn(hyp_path, hyps)
    else:
        ids = sorted(refs)
        with open(str(tmp_path / "eval.ids"), "w") as f:
            f.write("\n".join(ids) + "\n")
        with open(hyp_path, "w") as f:
            f.write("".join(" ".join(hyps.get(u, [])) + "\n" for u in ids))
        argv += ["--ids", str(tmp_path / "eval.ids")]
    got = wer.main(argv)
    out = capsys.readouterr().out
    assert got == jax_wer.main(argv)
    assert capsys.readouterr().out == out
    assert out.splitlines()[-1] == wer.format_report(got)
    res = subprocess.run([sys.executable, "-m", "ast_tpu_torch.eval.wer"]
                         + argv, cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    assert res.stdout == out


@pytest.mark.parametrize("case", ["stray-hyp", "too-many-lines",
                                  "short-lines", "not-trn"])
def test_wer_mismatched_inputs_like_ast_tpu(tmp_path, case):
    refs = {"a": ["x", "y"], "b": ["z"]}
    ref_path, hyp_path = str(tmp_path / "r"), str(tmp_path / "h")
    ids_path = str(tmp_path / "ids")
    _write_trn(ref_path, refs)
    with open(ids_path, "w") as f:
        f.write("a\nb\n")
    argv = [ref_path, hyp_path]
    if case == "stray-hyp":
        _write_trn(hyp_path, {"a": ["x"], "c": ["q"]})
    elif case == "too-many-lines":
        with open(hyp_path, "w") as f:
            f.write("x y\nz\nw\n")
        argv += ["--ids", ids_path]
    elif case == "short-lines":                 # a missing line: deletions
        with open(hyp_path, "w") as f:
            f.write("x y\n\n")
        argv += ["--ids", ids_path]
        got = wer.main(argv)
        assert got == jax_wer.main(argv)
        assert (got["del"], got["errors"], got["n_ref"]) == (1, 1, 3)
        return
    else:
        with open(hyp_path, "w") as f:
            f.write("x y a\n")
    with pytest.raises(ValueError) as got:
        wer.main(argv)
    with pytest.raises(ValueError) as want:
        jax_wer.main(argv)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unigram_precision_recall_matches_ast_tpu(seed):
    """Seeded random hypotheses, several references a segment, UNK / EOS
    tokens and ids among them, empty hypotheses included."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(8)] + [
        SYMBOLS.UNK, SYMBOLS.EOS, SYMBOLS.UNK.decode(), SYMBOLS.EOS.decode(),
        SYMBOLS.UNK_ID, SYMBOLS.EOS_ID]

    def sent(lo=0):
        return [vocab[i] for i in rng.integers(0, len(vocab),
                                               rng.integers(lo, 10))]
    refs = [[sent(1) for _ in range(rng.integers(1, 4))] for _ in range(30)]
    hyps = [sent() for _ in range(30)]
    got = metrics.unigram_precision_recall(refs, hyps)
    assert got == jax_metrics.unigram_precision_recall(refs, hyps)
    assert 0 < got[0] < 100 and 0 < got[1] < 100
    assert port_eval.unigram_precision_recall is \
        metrics.unigram_precision_recall


# ---------------------------------------------------------------------------
# 6. the transfer A/B's corpus
# ---------------------------------------------------------------------------

def _load_script(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_transfer_ab_corpus_matches_ast_tpu(tmp_path, monkeypatch):
    """scripts/torch_transfer_ab.py's NumPy copy of the corpus builder
    writes ast_tpu's corpus and configs (paths aside)."""
    # the scripts put directories on sys.path when they load
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setitem(os.environ, "JAX_PLATFORMS",
                        os.environ.get("JAX_PLATFORMS", "cpu"))
    port_ab, jax_ab = (_load_script(n) for n in ("torch_transfer_ab",
                                                 "transfer_ab"))
    roots = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    made = {name: mod.build_tasks(roots[name], n_asr=6, n_st=5, n_dev=3)
            for name, mod in (("port", port_ab), ("jax", jax_ab))}

    def tree(name):
        out = {}
        for d, _, files in os.walk(roots[name]):
            for fname in files:
                path = os.path.join(d, fname)
                rel = os.path.relpath(path, roots[name])
                if fname.endswith(".npy"):
                    out[rel] = np.load(path)
                elif fname.endswith(".json"):
                    with open(path) as f:
                        out[rel] = f.read().replace(roots[name], "ROOT")
                else:
                    with open(path, "rb") as f:
                        out[rel] = (pickle.load(f) if "data_" in rel
                                    else f.read())
        return out

    port, ref = tree("port"), tree("jax")
    assert sorted(port) == sorted(ref) and len(port) > 20
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(port[k], v, err_msg=k)
        else:
            assert port[k] == v, k
    assert [os.path.relpath(p, roots["port"]) for p in (
        made["port"][0], *made["port"][1].values())] == [
        os.path.relpath(p, roots["jax"]) for p in (
            made["jax"][0], *made["jax"][1].values())]
