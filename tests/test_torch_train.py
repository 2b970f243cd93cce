"""ast_tpu_torch's training path (plain PyTorch versions on the CPU) vs
ast_tpu with its Pallas kernels in interpret mode.

The same seeded numpy inputs and parameters go through both packages in
float32.  Tolerances: dropout masks, sampled decoder inputs and data
batches exactly; forward streams 1e-5 absolute (a few recurrent f32
steps, summation order the only difference); gradients through the
hand-derived backward passes rtol 1e-4 / atol 1e-5 (encoder, as
tests/test_fused_lstm.py) and rtol 2e-3 / atol 2e-4 (decoder and the
whole step, as tests/test_fused_decoder.py: attention backward sums
over the encoder axis in another order); optimizer state 1e-6.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ast_tpu.config import Config
from ast_tpu.models import seq2seq as jax_seq2seq
from ast_tpu.ops import fused_decoder as jax_fd
from ast_tpu.ops import fused_lstm as jax_fl
from ast_tpu.ops.cnn import conv_frontend as jax_conv_frontend
from ast_tpu.train import checkpoint as jax_ckpt
from ast_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from ast_tpu_torch.checkpoint import flatten
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.ops import fused_decoder, fused_lstm
from ast_tpu_torch.ops.cnn import conv_frontend
from ast_tpu_torch.ops.dropout import drop_mask
from ast_tpu_torch.params import from_jax_numpy, tree_map
from ast_tpu_torch.train.optimizer import build_optimizer, tree_leaves
from ast_tpu_torch.train.trainer import to_numpy
from tests.conftest import TINY_MODEL_CFG, make_tiny_experiment

ATOL = 1e-5
ENC_GRAD = dict(rtol=1e-4, atol=1e-5)
DEC_GRAD = dict(rtol=2e-3, atol=2e-4)
V = 12


def _t(a):
    return torch.from_numpy(np.array(a))


def _mcfg(drop=0.3):
    m = jax.tree.map(lambda x: x, TINY_MODEL_CFG)
    m["rnn_config"] = dict(m["rnn_config"], dec_vocab_size=V,
                           fused_encoder=True, fused_decoder=True,
                           fused_interpret=True)
    m["dropout"] = {"embed": drop, "rnn": drop, "out": 0}
    return m


def _counters_zero():
    for fn in (fused_lstm.fused_stacked_lstm_train,
               fused_lstm.encoder_backward, fused_decoder.decoder_forward,
               fused_decoder.decoder_backward):
        assert fn.launches == 0, fn.__name__


# ---------------------------------------------------------------------------
# 1. the dropout hash
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("shape,row_axis,offset,rows", [
    ((2, 3, 8), 1, 0, 3),      # encoder (D2, B, H), rows on axis 1
    ((4, 5), 0, 0, None),      # decoder (B, E) / (B, H)
    ((2, 3, 8), 1, 5, 16),     # a block of a larger batch
])
def test_drop_mask_matches_jax(shape, row_axis, offset, rows, rate):
    # seeds near and past 2**31, where seed + t*L + l wraps in int32
    for seed in (0, 12345, 2 ** 31 - 2, 2 ** 31 + 5, 2 ** 32 - 3):
        s32 = np.int64(seed).astype(np.uint32).astype(np.int32)
        ref = jax_fl._drop_mask(shape, rate, jnp.int32(s32),
                                row_axis=row_axis, row_offset=offset,
                                global_rows=rows)
        got = drop_mask(shape, rate, seed, row_axis=row_axis,
                        row_offset=offset, global_rows=rows)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# 2-4. conv front-end in train mode, K1 train, K2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    mcfg = _mcfg()
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(3), mcfg)
    rng = np.random.RandomState(7)
    state = jax.tree.map(np.asarray, state)
    for s in state["cnn_bn"]:
        s["bn_mean"] = rng.randn(*s["bn_mean"].shape).astype(np.float32)
        s["bn_var"] = rng.uniform(0.5, 2.0, s["bn_var"].shape).astype(
            np.float32)
    return jax.tree.map(np.asarray, params), state


def test_conv_frontend_train_matches_jax(model):
    params, state = model
    X = np.random.RandomState(4).randn(3, 40, 13).astype(np.float32)
    cfg = _mcfg()["cnn_config"]
    ref, ref_state = jax_conv_frontend(params["cnn"], state["cnn_bn"], cfg,
                                       jnp.asarray(X), True)
    tp, ts = from_jax_numpy(params, state)
    got, got_state = conv_frontend(tp["cnn"], ts["cnn_bn"], cfg, _t(X),
                                   train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    for r, g in zip(ref_state, got_state):
        for k in r:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(r[k]),
                                       rtol=0, atol=ATOL)


def _enc_inputs(T=6, L=3, D2=2, B=3, H=8):
    rng = np.random.RandomState(0)
    return (rng.randn(T, D2, B, 4 * H).astype(np.float32),
            (rng.randn(L - 1, D2, H, 4 * H) * 0.3).astype(np.float32),
            (rng.randn(L, D2, H, 4 * H) * 0.3).astype(np.float32),
            (rng.randn(L, D2, 4 * H) * 0.1).astype(np.float32))


ENC_SEED = 2 ** 31 - 5      # seed + t*L + l passes 2**31
# (row_offset, global_rows) of the training kernels' calls: a whole batch,
# and the 3 rows at 5 .. 7 of an 11-row batch (a data-parallel shard's)
ROW_CASES = ((0, None), (5, 11))


def test_k1_train_reference_matches_interpret_kernel():
    args = _enc_inputs()
    for off, rows in ROW_CASES:
        ref = jax_fl._forward(*(jnp.asarray(a) for a in args), ENC_SEED,
                              True, 0.3, True, off, rows)
        got = fused_lstm.fused_stacked_lstm_train(
            *(_t(a) for a in args), ENC_SEED, 0.3, off, rows)
        for name, r, g in zip(("outs", "h_fin", "c_fin", "acts", "c_all",
                               "h_pre", "x_drop"), ref, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                       atol=ATOL, err_msg=f"{name} {off}")
        x_drop = got[-1].numpy()
        np.testing.assert_array_equal(x_drop == 0, np.asarray(ref[-1]) == 0)
        assert 0.1 < (x_drop == 0).mean() < 0.5
    # the shard's masks are the global batch's rows, not its own
    shard = fused_lstm.fused_stacked_lstm_train(
        *(_t(a) for a in args), ENC_SEED, 0.3, 5, 11)[-1]
    whole = fused_lstm.fused_stacked_lstm_train(
        *(_t(a) for a in args), ENC_SEED, 0.3)[-1]
    assert not torch.equal(shard == 0, whole == 0)
    _counters_zero()


@pytest.mark.parametrize("train", [True, False])
def test_k2_grads_match_jax(train):
    args = _enc_inputs()
    rng = np.random.RandomState(1)
    T, D2, B, H4 = args[0].shape
    L = args[2].shape[0]
    cot = (rng.randn(T, D2, B, H4 // 4).astype(np.float32),
           rng.randn(L, D2, B, H4 // 4).astype(np.float32),
           rng.randn(L, D2, B, H4 // 4).astype(np.float32))
    for off, rows in ROW_CASES:
        def f(x0, wx, wh, b):
            return jax_fl.fused_stacked_lstm(x0, wx, wh, b, ENC_SEED, train,
                                             0.3, True, off, rows)

        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in args))
        ref = vjp(tuple(jnp.asarray(c) for c in cot))

        ins = [_t(a).requires_grad_(True) for a in args]
        out = fused_lstm.FusedStackedLSTM.apply(*ins, ENC_SEED, train, 0.3,
                                                torch.float32, off, rows)
        got = torch.autograd.grad(out, ins, [_t(c) for c in cot])
        for name, r, g in zip(("dx0", "dwx", "dwh", "db"), ref, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **ENC_GRAD,
                                       err_msg=f"{name} {off}")
        # the hand-derived backward against plain autograd of the forward
        plain = fused_lstm.stacked_lstm_reference(
            *ins, True, ENC_SEED, 0.3 if train else 0.0, row_offset=off,
            global_rows=rows)[:3]
        auto = torch.autograd.grad(plain, ins, [_t(c) for c in cot])
        for name, a, g in zip(("dx0", "dwx", "dwh", "db"), auto, got):
            np.testing.assert_allclose(g.numpy(), a.numpy(), **ENC_GRAD,
                                       err_msg=f"{name} {off}")
    _counters_zero()


# ---------------------------------------------------------------------------
# 5-6. K3 and K4
# ---------------------------------------------------------------------------

DEC_SEED = 2 ** 31 - 40


@pytest.fixture(scope="module")
def dec_inputs():
    rng = np.random.RandomState(2)
    B, T, H, L, E, A, U = 3, 5, 8, 2, 4, 8, 7

    def r(*shape, s=0.4):
        return (rng.randn(*shape) * s).astype(np.float32)

    w = {"wx0": r(E + A, 4 * H), "wx_rest": r(L - 1, H, 4 * H),
         "wh": r(L, H, 4 * H), "b": r(L, 4 * H, s=0.1), "wa": r(H, H),
         "wa_b": r(H, s=0.1), "ctx_w": r(2 * H, A), "ctx_b": r(A, s=0.1),
         "out_w": r(A, V, s=1.0), "out_b": r(V, s=0.1),
         "embed": r(V, E, s=1.0)}
    enc, h0, c0 = r(B, T, H, s=1.0), r(L, B, H), r(L, B, H)
    y_in = rng.randint(4, V, (U, B)).astype(np.int32)
    # teach ratio 0.5, first step forced
    coins = (rng.rand(U) < 0.5).astype(np.int32)
    coins[0] = 1
    coins[2] = coins[3] = 0
    return enc, h0, c0, w, y_in, coins


def test_k3_reference_matches_interpret_kernel(dec_inputs):
    enc, h0, c0, w, y_in, coins = dec_inputs
    y_oh = jax.nn.one_hot(y_in, V, dtype=jnp.float32)
    tw = {k: _t(v) for k, v in w.items()}
    drops = {}
    for off, _ in ROW_CASES:
        ht_r, res_r = jax_fd.decoder_forward(
            jnp.asarray(enc), jnp.asarray(h0), jnp.asarray(c0),
            {k: jnp.asarray(v) for k, v in w.items()}, y_oh,
            jnp.asarray(coins), DEC_SEED, 0.3, 0.3, True, interpret=True,
            row_offset=off)
        ht, res = fused_decoder.decoder_forward(
            _t(enc), _t(h0), _t(c0), tw, _t(y_in), _t(coins), DEC_SEED, 0.3,
            0.3, off)
        np.testing.assert_allclose(ht.numpy(), np.asarray(ht_r), rtol=0,
                                   atol=ATOL)
        for k in ("acts", "c_all", "h_all", "alphas", "q", "cv", "emb"):
            np.testing.assert_allclose(res[k].numpy(), np.asarray(res_r[k]),
                                       rtol=0, atol=ATOL,
                                       err_msg=f"{k} {off}")
        # the masks exactly: the dropped embedding and layer outputs
        np.testing.assert_array_equal(res["emb"].numpy() == 0,
                                      np.asarray(res_r["emb"]) == 0)
        U, L, B, H = res["x_drop"].shape
        keep = np.stack([np.asarray(jax_fd._regen_masks(
            U, (B, H), 0.3, DEC_SEED, 2 * l + 1, 2 * L, off))
            for l in range(L)], axis=1)
        np.testing.assert_array_equal(res["x_drop"].numpy() == 0, ~keep)
        drops[off] = res["x_drop"] == 0
        sel_ref = np.asarray(res_r["sel"]).argmax(-1)
        np.testing.assert_array_equal(res["sel"].numpy(), sel_ref)
        # the sampled steps fed something other than the teacher's ids
        assert (sel_ref[coins == 0] != y_in[coins == 0]).any()
    assert not torch.equal(*drops.values())
    _counters_zero()


def test_k4_grads_match_jax(dec_inputs):
    enc, h0, c0, w, y_in, coins = dec_inputs
    names = fused_decoder.W_NAMES
    U, B = y_in.shape
    d_ht = np.random.RandomState(5).randn(U, B, w["ctx_w"].shape[1]).astype(
        np.float32)
    y_oh = jax.nn.one_hot(y_in, V, dtype=jnp.float32)

    for off, _ in ROW_CASES:
        def f(*a):
            return jax_fd.fused_decoder_apply(*a, y_oh, jnp.asarray(coins),
                                              DEC_SEED, 0.3, 0.3, True, True,
                                              off)

        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in
                              [enc, h0, c0] + [w[k] for k in names]))
        ref = vjp(jnp.asarray(d_ht))

        ins = [_t(a).requires_grad_(True) for a in
               [enc, h0, c0] + [w[k] for k in names]]
        ht, sel = fused_decoder.FusedDecoder.apply(
            *ins, _t(y_in), _t(coins), DEC_SEED, 0.3, 0.3, off)
        got = torch.autograd.grad(ht, ins, _t(d_ht), allow_unused=True)
        labels = ("enc", "h0", "c0") + names
        for name, r, g, x in zip(labels, ref, got, ins):
            g = torch.zeros_like(x) if g is None else g
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **DEC_GRAD,
                                       err_msg=f"{name} {off}")
        # the hand-derived backward against plain autograd along the same
        # inputs (the argmax feed itself takes no gradient)
        tw = dict(zip(names, ins[3:]))
        ht_p, _ = fused_decoder.decoder_forward_reference(
            *ins[:3], tw, _t(y_in), _t(coins), DEC_SEED, 0.3, 0.3,
            forced_ids=sel, row_offset=off)
        auto = torch.autograd.grad(ht_p, ins, _t(d_ht), allow_unused=True)
        for name, a, g, x in zip(labels, auto, got, ins):
            a = torch.zeros_like(x) if a is None else a
            g = torch.zeros_like(x) if g is None else g
            np.testing.assert_allclose(g.numpy(), a.numpy(), **DEC_GRAD,
                                       err_msg=f"{name} {off}")
    _counters_zero()


# ---------------------------------------------------------------------------
# 7. the model step
# ---------------------------------------------------------------------------

def _jax_draws(key, X_shape, steps, teach_ratio, add_noise):
    """The port's Draws from JAX's key, repeating forward_loss's splits."""
    key, ekey = jax.random.split(key)                 # forward_loss
    enc_key, nkey = jax.random.split(ekey)            # encode
    noise = np.asarray(add_noise * jax.random.normal(nkey, X_shape))
    enc_seed = int(jax.random.randint(enc_key, (), 0, 2 ** 31 - 1,
                                      jnp.int32))
    k_coin, k_seed, _, _ = jax.random.split(key, 4)   # _fused_decoder_loss
    idx = jnp.arange(steps)
    coins = ((idx == 0) | (idx >= steps - 1)
             | jax.random.bernoulli(k_coin, teach_ratio, (steps,)))
    dec_seed = int(jax.random.randint(k_seed, (), 0, 2 ** 31 - 1,
                                      jnp.int32))
    return seq2seq.Draws(_t(noise), enc_seed, dec_seed,
                         _t(np.asarray(coins, np.int32)))


def test_forward_loss_matches_jax(model):
    params, state = model
    mcfg = _mcfg()
    rng = np.random.RandomState(4)
    B, T, U = 3, 40, 7
    X = rng.randn(B, T, 13).astype(np.float32)
    y = rng.randint(4, V, (B, U)).astype(np.int32)
    y[:, 0] = 1
    y[0, 5], y[0, 6] = 2, 0
    y[1, 6] = 2
    y[2, 3], y[2, 4:] = 2, 0
    key, n_real, teach, noise = jax.random.PRNGKey(1), 3.0, 0.8, 0.1

    def loss_fn(p):
        return jax_seq2seq.forward_loss(
            p, state, mcfg, jnp.asarray(X), jnp.asarray(y), key, train=True,
            n_real=n_real, teach_ratio=teach, add_noise=noise)

    (ref_loss, ref_state), ref_g = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    draws = _jax_draws(key, X.shape, U - 1, teach, noise)
    assert (draws.coins == 0).any()          # scheduled sampling ran

    tp, ts = from_jax_numpy(params, state)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, new_state = seq2seq.forward_loss(tp, ts, mcfg, _t(X),
                                           _t(y).long(), n_real, draws)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    it = iter(grads)
    got = flatten(tree_map(lambda _: next(it).numpy(), tp))
    want = jax_ckpt._flatten(jax.tree.map(np.asarray, ref_g))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **DEC_GRAD, err_msg=k)
    got_s = flatten(to_numpy(new_state))
    want_s = jax_ckpt._flatten(jax.tree.map(np.asarray, ref_state))
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    _counters_zero()


# ---------------------------------------------------------------------------
# 8. optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt_cfg", [
    {"type": 0, "lr": 1e-3, "l2": 1e-4, "grad_clip": 2},          # es_en_20h
    {"type": 0, "lr": 1e-3, "l2": 1e-4, "grad_clip": 2, "freeze": ["cnn"]},
    {"type": 1, "lr": 0.1, "l2": 1e-4, "grad_clip": 2},           # SGD
], ids=["amsgrad", "freeze", "sgd"])
def test_optimizer_matches_optax(opt_cfg):
    rng = np.random.RandomState(0)
    params = {"cnn": [{"w": rng.randn(4, 1, 3, 2).astype(np.float32)}],
              "dec": {"embed": rng.randn(5, 3).astype(np.float32),
                      "lstm": [{"b": rng.randn(8).astype(np.float32)}]}}
    tx, jstate = jax_build_optimizer(opt_cfg, jax.tree.map(jnp.asarray,
                                                           params))
    tp, _ = from_jax_numpy(params, {})
    opt, state = build_optimizer(opt_cfg, tp)
    jparams = jax.tree.map(jnp.asarray, params)
    # gradient norms around the clip norm 2: above, below, above, ...
    for step, scale in enumerate((3.0, 0.05, 1.0, 0.2, 5.0)):
        g = jax.tree.map(
            lambda a: (rng.randn(*a.shape) * scale).astype(np.float32),
            params)
        ju, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate,
                               jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, ju)
        tg, _ = from_jax_numpy(g, {})
        u, state = opt.update(tg, state, tp)
        for p, d in zip(tree_leaves(tp), tree_leaves(u)):
            p.add_(d)
        want = jax_ckpt._flatten({"u": jax.tree.map(np.asarray, ju),
                                  "opt": jax.tree.map(np.asarray, jstate)})
        got = flatten({"u": to_numpy(u), "opt": to_numpy(state)})
        assert sorted(got) == sorted(want), step
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=f"step {step} {k}")


# ---------------------------------------------------------------------------
# 9. data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,curriculum", [
    ("fisher", False), ("fisher", True), ("globalphone", False)])
def test_dataloader_matches_ast_tpu(tmp_path, kind, curriculum):
    import pickle

    from ast_tpu.data import dataloader as jax_dl
    from ast_tpu_torch.data import dataloader as port_dl
    exp = make_tiny_experiment(str(tmp_path), n_train=21, n_dev=7,
                               batch_size=16)
    tcfg = Config(exp).train
    if kind == "globalphone":
        speech = tcfg["data"]["speech_path"]
        feats = {k: {f[:-4]: np.load(os.path.join(speech, k, f))
                     for f in os.listdir(os.path.join(speech, k))}
                 for k in ("tiny_train", "tiny_dev")}
        path = str(tmp_path / "speech.pickle")
        with open(path, "wb") as f:
            pickle.dump(feats, f)
        tcfg["data"].update(dataloader="globalphone", speech_path=path)
    ref = jax_dl.make_dataloader(tcfg, exp)
    got = port_dl.make_dataloader(tcfg, exp)
    assert type(got).__name__ == type(ref).__name__
    runs = [("tiny_train", True, 1), ("tiny_train", True, 2),
            ("tiny_dev", False, None)]
    for set_key, train, epoch in runs:
        kw = dict(train=train, labels=True, epoch=epoch, tail_shrink=8,
                  curriculum=curriculum)
        a = list(ref.get_batch(16, set_key, **kw))
        b = list(got.get_batch(16, set_key, **kw))
        assert len(a) == len(b) > 1
        for x, z in zip(a, b):
            for k in ("X", "y", "utts", "n_real", "bucket", "frame_len",
                      "rows"):
                np.testing.assert_array_equal(np.asarray(z[k]),
                                              np.asarray(x[k]), err_msg=k)
    assert any(len(x["utts"]) < x["rows"] < 16 for x in a)  # a shrunk tail
    preds = [(u, [1, 5, 6, 2, 7]) for u in a[0]["utts"]]
    assert got.get_hyps(preds) == ref.get_hyps(preds)


def test_make_draws():
    X = torch.zeros((2, 5, 13))
    a = seq2seq.make_draws(9, X, 6, 0.5, 0.25)
    b = seq2seq.make_draws(9, X, 6, 0.5, 0.25)
    assert torch.equal(a.noise, b.noise) and torch.equal(a.coins, b.coins)
    assert (a.enc_seed, a.dec_seed) == (b.enc_seed, b.dec_seed)
    assert 0 <= min(a.enc_seed, a.dec_seed) < 2 ** 31 - 1
    assert a.coins.dtype == torch.int32 and a.coins[0] == a.coins[-1] == 1
    assert 0.2 < float(a.noise.std()) < 0.3
    c = seq2seq.make_draws(9, X, 6, 1.0, 0.0)
    assert c.noise is None and bool((c.coins == 1).all())
    assert not torch.equal(seq2seq.make_draws(10, X, 6, 0.5, 0.25).noise,
                           a.noise)


# ---------------------------------------------------------------------------
# 10-11. the entry point
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from ast_tpu_torch.cli import train
    exp = make_tiny_experiment(str(tmp_path_factory.mktemp("torch_train")))
    train.main(["-m", exp, "-e", "2", "--device", "cpu"])
    return exp


def _rows(path):
    with open(path) as f:
        return [line.split(", ") for line in f.read().splitlines()]


def test_train_cli_logs_and_checkpoint(trained):
    rows = _rows(os.path.join(trained, "train.log"))
    assert [r[0] for r in rows] == ["1", "2"]
    assert float(rows[1][1]) < float(rows[0][1])
    assert [r[0] for r in _rows(os.path.join(trained, "dev.log"))] == [
        "1", "2"]
    assert os.path.exists(os.path.join(trained, "seq2seq_2.model.npz"))
    _counters_zero()


def test_ast_tpu_resumes_port_checkpoint(trained, capsys):
    from ast_tpu.train.trainer import NN as JaxNN
    from ast_tpu_torch.train.trainer import NN
    ref = JaxNN(trained)
    assert ref.max_epoch == 2
    assert "optimizer state not restored" not in capsys.readouterr().out
    port = NN(trained, "cpu")
    want = jax_ckpt._flatten({"p": jax.tree.map(np.asarray, ref.params),
                              "o": jax.tree.map(np.asarray, ref.opt_state)})
    got = flatten({"p": to_numpy(port.params), "o": to_numpy(port.opt_state)})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["o/2/0"]) > 0             # AMSGrad's step count


def test_infer_clis_agree_on_trained_checkpoint(trained):
    from ast_tpu.cli import infer as jax_infer
    from ast_tpu_torch.cli import infer
    speech = os.path.join(os.path.dirname(trained), "speech", "tiny_dev")
    paths = [os.path.join(speech, f) for f in sorted(os.listdir(speech))]
    ref = jax_infer.main(["-m", trained] + paths)
    assert infer.main(["-m", trained, "--device", "cpu"] + paths) == ref


def test_train_cli_resumes(trained):
    from ast_tpu_torch.cli import train
    train.main(["-m", trained, "-e", "1", "--device", "cpu"])
    assert [r[0] for r in _rows(os.path.join(trained, "train.log"))] == [
        "1", "2", "3"]
    assert os.path.exists(os.path.join(trained, "seq2seq_3.model.npz"))


def test_train_cli_cuda_requires_a_gpu(trained):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ast_tpu_torch.cli import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["-m", trained, "-e", "1", "--device", "cuda"])


def test_train_gate_refuses_unported_options(tmp_path):
    from ast_tpu_torch.ops.fused_infer import require_train_variant
    exp = make_tiny_experiment(str(tmp_path))
    cfg = Config(exp)
    require_train_variant(cfg.train)
    # the options ported since are taken as they come
    cfg.train["extras"].update(label_smoothing=0.1, random_out=0.1,
                               weight_noise_iter=2)
    cfg.train["optimizer"].update(grad_noise_eta=0.01,
                                  moments_dtype="bfloat16")
    cfg.train["data"]["spec_augment"] = {"freq_masks": 1}
    require_train_variant(cfg.train)
    # output dropout trains on the scan decoder now, and the feed
    # options are taken too; hbm_cache keeps ast_tpu's refusals of audio
    # and text
    cfg.model["dropout"]["out"] = 0.2
    require_train_variant(cfg.train)
    cfg.train["extras"].update(steps_per_dispatch=4, hbm_cache=True,
                               transfer_dtype="bfloat16", remat=True)
    require_train_variant(cfg.train)
    for data, match in (({"features": "wav"}, "needs precomputed features"),
                        ({"enc_key": "src"}, "text-encoder mode")):
        bad = copy.deepcopy(cfg.train)
        bad["data"].update(data)
        with pytest.raises(ValueError, match=match):
            require_train_variant(bad)
