"""ast_tpu_torch's bfloat16 training (``extras.compute_dtype:
"bfloat16"``; plain versions on the CPU) against ast_tpu's bf16 pieces.

On XLA:CPU ``ast_tpu``'s ``forward_loss`` cannot run at bf16 (its
hoisted layer-0 einsum of two bf16 operands into f32 is not implemented
there), so the reference step is composed from the pieces that do run,
with ``forward_loss``'s key splits: ``conv_frontend(train=True, bf16)``;
the layer-0 projection as an f32 einsum of bf16 round trips (whose VJP
rounds the cotangents, as the TPU's transpose of a bf16 product does);
``fused_stacked_lstm`` with bf16 ``wx`` / ``wh`` in train mode
(interpret); the encoder states cast to bf16 into ``fused_decoder_apply``
over ``pack_decoder_weights(params, bf16)`` (interpret); the logits as
an f32 product of the rounded ``ht`` and ``out_w`` plus ``out_b``, and
the cross-entropy.  The same numpy inputs and parameters go through both
packages.

Tolerances: both packages round the same values to bf16 at the same
points and accumulate in f32, so only the f32 summation order differs:
forward values and streams within 1e-5 absolute (as the bf16 decode's
states, tests/test_torch_bf16.py), every gradient within 1e-4 of its
leaf's largest reference value, the loss within 1e-5 relative and the
BN state within 1e-6.  Dropping any one rounding point of ast_tpu's
bf16 training moves some gradient by more than that
(``test_each_rounding_point_matters``).
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ast_tpu.models import seq2seq as jax_seq2seq
from ast_tpu.ops import attention as jax_attention
from ast_tpu.ops import fused_decoder as jax_fd
from ast_tpu.ops import fused_lstm as jax_fl
from ast_tpu.ops.cnn import conv_frontend as jax_conv_frontend
from ast_tpu.ops.fused_decoder import round_up
from ast_tpu.symbols import SYMBOLS
from ast_tpu.train import checkpoint as jax_ckpt
from ast_tpu.train.trainer import NN as JaxNN
from ast_tpu_torch.checkpoint import flatten
from ast_tpu_torch.cli import train as train_cli
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.ops import fused_decoder, fused_lstm
from ast_tpu_torch.ops.bf16 import rounded
from ast_tpu_torch.params import from_jax_numpy, tree_map
from ast_tpu_torch.train.optimizer import tree_leaves
from ast_tpu_torch.train.trainer import NN, to_numpy
from tests.conftest import TINY_MODEL_CFG, make_tiny_experiment
from tests.test_torch_bf16_scan import _ExactBf16, torch_threads

BF = torch.bfloat16
JBF = jnp.bfloat16
ATOL = 1e-5
GRAD_TOL = 1e-4         # of max|reference| a leaf
V = 12
DROP = 0.3
ENC_SEED = 2 ** 31 - 5
DEC_SEED = 2 ** 31 - 40


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _mcfg(drop=DROP):
    m = copy.deepcopy(TINY_MODEL_CFG)
    m["rnn_config"] = dict(m["rnn_config"], dec_vocab_size=V,
                           fused_encoder=True, fused_decoder=True,
                           fused_interpret=True)
    m["dropout"] = {"embed": drop, "rnn": drop, "out": 0}
    return m


def _rel(got, want):
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _close(got, want, name, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol, err_msg=name)


def _jit_vjp(f, primals, cot):
    """The cotangents of ``f``'s inputs, compiled once (interpret-mode
    Pallas runs several times faster under jit than op by op)."""
    return jax.jit(lambda p, c: jax.vjp(f, *p)[1](c))(primals, cot)


def _counters_zero():
    for fn in (fused_lstm.fused_stacked_lstm_train,
               fused_lstm.encoder_backward, fused_decoder.decoder_forward,
               fused_decoder.decoder_backward):
        assert fn.launches == fn.launches_bf16 == 0, fn.__name__


# ---------------------------------------------------------------------------
# 1-2. K1 train and K2 at bf16
# ---------------------------------------------------------------------------

def _enc_inputs(T=6, L=3, D2=2, B=3, H=8):
    rng = np.random.RandomState(0)
    return (rng.randn(T, D2, B, 4 * H).astype(np.float32),
            (rng.randn(L - 1, D2, H, 4 * H) * 0.3).astype(np.float32),
            (rng.randn(L, D2, H, 4 * H) * 0.3).astype(np.float32),
            (rng.randn(L, D2, 4 * H) * 0.1).astype(np.float32))


def test_k1_train_bf16_reference_matches_interpret_kernel():
    x0, wx, wh, b = _enc_inputs()
    ref = jax_fl._forward(jnp.asarray(x0), jnp.asarray(wx).astype(JBF),
                          jnp.asarray(wh).astype(JBF), jnp.asarray(b),
                          ENC_SEED, True, DROP, True)
    got = fused_lstm.fused_stacked_lstm_train(
        _t(x0), _t(wx).to(BF), _t(wh).to(BF), _t(b), ENC_SEED, DROP)
    names = ("outs", "h_fin", "c_fin", "acts", "c_all", "h_pre", "x_drop")
    for name, r, g in zip(names, ref, got):
        want = torch.float32 if name in names[:3] else BF
        assert g.dtype == want, name
        _close(_np(g), np.asarray(r, np.float32), name)
    assert (got[-1] == 0).float().mean() > 0.1          # dropout ran
    _counters_zero()


@pytest.mark.parametrize("train", [True, False])
def test_k2_bf16_grads_match_jax(train):
    """The f32 weights cast to bf16 inside: their gradients come back f32
    (ast_tpu's custom VJP does not round them)."""
    args = _enc_inputs()
    rng = np.random.RandomState(1)
    T, D2, B, H4 = args[0].shape
    L = args[2].shape[0]
    cot = [rng.randn(*s).astype(np.float32)
           for s in ((T, D2, B, H4 // 4), (L, D2, B, H4 // 4),
                     (L, D2, B, H4 // 4))]

    def f(x0, wx, wh, b):
        return jax_fl.fused_stacked_lstm(x0, wx.astype(JBF), wh.astype(JBF),
                                         b, ENC_SEED, train, DROP, True)

    ref = _jit_vjp(f, [jnp.asarray(a) for a in args],
                   tuple(jnp.asarray(c) for c in cot))
    ins = [_t(a).requires_grad_(True) for a in args]
    out = fused_lstm.FusedStackedLSTM.apply(*ins, ENC_SEED, train, DROP, BF)
    got = torch.autograd.grad(out, ins, [_t(c) for c in cot])
    for name, r, g in zip(("dx0", "dwx", "dwh", "db"), ref, got):
        assert g.dtype == torch.float32
        assert _rel(_np(g), r) <= GRAD_TOL, (name, _rel(_np(g), r))
    _counters_zero()


def test_encoder_function_keeps_float64():
    """Widening the bf16 streams leaves other dtypes alone: the
    Function's gradients in float64 (the dtype chip_smoke.py's variant
    steps check in) equal autograd through the plain float64 forward."""
    args = [_t(a).double().requires_grad_(True) for a in _enc_inputs()]
    out = fused_lstm.FusedStackedLSTM.apply(*args, ENC_SEED, True, DROP)
    cot = [torch.ones_like(o) for o in out]
    got = torch.autograd.grad(out, args, cot)
    plain = fused_lstm.stacked_lstm_reference(*args, True, ENC_SEED,
                                              DROP)[:3]
    want = torch.autograd.grad(plain, args, cot)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_k2_reference_forced_with_its_own_dz_repeats_it():
    """``forced_dz`` (chip_smoke's one-step check of K2): carries that read
    the pass's own dz give that dz again, and another dz moves all but
    the first cell the reverse pass reaches (the top layer's last step)."""
    x0, wx, wh, b = _enc_inputs()
    out = fused_lstm.fused_stacked_lstm_train(
        _t(x0), _t(wx).to(BF), _t(wh).to(BF), _t(b), ENC_SEED, DROP)
    cot = [torch.ones_like(t) for t in out[:3]]
    bwd = (out[3], out[4], _t(wx).to(BF), _t(wh).to(BF), *cot, ENC_SEED,
           DROP)
    dz = fused_lstm.encoder_backward_reference(*bwd)
    assert torch.equal(
        fused_lstm.encoder_backward_reference(*bwd, forced_dz=dz), dz)
    moved = fused_lstm.encoder_backward_reference(*bwd, forced_dz=dz * 2)
    assert torch.equal(moved[-1, -1], dz[-1, -1])
    assert not torch.equal(moved, dz)
    _counters_zero()


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_chip_smoke_one_step_checks_and_controls(part, monkeypatch):
    """chip_smoke's phase-14 checks on CPU tensors, where each wrapper runs
    its plain version: the one-step recomputation from the streams gives
    the plain versions' values exactly, and each control (one rounding
    point dropped) fails it."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "REPEATS", 1)
    rng = np.random.RandomState(3)

    def r(*shape, s=0.3):
        return _t((rng.randn(*shape) * s).astype(np.float32))

    if part == "encoder":
        T, L, D2, B, H = 12, 3, 2, 4, 32
        e1, e2, _, ctl = chip_smoke.check_bf16_encoder_train(
            r(T, D2, B, 4 * H, s=1.0), r(L - 1, D2, H, 4 * H, s=0.1).to(BF),
            r(L, D2, H, 4 * H, s=0.1).to(BF), r(L, D2, 4 * H, s=0.1), "cpu",
            controls=True)
        errs = (e1, e2)
    else:
        B, T, H, L, E, A, U, Vd = 4, 10, 32, 2, 16, 32, 9, 40
        w = {"wx0": r(E + A, 4 * H), "wx_rest": r(L - 1, H, 4 * H),
             "wh": r(L, H, 4 * H), "b": r(L, 4 * H, s=0.1), "wa": r(H, H),
             "wa_b": r(H, s=0.1), "ctx_w": r(2 * H, A), "ctx_b": r(A, s=0.1),
             "out_w": r(A, Vd, s=1.0), "out_b": r(Vd, s=0.1),
             "embed": r(Vd, E, s=1.0)}
        coins = torch.ones(U, dtype=torch.int32)
        coins[3] = coins[5] = 0
        e3, _, e4, _, _, ctl = chip_smoke.check_bf16_decoder_train(
            r(B, T, H, s=1.0).to(BF), r(L, B, H), r(L, B, H),
            {k: v.to(BF) for k, v in w.items()},
            _t(rng.randint(4, Vd, (U, B)).astype(np.int32)), coins, 77,
            r(U, B, A), "cpu", controls=True)
        errs = (e3, e4)
    assert all(e == (0.0,) * 4 for e in errs), errs
    assert all(not chip_smoke.step_ok(c[2:]) for c in ctl), ctl
    _counters_zero()


# ---------------------------------------------------------------------------
# 3-4. K3 and K4 at bf16
# ---------------------------------------------------------------------------

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
    coins = (rng.rand(U) < 0.5).astype(np.int32)
    coins[0] = 1
    coins[2] = coins[3] = 0
    return enc, h0, c0, w, y_in, coins


def test_k3_bf16_reference_matches_interpret_kernel(dec_inputs):
    enc, h0, c0, w, y_in, coins = dec_inputs
    ht_r, res_r = jax_fd.decoder_forward(
        jnp.asarray(enc).astype(JBF), jnp.asarray(h0), jnp.asarray(c0),
        {k: jnp.asarray(v).astype(JBF) for k, v in w.items()},
        jax.nn.one_hot(y_in, V, dtype=JBF), jnp.asarray(coins), DEC_SEED,
        DROP, DROP, True, interpret=True)
    ht, res = fused_decoder.decoder_forward(
        _t(enc).to(BF), _t(h0), _t(c0), {k: _t(v).to(BF) for k, v in
                                         w.items()},
        _t(y_in), _t(coins), DEC_SEED, DROP, DROP)
    assert ht.dtype == torch.float32
    _close(_np(ht), np.asarray(ht_r), "ht")
    assert tuple(res) == fused_decoder.RES_NAMES_BF16
    for k in fused_decoder.RES_NAMES_BF16[1:]:
        assert res[k].dtype == BF, k
        _close(_np(res[k]), np.asarray(res_r[k], np.float32), k)
    sel_ref = np.asarray(res_r["sel"], np.float32).argmax(-1)
    np.testing.assert_array_equal(res["sel"].numpy(), sel_ref)
    assert (sel_ref[coins == 0] != y_in[coins == 0]).any()
    _counters_zero()


def _jax_dec_grads(enc, h0, c0, w, y_in, coins, d_ht):
    """ast_tpu's gradients at f32 parameters cast to bf16 outside the
    custom VJP, as forward_loss casts them."""
    names = fused_decoder.W_NAMES

    def f(e, h, c, *ws):
        return jax_fd.fused_decoder_apply(
            e.astype(JBF), h, c, *(x.astype(JBF) for x in ws),
            jax.nn.one_hot(y_in, V, dtype=JBF), jnp.asarray(coins),
            DEC_SEED, DROP, DROP, True, True)

    return _jit_vjp(f, [jnp.asarray(a) for a in
                        [enc, h0, c0] + [w[k] for k in names]],
                    jnp.asarray(d_ht))


def _port_dec_grads(enc, h0, c0, w, y_in, coins, d_ht):
    names = fused_decoder.W_NAMES
    ins = [_t(a).requires_grad_(True) for a in
           [enc, h0, c0] + [w[k] for k in names]]
    ht, _ = fused_decoder.FusedDecoder.apply(
        ins[0].to(BF), *ins[1:3], *(x.to(BF) for x in ins[3:]), _t(y_in),
        _t(coins), DEC_SEED, DROP, DROP)
    got = torch.autograd.grad(ht, ins, _t(d_ht), allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(got, ins)]


def test_decoder_function_keeps_float64(dec_inputs):
    """As the encoder's: the decoder Function's gradients in float64
    equal autograd through the plain float64 forward along its ids."""
    enc, h0, c0, w, y_in, coins = dec_inputs
    names = fused_decoder.W_NAMES
    ins = [_t(a).double().requires_grad_(True) for a in
           [enc, h0, c0] + [w[k] for k in names]]
    ht, sel = fused_decoder.FusedDecoder.apply(*ins, _t(y_in), _t(coins),
                                               DEC_SEED, DROP, DROP)
    got = torch.autograd.grad(ht, ins, torch.ones_like(ht),
                              allow_unused=True)
    plain = fused_decoder.decoder_forward_reference(
        *ins[:3], dict(zip(names, ins[3:])), _t(y_in), _t(coins), DEC_SEED,
        DROP, DROP, forced_ids=sel)[0]
    want = torch.autograd.grad(plain, ins, torch.ones_like(plain),
                               allow_unused=True)
    for name, g, w_ in zip(("enc", "h0", "c0") + names, got, want):
        if w_ is None or name in ("out_w", "out_b"):
            continue
        assert g.dtype == torch.float64, name
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=1e-9,
                                   atol=1e-11, err_msg=name)


def test_k4_bf16_grads_match_jax(dec_inputs):
    enc, h0, c0, w, y_in, coins = dec_inputs
    U, B = y_in.shape
    d_ht = np.random.RandomState(5).randn(U, B, w["ctx_w"].shape[1]).astype(
        np.float32)
    ref = _jax_dec_grads(enc, h0, c0, w, y_in, coins, d_ht)
    got = _port_dec_grads(enc, h0, c0, w, y_in, coins, d_ht)
    labels = ("enc", "h0", "c0") + fused_decoder.W_NAMES
    for name, r, g in zip(labels, ref, got):
        assert g.dtype == torch.float32
        if name in ("h0", "c0"):            # f32 carries, not rounded
            assert _rel(_np(g), r) <= GRAD_TOL, (name, _rel(_np(g), r))
            continue
        # the rest reach the f32 leaves rounded to bf16, as in ast_tpu
        assert torch.equal(g, rounded(g)), name
        if name in ("out_w", "out_b"):
            assert not np.asarray(r).any() and not g.any(), name
            continue
        assert _rel(_np(g), r) <= GRAD_TOL, (name, _rel(_np(g), r))
    _counters_zero()


# ---------------------------------------------------------------------------
# 5. the whole step against the composed ast_tpu reference
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


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(4)
    B, T, U = 3, 40, 7
    X = rng.randn(B, T, 13).astype(np.float32)
    y = rng.randint(4, V, (B, U)).astype(np.int32)
    y[:, 0] = 1
    y[0, 5], y[0, 6] = 2, 0
    y[1, 6] = 2
    y[2, 3], y[2, 4:] = 2, 0
    return X, y


KEY, N_REAL, TEACH, NOISE = jax.random.PRNGKey(1), 3.0, 0.8, 0.1


def _round_trip(x):
    return x.astype(JBF).astype(jnp.float32)


def jax_loss_bf16(params, state, mcfg, X, y, key, train=True):
    """``ast_tpu``'s ``forward_loss`` at bf16, composed from the pieces
    that run on XLA:CPU (module docstring), with its key splits.
    Returns (loss, new_state)."""
    rnn = mcfg["rnn_config"]
    key, ekey = jax.random.split(key)                 # forward_loss
    enc_key, nkey = jax.random.split(ekey)            # encode
    X = jnp.asarray(X)
    if train:
        X = X * (1.0 + NOISE * jax.random.normal(nkey, X.shape))
    h_cnn, new_cnn = jax_conv_frontend(params["cnn"], state["cnn_bn"],
                                       mcfg["cnn_config"], X, train, JBF)
    seq = jnp.transpose(h_cnn, (1, 0, 2))
    xs = jnp.stack([seq, jnp.flip(seq, axis=0)], axis=1)
    layers = params["enc"]["lstm"]
    x0 = jnp.einsum("tdbi,dih->tdbh", _round_trip(xs),
                    _round_trip(layers[0]["wx"]))
    wx_rest, wh, b = jax_fl.pack_encoder_weights(layers)
    seed = jax.random.randint(enc_key, (), 0, 2 ** 31 - 1, jnp.int32)
    drop_r = float(mcfg["dropout"]["rnn"]) if train else 0.0
    outs, h_fin, c_fin = jax_fl.fused_stacked_lstm(
        x0, wx_rest.astype(JBF), wh.astype(JBF), b, seed, train, drop_r,
        True)
    enc = jnp.concatenate([outs[:, 0], jnp.flip(outs[:, 1], axis=0)],
                          axis=-1).transpose(1, 0, 2)
    h0 = jnp.concatenate([h_fin[:, 0], h_fin[:, 1]], axis=-1)
    c0 = jnp.concatenate([c_fin[:, 0], c_fin[:, 1]], axis=-1)
    # _fused_decoder_loss
    B, U = y.shape
    steps = U - 1
    k_coin, k_seed, _, _ = jax.random.split(key, 4)
    if train:
        idx = jnp.arange(steps)
        coins = ((idx == 0) | (idx >= steps - 1)
                 | jax.random.bernoulli(k_coin, TEACH, (steps,)))
    else:
        coins = jnp.ones((steps,), bool)
    yT = jnp.asarray(y).T
    Vp = round_up(rnn["dec_vocab_size"], 128)
    w = jax_seq2seq.pack_decoder_weights(params, JBF, Vp)
    dseed = jax.random.randint(k_seed, (), 0, 2 ** 31 - 1, jnp.int32)
    drop_e = float(mcfg["dropout"]["embed"]) if train else 0.0
    ht = jax_fd.fused_decoder_apply(
        enc.astype(JBF), h0, c0, *(w[k] for k in fused_decoder.W_NAMES),
        jax.nn.one_hot(yT[:steps], Vp, dtype=JBF),
        coins.astype(jnp.int32), dseed, drop_e, drop_r, train, True)
    dec = params["dec"]
    logits = jnp.einsum("uba,av->ubv", _round_trip(ht),
                        _round_trip(dec["out_w"])) + dec["out_b"]
    target = yT[1:]
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, target[..., None], axis=-1)[..., 0]
    pad_w = (target != SYMBOLS.PAD_ID).astype(jnp.float32)
    loss = jnp.sum(nll * pad_w) / N_REAL
    return loss, {"cnn_bn": new_cnn, "enc_proj_bn": state["enc_proj_bn"]}


def _jax_draws(key, X_shape, steps):
    """The port's Draws from JAX's key, repeating forward_loss's splits."""
    key, ekey = jax.random.split(key)
    enc_key, nkey = jax.random.split(ekey)
    noise = np.asarray(NOISE * jax.random.normal(nkey, X_shape))
    enc_seed = int(jax.random.randint(enc_key, (), 0, 2 ** 31 - 1,
                                      jnp.int32))
    k_coin, k_seed, _, _ = jax.random.split(key, 4)
    idx = jnp.arange(steps)
    coins = ((idx == 0) | (idx >= steps - 1)
             | jax.random.bernoulli(k_coin, TEACH, (steps,)))
    dec_seed = int(jax.random.randint(k_seed, (), 0, 2 ** 31 - 1,
                                      jnp.int32))
    return seq2seq.Draws(_t(noise), enc_seed, dec_seed,
                         _t(np.asarray(coins, np.int32)))


@pytest.fixture(scope="module")
def jax_step(model, batch):
    params, state = model
    X, y = batch

    def loss_fn(p):
        return jax_loss_bf16(p, state, _mcfg(), X, y, KEY)

    (loss, new_state), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return (float(loss), jax_ckpt._flatten(jax.tree.map(np.asarray, grads)),
            jax_ckpt._flatten(jax.tree.map(np.asarray, new_state)))


def port_step(model, batch, mcfg=None):
    """The port's bf16 train step on the CPU: (loss, flat gradients, flat
    new state)."""
    params, state = model
    X, y = batch
    tp, ts = from_jax_numpy(params, state)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    draws = _jax_draws(KEY, X.shape, y.shape[1] - 1)
    assert (draws.coins == 0).any()          # scheduled sampling ran
    loss, new_state = seq2seq.forward_loss(
        tp, ts, mcfg or _mcfg(), _t(X), _t(y).long(), N_REAL, draws,
        compute_dtype=BF)
    grads = torch.autograd.grad(loss, leaves)
    assert all(g.dtype == torch.float32 for g in grads)
    it = iter(grads)
    return (loss.item(), flatten(tree_map(lambda _: _np(next(it)), tp)),
            flatten(to_numpy(new_state)))


def _worst(got, want):
    """(relative error, leaf) of the leaf furthest from the reference."""
    return max((_rel(got[k], want[k]), k) for k in want)


def test_forward_loss_bf16_matches_composed_jax(model, batch, jax_step):
    ref_loss, ref_g, ref_s = jax_step
    loss, grads, new_state = port_step(model, batch)
    assert sorted(grads) == sorted(ref_g)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss), (loss, ref_loss)
    worst = _worst(grads, ref_g)
    assert worst[0] <= GRAD_TOL, worst
    for k in ref_s:
        np.testing.assert_allclose(new_state[k], ref_s[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    # bf16 moves the step: the f32 step's gradients differ
    params, state = model
    tp, ts = from_jax_numpy(params, state)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    X, y = batch
    f32 = seq2seq.forward_loss(tp, ts, _mcfg(), _t(X), _t(y).long(), N_REAL,
                               _jax_draws(KEY, X.shape, y.shape[1] - 1))[0]
    assert abs(f32.item() - loss) > 1e-5 * abs(loss)
    _counters_zero()


def test_eval_loss_bf16_matches_composed_jax(model, batch):
    params, state = model
    X, y = batch
    ref = float(jax.jit(lambda p: jax_loss_bf16(p, state, _mcfg(), X, y, KEY,
                                                train=False)[0])(params))
    tp, ts = from_jax_numpy(params, state)
    with torch.no_grad():
        got, same = seq2seq.forward_loss(
            tp, ts, _mcfg(), _t(X), _t(y).long(), N_REAL, train=False,
            enc_w=seq2seq.encoder_weights(tp, BF), compute_dtype=BF)
    assert same is ts
    assert abs(got.item() - ref) <= 1e-5 * abs(ref), (got.item(), ref)


# ---------------------------------------------------------------------------
# 6. each rounding point matters
# ---------------------------------------------------------------------------

class _RoundedEncoderGrads(fused_lstm.FusedStackedLSTM):
    """The encoder with its weight gradients rounded to bf16."""

    @staticmethod
    def backward(ctx, *cot):
        g = list(fused_lstm.FusedStackedLSTM.backward(ctx, *cot))
        g[1], g[2] = rounded(g[1]), rounded(g[2])
        return tuple(g)


def _decoder_casting_inside(round_weights, round_enc):
    """The decoder taking f32 ``enc`` and weights and casting them to bf16
    itself, so that its gradients reach them unrounded unless asked."""

    class Dec(torch.autograd.Function):
        @staticmethod
        def forward(ctx, enc, h0, c0, *args):
            return fused_decoder.FusedDecoder.forward(
                ctx, enc.to(BF), h0, c0, *(a.to(BF) for a in args[:11]),
                *args[11:])

        @staticmethod
        def backward(ctx, d_ht, d_sel):
            g = list(fused_decoder.FusedDecoder.backward(ctx, d_ht, d_sel))
            if round_enc:
                g[0] = rounded(g[0])
            if round_weights:
                g[3:14] = [None if x is None else rounded(x)
                           for x in g[3:14]]
            return tuple(g)

    return Dec


def _f32_decoder_weights(monkeypatch):
    pack = seq2seq.pack_decoder_weights
    monkeypatch.setattr(seq2seq, "pack_decoder_weights",
                        lambda params, dtype=None: pack(params))


def _mutate(point, monkeypatch):
    if point == "encoder_weight_grads_rounded":
        monkeypatch.setattr(seq2seq, "FusedStackedLSTM",
                            _RoundedEncoderGrads)
    elif point in ("decoder_weight_grads_f32", "d_enc_f32"):
        _f32_decoder_weights(monkeypatch)
        monkeypatch.setattr(seq2seq, "FusedDecoder", _decoder_casting_inside(
            point == "d_enc_f32", point == "decoder_weight_grads_f32"))
    elif point == "x_drop_as_fed_forward":
        regen = fused_decoder.regen_x_drop
        monkeypatch.setattr(fused_decoder, "regen_x_drop",
                            lambda h, seed, rate, *rows: rounded(
                                regen(h, seed, rate, *rows)))
    elif point == "h_fin_c_fin_rounded":
        train = fused_lstm.fused_stacked_lstm_train

        def from_streams(*args, **kw):
            out = train(*args, **kw)
            return (out[0], out[5][-1].float(), out[4][-1].float()) + out[3:]
        monkeypatch.setattr(fused_lstm, "fused_stacked_lstm_train",
                            from_streams)
    elif point == "decoder_biases_f32":
        pack = seq2seq.pack_decoder_weights

        def f32_biases(params, dtype=torch.float32):
            w, w32 = pack(params, dtype), pack(params)
            return dict(w, **{k: w32[k] for k in ("b", "wa_b", "ctx_b")})
        monkeypatch.setattr(seq2seq, "pack_decoder_weights", f32_biases)
    elif point == "logits_f32":
        loss = seq2seq.sequence_loss
        monkeypatch.setattr(
            seq2seq, "sequence_loss",
            lambda *a, compute_dtype=None, **kw: loss(*a, **kw))


@pytest.mark.parametrize("point", [
    "encoder_weight_grads_rounded", "decoder_weight_grads_f32", "d_enc_f32",
    "x_drop_as_fed_forward", "h_fin_c_fin_rounded", "decoder_biases_f32",
    "logits_f32"])
def test_each_rounding_point_matters(model, batch, jax_step, point,
                                     monkeypatch):
    """The port with one of ast_tpu's rounding points of bf16 training
    dropped (or one added) moves some gradient past GRAD_TOL of the
    reference: each point is there because it has to be."""
    _mutate(point, monkeypatch)
    _, grads, _ = port_step(model, batch)
    worst = _worst(grads, jax_step[1])
    assert worst[0] > GRAD_TOL, (point, worst)


# ---------------------------------------------------------------------------
# 7. the entry points
# ---------------------------------------------------------------------------

def _bf16_experiment(root, **edits):
    exp = make_tiny_experiment(str(root))
    path = os.path.join(exp, "train_cfg.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["extras"]["compute_dtype"] = "bfloat16"
    with open(path, "w") as f:
        json.dump(cfg, f)
    if edits:
        path = os.path.join(exp, "model_cfg.json")
        with open(path) as f:
            mcfg = json.load(f)
        for block, values in edits.items():
            mcfg[block].update(values)
        with open(path, "w") as f:
            json.dump(mcfg, f)
    return exp


def test_nn_trains_and_evaluates_at_bf16(tmp_path):
    """NN.train_epoch and NN.eval_loss at bf16 on the CPU: finite losses,
    every leaf moved and still f32, the dev loss equal to forward_loss's
    at bf16 and not to the f32 one."""
    exp = _bf16_experiment(tmp_path)
    nn = NN(exp, "cpu")
    assert nn.compute_dtype == BF
    before = [p.detach().clone() for p in tree_leaves(nn.params)]
    loss = nn.train_epoch("tiny_train", epoch=1)
    assert np.isfinite(loss) and loss > 0
    after = tree_leaves(nn.params)
    assert all(p.dtype == torch.float32 for p in after)
    assert all(not torch.equal(a, b) for a, b in zip(after, before))
    dev = nn.eval_loss("tiny_dev")
    assert np.isfinite(dev)
    nn.compute_dtype = torch.float32
    assert dev != nn.eval_loss("tiny_dev")
    _counters_zero()


def test_cli_train_bf16_writes_logs_and_a_checkpoint_ast_tpu_loads(
        tmp_path):
    exp = _bf16_experiment(tmp_path)
    train_cli.main(["-m", exp, "-e", "2", "--device", "cpu"])
    for log in ("train.log", "dev.log"):
        with open(os.path.join(exp, log)) as f:
            rows = [r for r in f.read().splitlines() if r.strip()]
        assert len(rows) == 2, (log, rows)
    snap = jax_ckpt.load_checkpoint(os.path.join(exp, "seq2seq_2.model.npz"))
    leaves = jax.tree.leaves(snap["params"])
    assert leaves and all(np.asarray(x).dtype == np.float32 for x in leaves)
    assert all(np.isfinite(np.asarray(x)).all() for x in leaves)
    _counters_zero()


@pytest.mark.parametrize("edits,name", [
    ({"rnn_config": {"rnn_relu": True}}, "rnn_relu"),
    ({"dropout": {"out": 0.3}}, "dropout.out"),
], ids=["rnn_relu", "dropout_out"])
def test_scan_variant_bf16_refused_in_training(tmp_path, edits, name,
                                               monkeypatch):
    """A model variant that trains on the scan path, once refused at bf16
    by name, now trains there: NN builds at bf16, cli.train trains an
    epoch and writes its logs, and the dev loss at bf16 is ast_tpu's
    NN's on the same checkpoint within 1e-5 relative (its einsums
    widened as tests/test_torch_bf16_scan.py runs them, its kernel flags
    set so that ``dropout.out``'s encoder is K1 in both)."""
    rnn = dict(edits.get("rnn_config", {}), fused_encoder=True,
               fused_decoder=True, fused_interpret=True)
    exp = _bf16_experiment(tmp_path, **dict(edits, rnn_config=rnn))
    with torch_threads(1):
        assert NN(exp, "cpu").compute_dtype == BF
        train_cli.main(["-m", exp, "-e", "1", "--device", "cpu"])
        for log in ("train.log", "dev.log"):
            with open(os.path.join(exp, log)) as f:
                assert len([r for r in f if r.strip()]) == 1, (name, log)
        nn = NN(exp, "cpu")
        assert nn.max_epoch == 1
        for mod in (jax_seq2seq, jax_attention):
            monkeypatch.setattr(mod, "jnp", _ExactBf16())
        ref = JaxNN(exp)
        assert ref.max_epoch == 1 and ref.compute_dtype == jnp.bfloat16
        want, got = ref.eval_loss("tiny_dev"), nn.eval_loss("tiny_dev")
    assert abs(got - want) <= 1e-5 * abs(want), (name, got, want)
