"""The model variants ast_tpu runs on its XLA scan path, in the port
(plain PyTorch on the CPU) against ast_tpu (its scan path on the CPU).

One variant a case: ``ln``, ``rnn_relu``, ``linear_proj``, a
unidirectional encoder, two attention heads, no input feeding, output
dropout, blockwise attention, a conv stack with max pooling and leaky
ReLU (im2col, and the general NCHW path with dilation), and text-encoder
input.  The same perturbed parameters (through the weight bridge) and
numpy inputs go through both packages in float32.  Tolerances, as
tests/test_torch_train.py: losses and forward floats 1e-5, gradients
rtol 2e-3 / atol 2e-4 (ast_tpu's own bound on the decoder's), BN state
1e-6; tokens, lengths and n_steps exactly; beam scores and attention
histories 1e-5.  The random draws of training differ between the
packages on the scan path, so training is compared at dropout 0, teach
ratio 1, noise 0 and random_out 0 (output dropout: with both packages'
logit dropout replaced by the identity); the port's own masks are held
to the kernel path's by the last tests.
"""

import copy
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ast_tpu.data.dataloader import FisherDataLoader as JaxFisherLoader
from ast_tpu.models import seq2seq as jax_seq2seq
from ast_tpu.ops import attention as jax_attention
from ast_tpu.ops import beam as jax_beam
from ast_tpu.ops import fused_infer as jax_fused_infer
from ast_tpu.ops import fused_lstm as jax_fused_lstm
from ast_tpu.ops.cnn import conv_frontend as jax_conv_frontend
from ast_tpu.symbols import SYMBOLS
from ast_tpu.train import checkpoint as jax_ckpt
from ast_tpu_torch.checkpoint import flatten
from ast_tpu_torch.data.dataloader import FisherDataLoader
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.ops import attention, beam as beam_ops, cnn
from ast_tpu_torch.ops import fused_decoder, fused_infer, fused_lstm
from ast_tpu_torch.ops.dropout import drop_mask
from ast_tpu_torch.params import from_flat, from_jax_numpy, to_flat, tree_map
from ast_tpu_torch.train.optimizer import tree_leaves
from ast_tpu_torch.train.trainer import to_numpy
from tests.conftest import TINY_MODEL_CFG
from tests.test_torch_bf16_scan import _ExactBf16

V, B, U, STOP, N, K = 16, 3, 9, 10, 3, 3
ATOL = 1e-5
DEC_GRAD = dict(rtol=2e-3, atol=2e-4)

# a conv stack the im2col path takes, with max pooling ("SAME", window 3
# over stride 2: uneven padding) and leaky ReLU
POOL_LAYERS = [
    {"in_channels": None, "out_channels": 8, "ksize": [3, 13],
     "stride": [1, 13], "pad": [1, 0], "max_pool": [3, 2],
     "leaky_relu": True},
    {"in_channels": None, "out_channels": 16, "ksize": [3, 1],
     "stride": [2, 1], "pad": [1, 0], "leaky_relu": True},
]
# one it does not: layer 0 keeps two feature columns, dilation 2
NCHW_LAYERS = [
    {"in_channels": None, "out_channels": 8, "ksize": [3, 5],
     "stride": [2, 4], "pad": [1, 1], "dilate": 2},
    {"in_channels": None, "out_channels": 16, "ksize": [3, 2],
     "stride": [2, 1], "pad": [1, 0], "max_pool": [2, 2],
     "leaky_relu": True},
]
TEXT_LAYERS = [
    {"in_channels": None, "out_channels": 8, "ksize": [3, 8],
     "stride": [1, 8], "pad": [1, 0]},
    {"in_channels": None, "out_channels": 16, "ksize": [3, 1],
     "stride": [2, 1], "pad": [1, 0]},
]


def _rnn(**kw):
    return lambda m: m["rnn_config"].update(kw)


def _layers(layers):
    return lambda m: m["cnn_config"].update(cnn_layers=copy.deepcopy(layers))


def _text(m):
    m["rnn_config"].update(enc_vocab_size=V, embedding_units=8)
    m["cnn_config"]["cnn_layers"] = copy.deepcopy(TEXT_LAYERS)


VARIANTS = {
    "ln": _rnn(ln=True),
    "rnn_relu": _rnn(rnn_relu=True),
    "linear_proj": _rnn(linear_proj=True),
    "uni": _rnn(bi_rnn=False),
    "n_attn2": _rnn(n_attn=2),
    "no_feed": _rnn(feed_attn=False),
    "out_drop": lambda m: m["dropout"].update(out=0.3),
    "block": _rnn(attn_block_size=4),
    "pool": _layers(POOL_LAYERS),
    "text": _text,
}
# the stages each variant sends to a kernel (seq2seq's routing; ast_tpu
# runs its Pallas kernel at the same stages)
KERNEL_STAGES = {
    "default": {"enc", "dec", "infer"},
    "ln": set(), "rnn_relu": set(), "linear_proj": {"dec", "infer"},
    "uni": {"enc", "dec", "infer"}, "n_attn2": {"enc"}, "no_feed": {"enc"},
    "out_drop": {"enc", "infer"}, "block": {"enc"},
    "pool": {"enc", "dec", "infer"}, "text": {"enc", "dec", "infer"},
}


def _mcfg(name="default"):
    m = copy.deepcopy(TINY_MODEL_CFG)
    m["rnn_config"]["dec_vocab_size"] = V
    m["dropout"] = {"embed": 0.0, "rnn": 0.0, "out": 0}
    if name != "default":
        VARIANTS[name](m)
    return m


def _perturb(tree, rng, scale):
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), tree)


def _inputs(name, rng):
    T = 24
    if name == "text":
        X = np.zeros((B, T), np.int32)
        for b in range(B):
            X[b, :10 + 3 * b] = rng.integers(4, V, 10 + 3 * b)
    else:
        X = rng.standard_normal((B, T, 13)).astype(np.float32)
    y = np.zeros((B, U), np.int32)
    for b, n in enumerate([6, 4, 7]):
        y[b, 0] = SYMBOLS.GO_ID
        y[b, 1:1 + n] = rng.integers(4, V, n)
        y[b, 1 + n] = SYMBOLS.EOS_ID
    return X, y


_CACHE = {}


def _model(name, **rnn):
    """(mcfg, numpy params, numpy state, X, y, port params, port state):
    the port's seeded init, perturbed (BN variances kept positive, an
    EOS bias that staggers the ends of greedy rows), for both packages;
    ``rnn`` edits its rnn_config (widths)."""
    key = (name,) + tuple(sorted(rnn.items()))
    if key not in _CACHE:
        mcfg = _mcfg(name)
        mcfg["rnn_config"].update(rnn)
        rng = np.random.default_rng(sorted(VARIANTS).index(name)
                                    if name in VARIANTS else 99)
        params, state = (to_numpy(t) for t in seq2seq.init_model(mcfg, 5))
        params = _perturb(params, rng, 0.2)
        params["dec"]["out_b"][SYMBOLS.EOS_ID] += 1.5
        state = _perturb(state, rng, 0.1)
        for group in ("cnn_bn", "enc_proj_bn"):
            for s in state[group]:
                s["bn_var"] = np.abs(s["bn_var"]) + 0.5
        X, y = _inputs(name, rng)
        tp, ts = from_jax_numpy(params, state)
        _CACHE[key] = (mcfg, params, state, X, y, tp, ts)
    return _CACHE[key]


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _x(X):
    return torch.from_numpy(X)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_init_model_leaves_match_jax(name):
    """The port's init_model has ast_tpu's flat-NPZ keys and shapes for
    every variant, and the bridge carries each leaf both ways."""
    mcfg, params, state, _, _, tp, ts = _model(name)
    want_p, want_s = jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(lambda k: jax_seq2seq.init_model(k, mcfg),
                       jax.random.PRNGKey(0)))
    for got, want in ((flatten(params), jax_ckpt._flatten(want_p)),
                      (flatten(state), jax_ckpt._flatten(want_s))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.shape(got[k]) == np.shape(want[k]), k
    back = flatten(to_numpy(tp))
    for k, v in flatten(params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    flat = to_flat(tp, ts)
    assert sorted(flat) == sorted(jax_ckpt._flatten(
        {"params": params, "state": state}))
    rp, rs = from_flat(flat)
    for got, want in ((rp, tp), (rs, ts)):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

class _Kernel(Exception):
    pass


class _Proj(Exception):
    pass


def _jax_encoder_runs_kernel(mcfg, X, monkeypatch):
    """Whether ast_tpu's encode calls its Pallas recurrence for this
    model (fused_encoder and interpret mode set): its conv front-end
    stubbed, its kernel and its linear_proj branch made to raise."""
    def raiser(exc):
        def fn(*args, **kw):
            raise exc
        return fn
    cnn_out = mcfg["cnn_config"]["cnn_layers"][-1]["out_channels"]
    monkeypatch.setattr(jax_seq2seq, "conv_frontend",
                        lambda p, s, cfg, x, *a: (jnp.zeros((B, 6, cnn_out)),
                                                  s))
    monkeypatch.setattr(jax_seq2seq, "_encode_proj", raiser(_Proj))
    monkeypatch.setattr(jax_fused_lstm, "fused_stacked_lstm",
                        raiser(_Kernel))
    params, state = jax.tree.map(
        lambda a: jnp.zeros(a.shape, a.dtype),
        jax.eval_shape(lambda k: jax_seq2seq.init_model(k, mcfg),
                       jax.random.PRNGKey(0)))
    try:
        jax_seq2seq.encode(params, state, mcfg, jnp.asarray(X),
                           jax.random.PRNGKey(0), False)
    except _Kernel:
        return True
    except _Proj:
        return False
    return False


@pytest.mark.parametrize("name", ["default"] + sorted(VARIANTS))
def test_routing_matches_ast_tpu(name, monkeypatch):
    """Every stage routes to its kernel exactly where ast_tpu runs its
    Pallas kernel (with fused_encoder / fused_decoder / fused_interpret
    set): the encoder condition of its encode, _use_fused_decoder,
    infer_variant_ok; an encoder mask sends both decoders to the plain
    loops in both packages."""
    mcfg = _mcfg(name)
    mcfg["rnn_config"].update(fused_encoder=True, fused_decoder=True,
                              fused_interpret=True)
    X = _model(name)[3]
    enc = np.zeros((B, 6, 16), np.float32)
    y = np.zeros((B, U), np.int32)
    want = {stage for stage, on in (
        ("enc", _jax_encoder_runs_kernel(mcfg, X, monkeypatch)),
        ("dec", jax_seq2seq._use_fused_decoder(mcfg, None, enc, y,
                                               jnp.float32, None)),
        ("infer", jax_fused_infer.infer_variant_ok(mcfg))) if on}
    # on CPU tensors, as ast_tpu in interpret mode: no shape gate
    got = {stage for stage, on in (
        ("enc", seq2seq.use_fused_encoder(mcfg, "cpu")),
        ("dec", seq2seq.use_fused_decoder(mcfg, "cpu")),
        ("infer", seq2seq.use_fused_infer(mcfg, "cpu", B, 6))) if on}
    assert got == want == KERNEL_STAGES[name]
    mask = np.ones((B, 6), bool)
    assert not seq2seq.use_fused_decoder(mcfg, "cpu", torch.from_numpy(mask))
    assert not fused_infer.infer_variant_ok(mcfg, torch.from_numpy(mask))
    assert not jax_seq2seq._use_fused_decoder(mcfg, None, enc, y,
                                              jnp.float32, mask)
    assert not jax_fused_infer.infer_variant_ok(mcfg, mask)


def test_cpu_variant_takes_no_kernel():
    """A variant on CPU tensors launches nothing: its kernel stages run
    their plain versions, its scan stages are plain anyway."""
    counters = (fused_lstm.fused_stacked_lstm,
                fused_lstm.fused_stacked_lstm_train,
                fused_lstm.encoder_backward, fused_decoder.decoder_forward,
                fused_decoder.decoder_backward,
                fused_infer.greedy_decode_fused,
                fused_infer.beam_search_streams)
    mcfg, _, _, X, _, tp, ts = _model("uni")
    seq2seq.predict_greedy(tp, ts, mcfg, _x(X), STOP)
    beam_ops.make_beam_decoder(mcfg, N, K, STOP)(tp, ts, _x(X))
    assert [f.launches for f in counters] == [0] * len(counters)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["linear_proj", "out_drop", "pool"])
def test_eval_loss_matches_jax(name):
    """The dev loss (eval mode: running statistics, every step forced;
    output dropout off), where eval differs most from a train step at
    rate 0: the BN layers' running statistics, and a scan decoder that
    output dropout alone selects."""
    mcfg, params, state, X, y, tp, ts = _model(name)
    want, _ = jax.jit(lambda p, s, x, t: jax_seq2seq.forward_loss(
        p, s, mcfg, x, t, jax.random.PRNGKey(0), train=False))(
            _jnp(params), _jnp(state), jnp.asarray(X), jnp.asarray(y))
    got, got_state = seq2seq.forward_loss(tp, ts, mcfg, _x(X),
                                          _x(y).long(), float(B),
                                          train=False)
    np.testing.assert_allclose(got.item(), float(want), rtol=ATOL)
    assert got_state is ts


def _identity_out_dropout(monkeypatch):
    """Both packages' logit dropout replaced by the identity (the only
    dropout left on at rates 0 / 0 / 0.3)."""
    monkeypatch.setattr(jax_seq2seq, "dropout",
                        lambda key, x, rate, train: x)
    monkeypatch.setattr(seq2seq, "dropout", lambda x, keep, rate: x)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_train_step_matches_jax(name, monkeypatch):
    """A train-mode step: the loss, every parameter's gradient and the
    moved BN statistics (conv and linear_proj) against ast_tpu's."""
    mcfg, params, state, X, y, _, _ = _model(name)
    if name == "out_drop":
        _identity_out_dropout(monkeypatch)

    def loss_fn(p, s, x, t):
        return jax_seq2seq.forward_loss(
            p, s, mcfg, x, t, jax.random.PRNGKey(1), train=True,
            n_real=float(B), teach_ratio=1.0)

    (want, want_state), want_g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(_jnp(params), _jnp(state), jnp.asarray(X),
                                jnp.asarray(y))
    tp, ts = from_jax_numpy(params, state)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    draws = seq2seq.Draws(None, 11, 12, torch.ones(U - 1, dtype=torch.int32))
    got, got_state = seq2seq.forward_loss(tp, ts, mcfg, _x(X), _x(y).long(),
                                          float(B), draws)
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(got.item(), float(want), rtol=ATOL)
    it = iter(grads)
    got_g = flatten(tree_map(lambda _: next(it).numpy(), tp))
    want_g = jax_ckpt._flatten(jax.tree.map(np.asarray, want_g))
    assert sorted(got_g) == sorted(want_g)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], **DEC_GRAD,
                                   err_msg=k)
    got_s = flatten(to_numpy(got_state))
    want_s = jax_ckpt._flatten(jax.tree.map(np.asarray, want_state))
    assert sorted(got_s) == sorted(want_s)
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=0, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_greedy_matches_jax(name):
    mcfg, params, state, X, _, tp, ts = _model(name)
    want, want_n = jax.jit(lambda p, s, x: jax_seq2seq.predict_greedy(
        p, s, mcfg, x, STOP))(_jnp(params), _jnp(state), jnp.asarray(X))
    got, got_n = seq2seq.predict_greedy(tp, ts, mcfg, _x(X), STOP)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got_n) == int(want_n)
    assert (got == SYMBOLS.EOS_ID).any()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_beam_and_attention_history_match_jax(name):
    """Beam hyps and lengths exactly, scores and the return_attn
    histories within 1e-5; without return_attn the same beams."""
    mcfg, params, state, X, _, tp, ts = _model(name)
    want = jax_beam.make_beam_decoder(mcfg, N, K, STOP, return_attn=True)(
        _jnp(params), _jnp(state), jnp.asarray(X))
    got = beam_ops.make_beam_decoder(mcfg, N, K, STOP, return_attn=True)(
        tp, ts, _x(X))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=0, atol=ATOL)
    plain = beam_ops.make_beam_decoder(mcfg, N, K, STOP)(tp, ts, _x(X))
    for a, b in zip(plain, got[:3]):
        assert torch.equal(a, b)


def test_attention_rows_sum_to_one():
    """Each history row past GO is a softmax over T' (sums to 1); row 0
    and the rows past a hypothesis's length are 0."""
    mcfg, _, _, X, _, tp, ts = _model("n_attn2")
    hyps, _, lengths, attn = beam_ops.make_beam_decoder(
        mcfg, N, K, STOP, return_attn=True)(tp, ts, _x(X))
    sums = attn.sum(dim=-1)
    pos = torch.arange(STOP + 1)
    inside = (pos >= 1) & (pos[None, None] < lengths[..., None])
    np.testing.assert_allclose(sums[inside].numpy(), 1.0, atol=1e-5)
    assert (sums[~inside] == 0).all()


# ---------------------------------------------------------------------------
# encoder masks and blockwise attention
# ---------------------------------------------------------------------------

def test_make_enc_mask_matches_jax():
    for layers in (TINY_MODEL_CFG["cnn_config"]["cnn_layers"], POOL_LAYERS,
                   NCHW_LAYERS):
        mcfg = {"cnn_config": {"cnn_layers": layers}}
        x_len = np.array([1, 7, 24, 40, 13], np.int32)
        want = jax_seq2seq.make_enc_mask(mcfg, jnp.asarray(x_len), 12)
        got = seq2seq.make_enc_mask(mcfg, torch.from_numpy(x_len), 12)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["default", "block"])
def test_masked_attention_matches_jax(name):
    """An encoder mask: the dev loss and greedy decoding (plain loops in
    both packages) equal ast_tpu's, dense and blockwise."""
    mcfg, params, state, X, y, tp, ts = _model(name)
    x_len = np.array([24, 13, 7], np.int32)
    mask = jax_seq2seq.make_enc_mask(mcfg, jnp.asarray(x_len), 6)
    tmask = seq2seq.make_enc_mask(mcfg, torch.from_numpy(x_len), 6)
    want, _ = jax.jit(lambda p, s, x, t, m: jax_seq2seq.forward_loss(
        p, s, mcfg, x, t, jax.random.PRNGKey(0), train=False,
        enc_mask=m))(_jnp(params), _jnp(state), jnp.asarray(X),
                     jnp.asarray(y), mask)
    got, _ = seq2seq.forward_loss(tp, ts, mcfg, _x(X), _x(y).long(),
                                  float(B), train=False, enc_mask=tmask)
    np.testing.assert_allclose(got.item(), float(want), rtol=ATOL)
    unmasked, _ = seq2seq.forward_loss(tp, ts, mcfg, _x(X), _x(y).long(),
                                       float(B), train=False)
    assert abs(unmasked.item() - got.item()) > 1e-4
    want_p, want_n = jax.jit(lambda p, s, x, m: jax_seq2seq.predict_greedy(
        p, s, mcfg, x, STOP, enc_mask=m))(_jnp(params), _jnp(state),
                                          jnp.asarray(X), mask)
    got_p, got_n = seq2seq.predict_greedy(tp, ts, mcfg, _x(X), STOP,
                                          enc_mask=tmask)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert int(got_n) == int(want_n)
    # ast_tpu's beam decoder takes no mask; the port's, at N = K = 1, is
    # the masked greedy decode
    hyps, _, lengths = beam_ops.make_beam_decoder(mcfg, 1, 1, STOP)(
        tp, ts, _x(X), enc_mask=tmask)
    for b in range(B):
        n = int(lengths[b, 0]) - 1
        np.testing.assert_array_equal(hyps[b, 0, 1:1 + n].numpy(),
                                      got_p[b, :n].numpy())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T,block", [(11, 4), (12, 4), (5, 8)])
def test_blockwise_attend_matches_dense_and_jax(T, block, masked):
    """The streaming form equals the dense softmax, and ast_tpu's
    _blockwise_attend, with and without a mask (a row masked in whole
    blocks too)."""
    rng = np.random.default_rng(T + block)
    R, H, A = 4, 8, 6
    enc = rng.standard_normal((R, T, H)).astype(np.float32)
    dec_h = rng.standard_normal((R, H)).astype(np.float32)
    wa = rng.standard_normal((H, H)).astype(np.float32) * 0.3
    ctx_w = rng.standard_normal((2 * H, A)).astype(np.float32) * 0.3
    wa_b, ctx_b = np.zeros(H, np.float32), np.zeros(A, np.float32)
    mask = None
    if masked:
        mask = np.arange(T)[None] < np.array([T, 3, 1, T - 2])[:, None]
    t = torch.from_numpy
    tmask = None if mask is None else t(mask)
    args = (t(enc), t(dec_h), [(t(wa), t(wa_b))], t(ctx_w), t(ctx_b), tmask)
    dense = attention.luong_attention(*args)
    blocked = attention.luong_attention(*args, block_size=block)
    for a, b in zip(blocked, dense):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    q = jnp.asarray(dec_h @ wa)
    cv, alphas = jax_attention._blockwise_attend(
        jnp.asarray(enc), q, None if mask is None else jnp.asarray(mask),
        block)
    got_cv, got_alphas = attention.blockwise_attend(
        t(enc), torch.from_numpy(np.array(q)), tmask, block)
    np.testing.assert_allclose(got_cv.numpy(), np.asarray(cv), atol=1e-6)
    np.testing.assert_allclose(got_alphas.numpy(), np.asarray(alphas),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# conv front-end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers,force", [(POOL_LAYERS, False),
                                          (POOL_LAYERS, True),
                                          (NCHW_LAYERS, False)],
                         ids=["im2col", "force_nchw", "nchw"])
def test_conv_frontend_variants_match_jax(layers, force):
    """max_pool "SAME" and leaky ReLU on both paths, force_nchw, and
    dilation: the output, its length conv_out_len's at odd and even T,
    in eval and train mode with the moved BN state; in train mode the
    gradient of the input too."""
    cfg = {"bn": True, "cnn_layers": layers, "force_nchw": force}
    params, state = seq2seq.init_model(dict(_mcfg(), cnn_config=cfg), 2)
    rng = np.random.default_rng(3)
    cnn_p = _perturb(to_numpy(params["cnn"]), rng, 0.1)
    cnn_s = [{"bn_mean": s["bn_mean"] + 0.1, "bn_var": s["bn_var"] + 0.3}
             for s in to_numpy(state["cnn_bn"])]
    tp, ts = from_jax_numpy(cnn_p, cnn_s)

    @jax.jit
    def jax_train(x):
        def sq(a):
            out, new_s = jax_conv_frontend(_jnp(cnn_p), _jnp(cnn_s), cfg, a,
                                           True)
            return jnp.sum(out ** 2), (out, new_s)
        return jax.value_and_grad(sq, has_aux=True)(x)

    for T in (23, 40):
        X = rng.standard_normal((2, T, 13)).astype(np.float32)
        want, _ = jax_conv_frontend(_jnp(cnn_p), _jnp(cnn_s), cfg,
                                    jnp.asarray(X), False)
        got, _ = cnn.conv_frontend(tp, ts, cfg, _x(X), False)
        assert got.shape[1] == cnn.conv_out_len(cfg, T)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        if T != 23:
            continue
        (_, (want, want_s)), want_dx = jax_train(jnp.asarray(X))
        x = _x(X).requires_grad_(True)
        got, got_s = cnn.conv_frontend(tp, ts, cfg, x, True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL)
        for g, w in zip(got_s, want_s):
            for k in w:
                np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                           atol=1e-6)
        (dx,) = torch.autograd.grad((got ** 2).sum(), x)
        np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx),
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# text-encoder mode
# ---------------------------------------------------------------------------

def _text_corpus(root):
    """tests/test_legacy_features.py's text-to-text corpus (enc_key
    es_w, dec_key en_w), with a source word out of the vocabulary."""
    rng = np.random.RandomState(0)
    es = [f"s{i}".encode() for i in range(6)]
    en = [f"w{i}".encode() for i in range(6)]
    specials = list(SYMBOLS.START_VOCAB)

    def mkvocab(words):
        w2i = {w: i for i, w in enumerate(specials + words)}
        return {"w2i": w2i, "i2w": {i: w for w, i in w2i.items()},
                "freq": {}}

    vocab = {"es_w": mkvocab(es), "en_w": mkvocab(en)}
    map_dict, info = {"train": {}}, {"train": {}}
    for i in range(10):
        n_src, n_tgt = int(rng.randint(3, 20)), int(rng.randint(2, 8))
        src = [es[rng.randint(6)] for _ in range(n_src)]
        src[0] = b"unseen"
        map_dict["train"][f"u{i}"] = {
            "es_w": src, "en_w": [en[rng.randint(6)] for _ in range(n_tgt)]}
        info["train"][f"u{i}"] = {"es_w": n_src, "en_w": n_tgt, "sp": 0}
    data = os.path.join(root, "data")
    os.makedirs(data)
    for name, obj in (("v", vocab), ("m", map_dict), ("i", info)):
        with open(os.path.join(data, name), "wb") as f:
            pickle.dump(obj, f)
    return {"enc_key": "es_w", "dec_key": "en_w", "speech_path": data,
            "map_path": os.path.join(data, "m"),
            "vocab_path": os.path.join(data, "v"),
            "info_path": os.path.join(data, "i"), "max_pred": 12,
            "buckets_num": 3, "buckets_width": 8, "train_scale": 1,
            "zero_input": 0.2, "n_evals": 1, "target_pad_multiple": 4}


@pytest.mark.parametrize("epoch", [None, 2])
def test_text_mode_batches_match_ast_tpu(tmp_path, epoch):
    """Text-encoder batches: int32 token ids (UNK for an unknown word,
    PAD after), bucketed by the enc_key count, frame_len the token
    count, targets and order -- all equal to ast_tpu's."""
    cfg = _text_corpus(str(tmp_path))
    dirs = [tmp_path / d for d in ("a", "b")]
    for d in dirs:
        d.mkdir()
    want = list(JaxFisherLoader(cfg, str(dirs[0]), seed="s").get_batch(
        4, "train", train=True, labels=True, epoch=epoch))
    got = list(FisherDataLoader(cfg, str(dirs[1]), seed="s").get_batch(
        4, "train", train=True, labels=True, epoch=epoch))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g["X"].dtype == np.int32 and g["X"].ndim == 2
        assert (g["X"] == SYMBOLS.UNK_ID).any()
        for k in ("X", "y", "frame_len"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g["utts"] == w["utts"] and g["n_real"] == w["n_real"]
    for d in dirs:
        assert os.path.exists(d / "buckets_es_w.dict")


# ---------------------------------------------------------------------------
# the scan path's draws, against the kernel path's plain versions
# ---------------------------------------------------------------------------

def _real_rate_inputs():
    mcfg = _mcfg()
    mcfg["dropout"] = {"embed": 0.3, "rnn": 0.3, "out": 0}
    _, params, state, X, y, _, _ = _model("default")
    x = _x(X)
    draws = seq2seq.make_draws(7, x, U - 1, 0.8, 0.0, random_out=0.1,
                               vocab=V)
    assert (draws.coins == 0).any()          # scheduled sampling runs
    return mcfg, params, state, x, _x(y).long(), draws


def _loss_and_grads(fn, params, state):
    tp, ts = from_jax_numpy(params, state)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, new_state = fn(tp, ts)
    return loss, torch.autograd.grad(loss, leaves), new_state


def test_scan_path_equals_kernel_path_at_real_rates():
    """On the default variant at dropout 0.3 / 0.3, teach ratio 0.8 and
    random_out 0.1, the scan encoder and the scan loss called directly
    give the kernel path's numbers (K1 train's and K3's plain versions)
    under the same Draws: the same hash masks, coins and corruption.
    Output, loss and every gradient within 1e-5; BN state equal."""
    mcfg, params, state, x, y, draws = _real_rate_inputs()

    def kernel_path(tp, ts):
        return seq2seq.forward_loss(tp, ts, mcfg, x, y, float(B), draws,
                                    label_smoothing=0.1)

    def scan_path(tp, ts):
        enc, h0, c0, new_state = seq2seq.scan_encode(
            tp, ts, mcfg, x, True, draws.enc_seed)
        ref = seq2seq.encode_train(tp, ts, mcfg, x, draws)
        for a, b in zip((enc, h0, c0), ref[:3]):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), atol=ATOL)
        return seq2seq.scan_decoder_loss(tp, mcfg, enc, h0, c0, y, float(B),
                                         draws, 0.1), new_state

    want, want_g, want_s = _loss_and_grads(kernel_path, params, state)
    got, got_g, got_s = _loss_and_grads(scan_path, params, state)
    np.testing.assert_allclose(got.item(), want.item(), rtol=ATOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL)
    for g, w in zip(flatten(to_numpy(got_s)).values(),
                    flatten(to_numpy(want_s)).values()):
        np.testing.assert_array_equal(g, w)


def test_output_dropout_mask_is_a_new_stream():
    """Output dropout: step t's logits keep-mask is the hash mask of
    Draws.out_seed(t) over (B, V), applied before the argmax that feeds
    a sampled step; its seeds repeat none of K3's."""
    mcfg, params, state, x, y, draws = _real_rate_inputs()
    mcfg["dropout"]["out"] = 0.3
    tp, ts = from_jax_numpy(params, state)
    enc, h0, c0 = seq2seq.encode(tp, ts, mcfg, x)
    carry = seq2seq.init_decoder_carry(mcfg, h0, c0)
    t = 3
    dropped, _, _ = seq2seq.decode_step(tp, mcfg, enc, carry, y[:, t],
                                        (draws, t))
    eval_cfg = dict(mcfg, dropout=dict(mcfg["dropout"], out=0))
    plain, _, _ = seq2seq.decode_step(tp, eval_cfg, enc, carry, y[:, t],
                                      (draws, t))
    keep = drop_mask((B, V), 0.3, draws.out_seed(t), row_axis=0)
    assert torch.equal(dropped, torch.where(keep, plain / 0.7, 0.0))
    assert 0 < keep.float().mean() < 1
    steps, L = U - 1, mcfg["rnn_config"]["dec_layers"]
    k3 = ({draws.dec_seed + 2 * s for s in range(steps)}
          | {draws.dec_seed + 2 * (s * L + l) + 1 for s in range(steps)
             for l in range(L)})
    assert not k3 & {draws.out_seed(s) for s in range(steps)}
    # the scan loss runs on it and trains (a finite, differentiable loss)
    loss, grads, _ = _loss_and_grads(
        lambda p, s: seq2seq.forward_loss(p, s, mcfg, x, y, float(B), draws),
        params, state)
    assert np.isfinite(loss.item())
    assert all(torch.isfinite(g).all() for g in grads)


# ---------------------------------------------------------------------------
# the kernels' shape gate: on a CUDA device a stage its kernels do not take
# runs plain, as ast_tpu's chunk gates send it to the scan path
# ---------------------------------------------------------------------------

# es_en_20h's widths
WIDE = dict(hidden_units=512, embedding_units=128, attn_units=512)
T_WIDE = 160


def _wide(**rnn):
    m = _mcfg()
    m["rnn_config"].update(WIDE, **rnn)
    return m


def _passes(check, *args):
    try:
        check(*args)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("rnn,stages", [
    ({}, {"enc", "dec", "infer"}),
    ({"hidden_units": 80}, set()),
    ({"embedding_units": 100}, {"enc"}),
    ({"attn_units": 200}, {"enc"}),
    ({"hidden_units": 80, "bi_rnn": False}, set()),
    ({"hidden_units": 64}, {"enc", "dec", "infer"}),
])
def test_shape_gate_routes_widths(rnn, stages):
    """hidden_units 80 (40 a direction), embedding_units 100: on a CUDA
    device each predicate routes its stage to the plain version exactly
    where its kernel's check raises; on the CPU every stage takes its
    kernel's plain version."""
    mcfg = _wide(**rnn)
    r = mcfg["rnn_config"]
    H, E, A = r["hidden_units"], r["embedding_units"], r["attn_units"]
    units = H // (2 if r["bi_rnn"] else 1)
    checks = {
        "enc": _passes(fused_lstm.check_encoder_shapes, units),
        "dec": _passes(fused_decoder.check_train_shapes, T_WIDE, H, E, A),
        "infer": _passes(fused_infer.check_decode_shapes, 8, T_WIDE, H, E,
                         A, 1)}
    routed = {
        "enc": seq2seq.use_fused_encoder(mcfg, "cuda"),
        "dec": seq2seq.use_fused_decoder(mcfg, "cuda", T=T_WIDE),
        "infer": seq2seq.use_fused_infer(mcfg, "cuda", 8, T_WIDE)}
    preds = {"enc": fused_lstm.encoder_shapes_ok(units),
             "dec": fused_decoder.train_shapes_ok(T_WIDE, H, E, A),
             "infer": fused_infer.decode_shapes_ok(8, T_WIDE, H, E, A, 1)}
    assert {k for k, v in routed.items() if v} == stages
    assert routed == checks == preds
    assert (seq2seq.use_fused_encoder(mcfg, "cpu"),
            seq2seq.use_fused_decoder(mcfg, "cpu", T=T_WIDE),
            seq2seq.use_fused_infer(mcfg, "cpu", 8, T_WIDE)) == (
                True, True, True)


@pytest.mark.parametrize("B,T,N,K,ok", [
    (8, T_WIDE, 5, 5, True),
    (2, T_WIDE, 40, 2, False),      # cli.beam -n 40
    (2, T_WIDE, 32, 5, True),
    (1, 2000, 32, 1, False),        # attention past a block's memory
    (1, 100, 32, 200, False),       # N * K candidates past 48 KB
])
def test_shape_gate_routes_beams(B, T, N, K, ok):
    """K6's gate at the call's B, T', N and K: the predicate, the
    routing and the kernel's check agree."""
    mcfg = _wide()
    dims = (B, T, WIDE["hidden_units"], WIDE["embedding_units"],
            WIDE["attn_units"], N, K)
    assert fused_infer.decode_shapes_ok(*dims) == ok
    assert _passes(fused_infer.check_decode_shapes, *dims) == ok
    assert seq2seq.use_fused_infer(mcfg, "cuda", B, T, N, K) == ok
    assert seq2seq.use_fused_infer(mcfg, "cpu", B, T, N, K)


def test_shape_gate_routes_the_training_decoder_by_T():
    """The training decoder's gate is evaluated at the call's T': past a
    block's shared memory for attention it routes to the scan loss."""
    mcfg = _wide()
    assert seq2seq.use_fused_decoder(mcfg, "cuda", T=56000)
    assert not seq2seq.use_fused_decoder(mcfg, "cuda", T=58000)
    assert seq2seq.use_fused_decoder(mcfg, "cpu", T=58000)


@pytest.mark.parametrize("rnn,named", [
    ({"hidden_units": 80}, "hidden_units 80 (40 a direction"),
    ({"embedding_units": 100}, "embedding_units 100"),
])
def test_bf16_refuses_an_odd_width_by_name(rnn, named, monkeypatch):
    """Once refused at bf16 by name, a width the card's shape gate sends
    to the plain stages now trains, greedy- and beam-decodes at bf16:
    with the gate applied to CPU tensors and no kernel wrapper called,
    equal to ast_tpu's scan path at bf16 on the same model (its einsums
    widened as tests/test_torch_bf16_scan.py runs them) -- greedy ids
    and beams exactly, scores within 1e-4, the train loss within 1e-5
    relative."""
    mcfg, params, state, X, y, tp, ts = _model("default", **rnn)
    assert not (seq2seq.use_fused_encoder(mcfg, "cuda")
                or seq2seq.use_fused_infer(mcfg, "cuda", B, 6)), named
    for mod in (jax_seq2seq, jax_attention):
        monkeypatch.setattr(mod, "jnp", _ExactBf16())
    monkeypatch.setattr(seq2seq, "on_card", lambda device: True)
    for name in ("fused_stacked_lstm", "greedy_decode_fused"):
        monkeypatch.setattr(seq2seq, name, _refuse)
    monkeypatch.setattr(seq2seq.FusedStackedLSTM, "apply", _refuse)
    monkeypatch.setattr(seq2seq.FusedDecoder, "apply", _refuse)
    monkeypatch.setattr(beam_ops, "beam_decode_fused", _refuse)
    bf = torch.bfloat16

    want, want_n = jax.jit(lambda p, s, x: jax_seq2seq.predict_greedy(
        p, s, mcfg, x, STOP, compute_dtype=jnp.bfloat16))(
            _jnp(params), _jnp(state), jnp.asarray(X))
    got, got_n = seq2seq.predict_greedy(tp, ts, mcfg, _x(X), STOP,
                                        compute_dtype=bf)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got_n) == int(want_n)
    want = jax_beam.make_beam_decoder(mcfg, N, K, STOP,
                                      compute_dtype=jnp.bfloat16)(
        _jnp(params), _jnp(state), jnp.asarray(X))
    got = beam_ops.make_beam_decoder(mcfg, N, K, STOP, compute_dtype=bf)(
        tp, ts, _x(X))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=1e-4)
    want_loss, _ = jax.jit(lambda p, s, x, t: jax_seq2seq.forward_loss(
        p, s, mcfg, x, t, jax.random.PRNGKey(1), train=True,
        n_real=float(B), teach_ratio=1.0, compute_dtype=jnp.bfloat16))(
            _jnp(params), _jnp(state), jnp.asarray(X), jnp.asarray(y))
    draws = seq2seq.Draws(None, 11, 12, torch.ones(U - 1, dtype=torch.int32))
    got_loss, _ = seq2seq.forward_loss(tp, ts, mcfg, _x(X), _x(y).long(),
                                       float(B), draws, compute_dtype=bf)
    np.testing.assert_allclose(got_loss.item(), float(want_loss),
                               rtol=ATOL)


def _refuse(*args, **kwargs):
    raise AssertionError("a kernel wrapper was called")


@pytest.mark.parametrize("rnn", [{"hidden_units": 80},
                                 {"embedding_units": 100}])
def test_odd_widths_take_the_plain_stages(rnn, monkeypatch):
    """With the card's shape gate applied to CPU tensors, a model of 40
    units a direction or E = 100 trains, greedy- and beam-decodes with no
    kernel wrapper called, equal to ast_tpu's scan path on the same model:
    greedy ids and beams exactly, scores and the train step's loss within
    1e-5."""
    mcfg, params, state, X, y, tp, ts = _model("default", **rnn)
    monkeypatch.setattr(seq2seq, "on_card", lambda device: True)
    for name in ("fused_stacked_lstm", "greedy_decode_fused"):
        monkeypatch.setattr(seq2seq, name, _refuse)
    monkeypatch.setattr(seq2seq.FusedStackedLSTM, "apply", _refuse)
    monkeypatch.setattr(seq2seq.FusedDecoder, "apply", _refuse)
    monkeypatch.setattr(beam_ops, "beam_decode_fused", _refuse)

    want, want_n = jax.jit(lambda p, s, x: jax_seq2seq.predict_greedy(
        p, s, mcfg, x, STOP))(_jnp(params), _jnp(state), jnp.asarray(X))
    got, got_n = seq2seq.predict_greedy(tp, ts, mcfg, _x(X), STOP)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got_n) == int(want_n)
    want = jax_beam.make_beam_decoder(mcfg, N, K, STOP)(
        _jnp(params), _jnp(state), jnp.asarray(X))
    got = beam_ops.make_beam_decoder(mcfg, N, K, STOP)(tp, ts, _x(X))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=ATOL)
    want_loss, _ = jax_seq2seq.forward_loss(
        _jnp(params), _jnp(state), mcfg, jnp.asarray(X), jnp.asarray(y),
        jax.random.PRNGKey(1), train=True, n_real=float(B), teach_ratio=1.0)
    draws = seq2seq.Draws(None, 11, 12, torch.ones(U - 1, dtype=torch.int32))
    got_loss, _ = seq2seq.forward_loss(tp, ts, mcfg, _x(X), _x(y).long(),
                                       float(B), draws)
    np.testing.assert_allclose(got_loss.item(), float(want_loss),
                               rtol=ATOL)


def test_wide_beam_takes_the_plain_loop(monkeypatch):
    """A beam of N = 40 on a model the kernels take: with the card's gate
    the frontier loop runs plain (K6 not called), equal to ast_tpu's beam
    of the same width; a beam of N = 3 would take K6."""
    widths = dict(hidden_units=64, embedding_units=32, attn_units=32)
    mcfg, params, state, X, _, tp, ts = _model("default", **widths)
    monkeypatch.setattr(seq2seq, "on_card", lambda device: True)
    assert seq2seq.use_fused_infer(mcfg, "cpu", B, 6, N, K)
    assert not seq2seq.use_fused_infer(mcfg, "cpu", B, 6, 40, 2)
    monkeypatch.setattr(beam_ops, "beam_decode_fused", _refuse)
    want = jax_beam.make_beam_decoder(mcfg, 40, 2, STOP)(
        _jnp(params), _jnp(state), jnp.asarray(X))
    got = beam_ops.make_beam_decoder(mcfg, 40, 2, STOP)(tp, ts, _x(X))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=ATOL)
