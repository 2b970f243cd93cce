"""ast_tpu_torch's bfloat16 scan path (``extras.compute_dtype:
"bfloat16"`` on the model variants ast_tpu runs on XLA) against ast_tpu
at bf16, on the CPU.

ast_tpu runs ``ln``, ``rnn_relu``, ``linear_proj``, two attention
heads, no input feeding, blockwise attention, output dropout and an
encoder mask on its scan path (its XLA code) at bf16, with its own
rounding points: a layer's input and ``wx`` rounded for their product,
``h @ wh`` f32, the attention's encoder states, query and softmax
weights rounded, the logits' ``ht`` and ``out_w`` rounded, and
``linear_proj``'s layers f32 after the bf16 conv.  Beside them the
kernel stages of the same models run their bf16 modes (K1 eval / train
and K2 under a plain decoder; K3-K6 under a ``linear_proj`` encoder).

On XLA:CPU a bf16 einsum into f32 is not implemented ("Unsupported
element type for DotThunk::Execute: BF16 x BF16 = F32"), so ast_tpu's
modules run with ``jnp.einsum`` widening its bf16 operands to f32 first
(:class:`_ExactBf16`, set on ``ast_tpu.models.seq2seq`` and
``ast_tpu.ops.attention`` inside each test).  A product of two bf16
values is exact in f32, so that is the same function; its VJP still
rounds each operand's cotangent to bf16 where the operand was cast, as
XLA's transpose does.  Everything else is ast_tpu's own code: its
``encode``, ``decode_step``, ``luong_attention``, greedy loop, beam
frontier loop and ``forward_loss`` at ``jnp.bfloat16``, and its Pallas
kernels in interpret mode at the stages the port routes to kernels
(``fused_encoder`` / ``fused_decoder`` / ``fused_interpret`` set; the
port ignores the flags).  The same perturbed parameters (through the
weight bridge) and numpy inputs go through both packages.

Tolerances.  Both packages round the same values at the same points
and accumulate in f32, so only the f32 summation order (and the
transcendental functions' last bits) differ.  Decoding, as
tests/test_torch_bf16.py: greedy ids, beam hyps and lengths exactly,
beam scores within 1e-4, attention histories within 1e-5.  The train
step rounds far more values than a decode, and a value whose two f32
results straddle a bf16 rounding boundary rounds to neighbouring bf16
values in the two packages: a leaf gradient rounded to bf16 (a weight
cast for a product) then differs by one bf16 ulp, up to 2^-7 of its
largest value.  ast_tpu's own ``forward_loss`` scan and the same
decoder unrolled in Python differ by 6.5e-3 of a leaf's largest
gradient on the ``ln`` model here, so no implementation meets 1e-4 of
it.  The train step is held to: the loss within 1e-4 relative (one
rounding that lands on the other neighbour inside K1's bf16 forward
moves it by 1.9e-5 on the ``out_drop`` model), every gradient within
2^-6 of its leaf's largest reference value plus 1e-6 (two such ulps;
the 1e-6 covers ``linear_proj``'s projection bias, whose gradient
before a batch-statistics BN is 0 in exact arithmetic), the BN state
within 1e-6, and one SGD step's parameters within the learning rate
times twice that gradient tolerance.  Training runs at dropout 0 and
teach ratio 1 (the packages draw their masks differently; output
dropout is the identity in both, as in tests/test_torch_variants.py).
That bound refuses the step at f32 (1.6 to 32 times it) but not a
backward that leaves the cotangents unrounded (0.29 to 0.78 of it, the
faithful step 0.004 to 0.47), so one decoder step's gradients, where
few terms are summed and the two packages round alike, are held within
1e-4 of each leaf's max: there the faithful step lies within
0.45 of the bound and both controls 34 to 490 times past it.
Dropping one of the scan path's rounding points, or adding K1's round
of ``wh`` or a cast inside ``linear_proj``, moves some beam score of
the ``ln`` (or ``linear_proj``) model past SCORE_TOL, where the port
agrees with ast_tpu within 2e-6 (``test_each_scan_rounding_point_matters``).
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ast_tpu.models import seq2seq as jax_seq2seq
from ast_tpu.ops import attention as jax_attention
from ast_tpu.ops import beam as jax_beam
from ast_tpu.symbols import SYMBOLS
from ast_tpu.train import checkpoint as jax_ckpt
from ast_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from ast_tpu_torch.checkpoint import flatten
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.ops import attention, fused_lstm
from ast_tpu_torch.ops import beam as beam_ops
from ast_tpu_torch.ops.bf16 import rounded
from ast_tpu_torch.params import from_jax_numpy, tree_map
from ast_tpu_torch.train.optimizer import build_optimizer, tree_leaves
from ast_tpu_torch.train.trainer import to_numpy
from tests.conftest import TINY_MODEL_CFG

BF = torch.bfloat16
JBF = jnp.bfloat16
V, B, U, STOP, N, K = 16, 3, 9, 10, 3, 3
T_IN, T_ENC = 24, 6
ATOL = 1e-5
SCORE_TOL = 1e-4
GRAD_TOL = 2 ** -6      # of max|reference| a leaf, plus GRAD_ATOL
GRAD_ATOL = 1e-6
LOSS_RTOL = 1e-4
SGD = {"type": 1, "lr": 0.1, "l2": 1e-4, "grad_clip": 2}


class _ExactBf16:
    """``jax.numpy`` whose ``einsum`` of bf16 operands into f32 widens
    them to f32 first (exact), which XLA:CPU runs."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) if o.dtype == JBF else o
                   for o in ops]
        return jnp.einsum(spec, *ops,
                          preferred_element_type=preferred_element_type, **kw)


@pytest.fixture(autouse=True)
def exact_bf16(monkeypatch):
    for mod in (jax_seq2seq, jax_attention):
        monkeypatch.setattr(mod, "jnp", _ExactBf16())


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these tiny tensors: several test workers
    share the machine's cores, and a pool each only adds contention."""
    with torch_threads(1):
        yield


@contextlib.contextmanager
def torch_threads(n):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _rnn(**kw):
    return lambda m: m["rnn_config"].update(kw)


VARIANTS = {
    "ln": _rnn(ln=True),
    "rnn_relu": _rnn(rnn_relu=True),
    "ln_relu": _rnn(ln=True, rnn_relu=True),
    "linear_proj": _rnn(linear_proj=True),
    "n_attn2": _rnn(n_attn=2),
    "no_feed": _rnn(feed_attn=False),
    "block": _rnn(attn_block_size=4),
    "out_drop": lambda m: m["dropout"].update(out=0.3),
    "enc_mask": lambda m: None,         # the default model, masked
}
# the stages each variant runs in a kernel's bf16 mode (here its plain
# version); the others run the scan path
KERNEL_STAGES = {
    "ln": set(), "rnn_relu": set(), "ln_relu": set(),
    "linear_proj": {"dec", "infer"}, "n_attn2": {"enc"},
    "no_feed": {"enc"}, "block": {"enc"}, "out_drop": {"enc", "infer"},
    "enc_mask": {"enc"},
}
X_LEN = np.array([T_IN, 13, 7], np.int32)


def _mcfg(name=None):
    """The variant ``name`` of the tiny model (None: the default one),
    with ast_tpu's kernel flags set."""
    m = copy.deepcopy(TINY_MODEL_CFG)
    m["rnn_config"].update(dec_vocab_size=V, fused_encoder=True,
                           fused_decoder=True, fused_interpret=True)
    m["dropout"] = {"embed": 0.0, "rnn": 0.0, "out": 0}
    if name is not None:
        VARIANTS[name](m)
    return m


def _perturb(tree, rng, scale):
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), tree)


_CACHE = {}


def _model(name):
    """(mcfg, numpy params, numpy state, X, y, port params, port state,
    numpy mask or None): the port's seeded init, perturbed (BN variances
    kept positive, an EOS bias that staggers the ends of greedy rows)."""
    if name not in _CACHE:
        mcfg = _mcfg(name)
        rng = np.random.default_rng(sorted(VARIANTS).index(name))
        params, state = (to_numpy(t) for t in seq2seq.init_model(mcfg, 5))
        params = _perturb(params, rng, 0.2)
        params["dec"]["out_b"][SYMBOLS.EOS_ID] += 1.5
        state = _perturb(state, rng, 0.1)
        for group in ("cnn_bn", "enc_proj_bn"):
            for s in state[group]:
                s["bn_var"] = np.abs(s["bn_var"]) + 0.5
        X = rng.standard_normal((B, T_IN, 13)).astype(np.float32)
        y = np.zeros((B, U), np.int32)
        for b, n in enumerate([6, 4, 7]):
            y[b, 0] = SYMBOLS.GO_ID
            y[b, 1:1 + n] = rng.integers(4, V, n)
            y[b, 1 + n] = SYMBOLS.EOS_ID
        mask = None
        if name == "enc_mask":
            mask = np.asarray(jax_seq2seq.make_enc_mask(
                mcfg, jnp.asarray(X_LEN), T_ENC))
            assert not mask.all()
        tp, ts = from_jax_numpy(params, state)
        _CACHE[name] = (mcfg, params, state, X, y, tp, ts, mask)
    return _CACHE[name]


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _identity_out_dropout(monkeypatch):
    """Both packages' logit dropout replaced by the identity."""
    monkeypatch.setattr(jax_seq2seq, "dropout",
                        lambda key, x, rate, train: x)
    monkeypatch.setattr(seq2seq, "dropout", lambda x, keep, rate: x)


def _routes(name):
    mcfg, _, _, _, _, _, _, mask = _model(name)
    m = _t(mask)
    return {stage for stage, on in (
        ("enc", seq2seq.use_fused_encoder(mcfg, "cpu")),
        ("dec", seq2seq.use_fused_decoder(mcfg, "cpu", m)),
        ("infer", seq2seq.use_fused_infer(mcfg, "cpu", B, T_ENC,
                                          enc_mask=m))) if on}


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_greedy_bf16_matches_ast_tpu(name):
    mcfg, params, state, X, _, tp, ts, mask = _model(name)
    assert _routes(name) == KERNEL_STAGES[name]
    want, want_n = jax.jit(lambda p, s, x, m: jax_seq2seq.predict_greedy(
        p, s, mcfg, x, STOP, compute_dtype=JBF, enc_mask=m))(
            _jnp(params), _jnp(state), jnp.asarray(X),
            None if mask is None else jnp.asarray(mask))
    got, got_n = seq2seq.predict_greedy(tp, ts, mcfg, _t(X), STOP,
                                        enc_mask=_t(mask), compute_dtype=BF)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got_n) == int(want_n)
    assert (got == SYMBOLS.EOS_ID).any()


def _beam(name, return_attn):
    mcfg, params, state, X, _, tp, ts, _ = _model(name)
    want = jax_beam.make_beam_decoder(mcfg, N, K, STOP, compute_dtype=JBF,
                                      return_attn=return_attn)(
        _jnp(params), _jnp(state), jnp.asarray(X))
    got = beam_ops.make_beam_decoder(mcfg, N, K, STOP, return_attn,
                                     compute_dtype=BF)(tp, ts, _t(X))
    return got, [np.asarray(a) for a in want]


def _assert_beams(got, want):
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_array_equal(got[2].numpy(), want[2])


@pytest.mark.parametrize("name", sorted(set(VARIANTS) - {"enc_mask"}))
def test_beam_and_attention_history_bf16_match_ast_tpu(name):
    """With ``return_attn`` (ast_tpu's frontier loop on every variant):
    hyps and lengths exactly, scores within 1e-4, histories within 1e-5;
    without it the same beams, through K6's bf16 mode where the variant
    takes it (ast_tpu's K6 in interpret mode)."""
    got, want = _beam(name, True)
    _assert_beams(got, want)
    np.testing.assert_allclose(got[3].numpy(), want[3], rtol=0, atol=ATOL)
    plain, want_plain = _beam(name, False)
    _assert_beams(plain, want_plain)
    if "infer" not in KERNEL_STAGES[name]:
        for a, b in zip(plain, got[:3]):
            assert torch.equal(a, b)


def test_masked_beam_bf16_is_the_masked_greedy():
    """ast_tpu's beam decoder takes no mask: the port's masked beam at
    bf16, at N = K = 1, is the masked greedy decode (held to ast_tpu's
    above), and its attention histories give masked frames nothing."""
    mcfg, _, _, X, _, tp, ts, mask = _model("enc_mask")
    greedy = seq2seq.predict_greedy(tp, ts, mcfg, _t(X), STOP,
                                    enc_mask=_t(mask), compute_dtype=BF)[0]
    hyps, _, lengths, attn = beam_ops.make_beam_decoder(
        mcfg, 1, 1, STOP, return_attn=True, compute_dtype=BF)(
            tp, ts, _t(X), enc_mask=_t(mask))
    for b in range(B):
        n = int(lengths[b, 0]) - 1
        np.testing.assert_array_equal(hyps[b, 0, 1:1 + n].numpy(),
                                      greedy[b, :n].numpy())
    assert (attn[~_t(mask)[:, None, None, :].expand_as(attn)] == 0).all()
    inside = torch.arange(STOP + 1)[None, None] < lengths[..., None]
    inside[..., 0] = False
    np.testing.assert_allclose(attn.sum(-1)[inside].numpy(), 1.0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

_STEPS = {}


def _jax_step(name):
    """ast_tpu's bf16 train step: (loss, flat grads, flat new state), and
    the parameters after one SGD step, flat."""
    if name not in _STEPS:
        mcfg, params, state, X, y, _, _, mask = _model(name)

        def loss_fn(p, s, x, t, m):
            return jax_seq2seq.forward_loss(
                p, s, mcfg, x, t, jax.random.PRNGKey(1), train=True,
                n_real=float(B), teach_ratio=1.0, compute_dtype=JBF,
                enc_mask=m)

        (loss, new_state), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(
                _jnp(params), _jnp(state), jnp.asarray(X), jnp.asarray(y),
                None if mask is None else jnp.asarray(mask))
        tx, opt_state = jax_build_optimizer(SGD, _jnp(params))
        upd, _ = tx.update(grads, opt_state, _jnp(params))
        stepped = jax.tree.map(lambda p, u: p + u, _jnp(params), upd)
        flat = lambda tree: jax_ckpt._flatten(jax.tree.map(np.asarray, tree))
        _STEPS[name] = (float(loss), flat(grads), flat(new_state),
                        flat(stepped))
    return _STEPS[name]


def _port_step(name, compute_dtype=BF):
    """The port's train step at ``compute_dtype``: (loss, flat grads,
    flat new state, flat parameters after one SGD step)."""
    mcfg, params, state, X, y, _, _, mask = _model(name)
    tp, ts = from_jax_numpy(params, state)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    draws = seq2seq.Draws(None, 11, 12, torch.ones(U - 1, dtype=torch.int32))
    loss, new_state = seq2seq.forward_loss(
        tp, ts, mcfg, _t(X), _t(y).long(), float(B), draws,
        enc_mask=_t(mask), compute_dtype=compute_dtype)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    gtree = tree_map(lambda _: next(it), tp)
    with torch.no_grad():
        for p in leaves:
            p.requires_grad_(False)
        opt, opt_state = build_optimizer(SGD, tp)
        upd, _ = opt.update(gtree, opt_state, tp)
        for p, d in zip(leaves, tree_leaves(upd)):
            p.add_(d)
    return (loss.item(), flatten(to_numpy(gtree)),
            flatten(to_numpy(new_state)), flatten(to_numpy(tp)))


def _worst(got, want):
    """The largest leaf error over its tolerance (GRAD_TOL of the leaf's
    max |reference| plus GRAD_ATOL), and its leaf."""
    assert sorted(got) == sorted(want)
    errs = {k: float(np.abs(np.asarray(got[k], np.float64) - want[k]).max())
            / (GRAD_TOL * float(np.abs(want[k]).max()) + GRAD_ATOL)
            for k in want}
    k = max(errs, key=errs.get)
    return errs[k], k


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_train_step_bf16_matches_ast_tpu(name, monkeypatch):
    """The loss, every parameter's gradient, the moved BN statistics and
    the parameters after one SGD step (l2 and clipping on) against
    ast_tpu's bf16 step."""
    if name == "out_drop":
        _identity_out_dropout(monkeypatch)
    want_loss, want_g, want_s, want_p = _jax_step(name)
    loss, grads, new_state, stepped = _port_step(name)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    worst = _worst(grads, want_g)
    assert worst[0] <= 1, worst
    assert sorted(new_state) == sorted(want_s)
    for k in want_s:
        np.testing.assert_allclose(new_state[k], want_s[k], rtol=0,
                                   atol=1e-6, err_msg=k)
    assert sorted(stepped) == sorted(want_p)
    for k in want_p:
        tol = SGD["lr"] * 2 * (GRAD_TOL * float(np.abs(want_g[k]).max())
                               + GRAD_ATOL)
        np.testing.assert_allclose(stepped[k], want_p[k], rtol=0,
                                   atol=tol + 1e-7, err_msg=k)


@pytest.mark.parametrize("name", ["ln", "block"])
def test_train_step_at_f32_leaves_the_bf16_bound(name):
    """A control for the test above: the port's train step at f32 moves
    some gradient past the bound around ast_tpu's bf16 step (1.6 to 32
    times it over the variants; the faithful bf16 step: within 0.47 of
    it).  The bound cannot tell a backward that leaves the cotangents
    unrounded (0.29 to 0.78 of it) from two summation orders: the
    one-step test below holds that rounding."""
    worst = _worst(_port_step(name, torch.float32)[1], _jax_step(name)[1])
    assert worst[0] > 1, worst


# ---------------------------------------------------------------------------
# the scan path's rounding points, not the kernel path's
# ---------------------------------------------------------------------------

def test_scan_encoder_rounding_is_not_k1s():
    """The stacked recurrence at the scan's rounding points (f32 weights,
    ``compute_dtype`` bf16) and at K1's (bf16 weights: ``wh`` and ``h``
    rounded too) are two functions: at the same inputs they part by
    more than the tolerance, and neither is the f32 recurrence."""
    rng = np.random.RandomState(0)
    T, L, D2, Bn, H = 7, 3, 2, 3, 8
    x0 = torch.from_numpy(rng.randn(T, D2, Bn, 4 * H).astype(np.float32))
    wx, wh = (torch.from_numpy((rng.randn(n, D2, H, 4 * H) * 0.5)
                               .astype(np.float32)) for n in (L - 1, L))
    b = torch.from_numpy((rng.randn(L, D2, 4 * H) * 0.1).astype(np.float32))
    scan = fused_lstm.stacked_lstm_reference(x0, wx, wh, b,
                                             compute_dtype=BF)[0]
    k1 = fused_lstm.stacked_lstm_reference(x0, wx.to(BF), wh.to(BF), b)[0]
    f32 = fused_lstm.stacked_lstm_reference(x0, wx, wh, b)[0]
    assert float((scan - k1).abs().max()) > 10 * ATOL
    assert float((scan - f32).abs().max()) > 10 * ATOL
    assert float((k1 - f32).abs().max()) > 10 * ATOL


def _round_unless(pred, real):
    return lambda x, *a: x if pred(x) else real(x, *a)


def _mutate(point, monkeypatch):
    H = TINY_MODEL_CFG["rnn_config"]["hidden_units"]
    if point == "scan_wx_dropped":
        # the encoder's wx (D2, H_e, 4 H_e) and the decoder's (in, 4 H)
        monkeypatch.setattr(fused_lstm, "rounded", _round_unless(
            lambda x: x.shape[-1] == 2 * H, rounded))
        dot = seq2seq.scan_dot
        monkeypatch.setattr(seq2seq, "scan_dot", lambda a, w, dt: (
            rounded(a) @ w if w.shape[-1] == 4 * H else dot(a, w, dt)))
    elif point in ("enc_c_dropped", "alphas_dropped"):
        dims = 3 if point == "enc_c_dropped" else 2
        last = H if point == "enc_c_dropped" else T_ENC
        monkeypatch.setattr(attention, "_bf16", _round_unless(
            lambda x: x.dim() == dims and x.shape[-1] == last,
            attention._bf16))
    elif point == "logits_dropped":
        dot = seq2seq.scan_dot
        monkeypatch.setattr(seq2seq, "scan_dot", lambda a, w, dt: (
            a @ w if w.shape[-1] == V else dot(a, w, dt)))
    elif point == "wh_added":
        ref = seq2seq.stacked_lstm_reference
        monkeypatch.setattr(
            seq2seq, "stacked_lstm_reference",
            lambda x0, wx, wh, *a, **kw: ref(x0, wx, rounded(wh), *a, **kw))
    elif point == "proj_cast_added":
        stack = seq2seq._direction_stack
        monkeypatch.setattr(seq2seq, "_direction_stack",
                            lambda *a: rounded(stack(*a)))


@pytest.mark.parametrize("point,name", [
    ("scan_wx_dropped", "ln"), ("enc_c_dropped", "ln"),
    ("alphas_dropped", "ln"), ("logits_dropped", "ln"),
    ("wh_added", "ln"), ("proj_cast_added", "linear_proj")])
def test_each_scan_rounding_point_matters(point, name, monkeypatch):
    """The port with one of ast_tpu's scan-path rounding points dropped
    (the scan's ``wx``, attention's encoder states or softmax weights,
    the logits' operands), with K1's round of ``wh`` added to the scan
    encoder, or with a cast inside ``linear_proj``'s layers, moves some
    beam score of ast_tpu's frontier loop past SCORE_TOL (the faithful
    port: within 2e-6): the beam test above holds each point."""
    _mutate(point, monkeypatch)
    got, want = _beam(name, True)
    assert float(np.abs(got[1].numpy() - want[1]).max()) > SCORE_TOL, point


# ---------------------------------------------------------------------------
# a beam wider than the kernel takes
# ---------------------------------------------------------------------------

def _refuse(*args, **kwargs):
    raise AssertionError("a kernel wrapper was called")


def test_wide_beam_bf16_takes_the_plain_loop(monkeypatch):
    """A beam of N = 40 at bf16 with the card's shape gate: K1's bf16
    mode encodes (ast_tpu's kernel, interpret mode), the frontier loop
    runs plain at the scan's rounding points (K6 not called), equal to
    ast_tpu's beam of the same width on its XLA loop."""
    widths = dict(hidden_units=64, embedding_units=32, attn_units=32)
    mcfg = _mcfg()
    mcfg["rnn_config"].update(widths)
    rng = np.random.default_rng(11)
    params, state = (to_numpy(t) for t in seq2seq.init_model(mcfg, 6))
    params = _perturb(params, rng, 0.1)
    X = rng.standard_normal((2, T_IN, 13)).astype(np.float32)
    tp, ts = from_jax_numpy(params, state)
    monkeypatch.setattr(seq2seq, "on_card", lambda device: True)
    assert seq2seq.use_fused_encoder(mcfg, "cpu")
    assert seq2seq.use_fused_infer(mcfg, "cpu", 2, T_ENC, N, K)
    assert not seq2seq.use_fused_infer(mcfg, "cpu", 2, T_ENC, 40, 2)
    monkeypatch.setattr(beam_ops, "beam_decode_fused", _refuse)
    # ast_tpu on the card sends a beam its kernel cannot hold to the XLA
    # loop; in interpret mode only the decoder flag does
    jax_cfg = copy.deepcopy(mcfg)
    jax_cfg["rnn_config"]["fused_decoder"] = False
    want = jax_beam.make_beam_decoder(jax_cfg, 40, 2, STOP,
                                      compute_dtype=JBF)(
        _jnp(params), _jnp(state), jnp.asarray(X))
    got = beam_ops.make_beam_decoder(mcfg, 40, 2, STOP, compute_dtype=BF)(
        tp, ts, _t(X))
    _assert_beams(got, [np.asarray(a) for a in want])


# ---------------------------------------------------------------------------
# chip_smoke's bf16 pass over the variants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,control", [
    ("ln", None), ("linear_proj", None), ("n_attn 2", None),
    ("dropout.out 0.3", None), ("ln", "moved"), ("linear_proj", "moved"),
    ("ln", "score_moved"), ("linear_proj", "score_moved")])
def test_chip_smoke_bf16_variant_pass_on_the_cpu(name, control,
                                                 monkeypatch):
    """chip_smoke's phase-12 bf16 pass (run_variant_bf16) on CPU tensors at
    a tiny size: the train step, the greedy and the beam batch at bf16 run
    and hold the "card's" results (here the CPU's) by the comparison of
    the variant's stages -- the CPU's call for a variant with a kernel
    stage, the float64-sum step and encode within BF16_SPREAD times the
    CPU's distance for ``ln`` -- and along their own path by the CPU's
    step; no kernel is launched.  The controls, which each comparison
    must refuse: ``moved``, the "card's" gradients all 10 % off their
    values; ``score_moved``, its beam scores 1 off the following step's."""
    import chip_smoke

    for key, value in (("FRAMES", 24), ("VARIANT_ROWS", 2), ("U_TRAIN", U),
                       ("PARTIAL_STOP", 6)):
        monkeypatch.setattr(chip_smoke, key, value)
    if control == "moved":
        step = chip_smoke.variant_step
        calls = []

        def moved_once(*args):
            loss, grads = step(*args)
            calls.append(1)
            if len(calls) == 1:
                grads = tuple(1.1 * g for g in grads)
            return loss, grads
        monkeypatch.setattr(chip_smoke, "variant_step", moved_once)
    if control == "score_moved":
        follow = chip_smoke.decode_follow_errs
        seen = []

        def score_moved_once(*args):
            out = follow(*args)
            seen.append(1)
            return dict(out, score=out["score"] + 1) if len(seen) == 1 else out
        monkeypatch.setattr(chip_smoke, "decode_follow_errs",
                            score_moved_once)
    base = copy.deepcopy(TINY_MODEL_CFG)
    base["rnn_config"]["dec_vocab_size"] = V
    base["dropout"] = {"embed": 0.3, "rnn": 0.3, "out": 0}
    if control:
        with pytest.raises(AssertionError, match={
                "moved": "bf16 gradient",
                "score_moved": "bf16 decodes"}[control]):
            chip_smoke.run_variant_bf16(name, base, "cpu", "cpu")
        return
    step_ms, greedy_rate = chip_smoke.run_variant_bf16(name, base, "cpu",
                                                       "cpu")
    assert step_ms > 0 and greedy_rate > 0


# ---------------------------------------------------------------------------
# one decoder step's gradients: the cotangents' rounding
# ---------------------------------------------------------------------------

STEP_GRAD_TOL = 1e-4    # of a leaf's max |reference|


class _Unrounded(torch.autograd.Function):
    """A round to bf16 whose backward passes the cotangent on as it is."""

    @staticmethod
    def forward(ctx, x):
        return x.to(BF).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def _step_grads(name, seed=3):
    """One bf16 decoder step of variant ``name`` (eval mode, random
    encoder states, carry and tokens) and the gradients of a random
    linear function of its logits and new carry with respect to the
    decoder's and attention's parameters, the encoder states and the
    carry: (the port's, ast_tpu's), each a dict of numpy arrays."""
    mcfg, params, _, _, _, tp, _, mask = _model(name)
    rnn = mcfg["rnn_config"]
    H, A, L = rnn["hidden_units"], rnn["attn_units"], rnn["dec_layers"]
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((B, T_ENC, H)).astype(np.float32)
    carry = {"h": rng.standard_normal((L, B, H)).astype(np.float32),
             "c": rng.standard_normal((L, B, H)).astype(np.float32),
             "ht": rng.standard_normal((B, A)).astype(np.float32)}
    tok = rng.integers(4, V, B).astype(np.int32)
    cot = {"logits": rng.standard_normal((B, V)).astype(np.float32),
           "h": rng.standard_normal((L, B, H)).astype(np.float32),
           "c": rng.standard_normal((L, B, H)).astype(np.float32),
           "ht": rng.standard_normal((B, A)).astype(np.float32)}
    sub = {"attn": params["attn"], "dec": params["dec"]}

    def jax_fn(p, e, c):
        logits, new, _ = jax_seq2seq.decode_step(
            p, mcfg, e, c, jnp.asarray(tok), jax.random.PRNGKey(0), False,
            compute_dtype=JBF, enc_mask=None if mask is None
            else jnp.asarray(mask))
        return (jnp.sum(logits * cot["logits"]) + sum(
            jnp.sum(new[k] * cot[k]) for k in ("h", "c", "ht")))

    want = jax.grad(jax_fn, argnums=(0, 1, 2))(
        _jnp(sub), jnp.asarray(enc), _jnp(carry))
    want = jax_ckpt._flatten(jax.tree.map(np.asarray, {
        "p": want[0], "enc": want[1], "carry": want[2]}))

    p = {g: tree_map(lambda t: t.detach().clone().requires_grad_(True),
                     tp[g]) for g in ("attn", "dec")}
    e = _t(enc).requires_grad_(True)
    c = {k: _t(v).requires_grad_(True) for k, v in carry.items()}
    logits, new, _ = seq2seq.decode_step(
        p, mcfg, e, c, _t(tok).long(), enc_mask=_t(mask), compute_dtype=BF)
    out = (logits * _t(cot["logits"])).sum() + sum(
        (new[k] * _t(cot[k])).sum() for k in ("h", "c", "ht"))
    leaves = tree_leaves({"p": p, "enc": e, "carry": c})
    grads = torch.autograd.grad(out, leaves, allow_unused=True)
    it = iter(torch.zeros_like(x) if g is None else g
              for g, x in zip(grads, leaves))
    got = flatten(to_numpy(tree_map(lambda _: next(it),
                                    {"p": p, "enc": e, "carry": c})))
    return got, want


def _step_worst(got, want):
    assert sorted(got) == sorted(want)
    errs = {k: float(np.abs(np.asarray(got[k], np.float64) - want[k]).max())
            / (STEP_GRAD_TOL * max(float(np.abs(want[k]).max()), 1e-30))
            for k in want}
    k = max(errs, key=errs.get)
    return errs[k], k


STEP_VARIANTS = ("ln", "rnn_relu", "n_attn2", "no_feed", "block", "enc_mask")


@pytest.mark.parametrize("name", STEP_VARIANTS)
def test_decode_step_bf16_gradients_match_ast_tpu(name):
    """One bf16 decoder step's gradients (every decoder and attention
    parameter, the encoder states and the carry) against ast_tpu's
    ``decode_step`` at ``jnp.bfloat16`` under ``jax.grad`` within 1e-4 of
    each leaf's max |reference|: a single step sums few terms, so the
    two packages' f32 sums round alike and the cotangents' rounding at
    every cast (XLA's transposes, the port's ``rounded`` and bf16
    tensors) is held tightly, where the whole train step above cannot
    tell it from the rounding of two summation orders."""
    worst = _step_worst(*_step_grads(name))
    assert worst[0] <= 1, worst


@pytest.mark.parametrize("control", ["f32_step", "unrounded_backward"])
def test_decode_step_gradient_controls_fail(control, monkeypatch):
    """Controls for the test above: the decoder step at f32, or at bf16
    with every rounding point's backward passing the cotangent on
    unrounded (``scan_dot``'s operands and attention's states, query
    and softmax weights), moves some gradient of every variant past
    STEP_GRAD_TOL (the faithful step: within 0.45 of it)."""
    if control == "f32_step":
        monkeypatch.setattr(seq2seq, "scan_dot", lambda a, w, dt: a @ w)
        monkeypatch.setattr(attention, "_bf16", lambda x, on: x)
    else:
        from ast_tpu_torch.ops import bf16 as bf16_ops
        monkeypatch.setattr(bf16_ops, "rounded", _Unrounded.apply)
        monkeypatch.setattr(attention, "_bf16", lambda x, on: (
            _Unrounded.apply(x) if on else x))
    for name in STEP_VARIANTS:
        worst = _step_worst(*_step_grads(name))
        assert worst[0] > 1, (control, name, worst)
