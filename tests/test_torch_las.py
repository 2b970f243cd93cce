"""LAS-6-1280's mechanisms in the port at a small size, against the plain
reference ``tests/las_reference.py`` (no JAX: the port's new keys have
no ``ast_tpu`` counterpart): a jointly stacked biLSTM listener,
encoder states wider than the decoder (``enc_units`` 64 a direction, so
He = 128 against H = 32), three input planes, SpecAugment's masks over
a plane's bins and label smoothing -- the loss, every gradient, three
AMSGrad steps and the teacher-forced logits; K1 / K2 once a layer and
K3-K6's plain versions at He != H against the scan path; and the
default keys' model unchanged.

Tolerances.  Port and reference compute the same float32 sums in other
orders (the listener's input products as one GEMM against a product a
step, the weight gradients as time-batched einsums against autograd's
per-step sums), which parts them by a few float32 roundings of each
value: relative gaps of 1e-7 to 1e-6 here.  The limits sit one to two
orders above (loss 2e-6 relative, a gradient leaf 1e-5 of its largest
entry, logits 1e-5 of their largest; the parameters after three steps
1e-4 of a leaf's largest step: a float32 parameter near 0.5 rounds at
3e-8, 1e-5 of a 3e-3 step, and AMSGrad divides each gradient element by
its own running RMS, which scales the gaps of the small ones up), and a
run at compute_dtype bfloat16 (rounding
at 2^-9) parts from the float32 reference by more than 100 times as
much and fails them (``test_bf16_run_fails_the_f32_tolerances``).
"""

import copy
import hashlib
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import las_reference as ref  # noqa: E402

from ast_tpu_torch.models import seq2seq  # noqa: E402
from ast_tpu_torch.ops import fused_decoder, fused_infer  # noqa: E402
from ast_tpu_torch.ops.bf16 import BF16  # noqa: E402
from ast_tpu_torch.ops.cnn import conv_out_dim  # noqa: E402
from ast_tpu_torch.ops.fused_lstm import stacked_lstm_reference  # noqa: E402
from ast_tpu_torch.ops.specaugment import (  # noqa: E402
    apply_spec_masks, draw_spec_masks)
from ast_tpu_torch.train.optimizer import (  # noqa: E402
    build_optimizer, tree_leaves)

LOSS_RTOL = 2e-6
GRAD_RTOL = 1e-5
STEP_RTOL = 1e-4
LOGIT_RTOL = 1e-5
SPEC = {"freq_masks": 2, "freq_width": 3, "time_masks": 2, "time_width": 5,
        "time_p": 1.0}
OPT = {"lr": 1e-3, "l2": 1e-4, "grad_clip": 2.0}
B, T, U, V, BINS = 4, 37, 9, 40, 8


def las_cfg(layers=2, units=64, hidden=32):
    return {
        "dropout": {"embed": 0.3, "rnn": 0.3, "out": 0},
        "rnn_config": {"bi_rnn": True, "enc_layers": layers,
                       "dec_layers": 2, "hidden_units": hidden,
                       "embedding_units": 32, "attn_units": 32,
                       "enc_units": units, "enc_stacking": "joint",
                       "dec_vocab_size": V},
        "cnn_config": {"bn": True, "plane_bins": BINS, "cnn_layers": [
            {"in_channels": 3, "out_channels": 4, "ksize": [3, 3],
             "stride": [2, 2], "pad": [1, 1]},
            {"in_channels": None, "out_channels": 4, "ksize": [3, 3],
             "stride": [2, 2], "pad": [1, 1]}]}}


def batch(seed=0):
    """X (B, T, 3 planes of BINS), the rows' true frames (the last row
    padding), y (B, U) with GO / EOS, PAD rows."""
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(B, T, 3 * BINS, generator=g)
    frame_len = torch.tensor([T, 30, 21, 0])
    for r, n in enumerate(frame_len.tolist()):
        X[r, n:] = 0
    y = torch.randint(4, V, (B, U), generator=g)
    y[:, 0], y[:, -1] = 1, 2
    y[3] = 0
    return X, frame_len, y


def flat(tree, prefix=""):
    """``path -> leaf`` of a parameter tree (the reference's layout)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}{k}/"))
    return out


def draws_pair(seed, X, frame_len, teach=0.8):
    port = seq2seq.make_draws(seed, X, U - 1, teach, 0, spec_cfg=SPEC,
                              frame_len=frame_len.numpy(), planes=3)
    mine = ref.make_draws(seed, B, BINS, U - 1, teach, SPEC, frame_len)
    return port, mine


def port_step(mcfg, params, state, X, y, draws, dtype=torch.float32):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = seq2seq.forward_loss(params, state, mcfg, X, y, 3.0, draws,
                                   label_smoothing=0.1, compute_dtype=dtype)
    grads = torch.autograd.grad(loss, leaves)
    names = {id(v): k for k, v in flat(params).items()}
    return float(loss.detach()), {names[id(p)]: g
                                  for p, g in zip(leaves, grads)}


def ref_step(mcfg, weights, X, y, draws):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items()}
    loss = ref.train_loss(leaves, mcfg, X, y, 3.0, draws, eps=0.1)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def grad_gaps(got, want):
    return {k: float((got[k] - want[k]).abs().max()
                     / want[k].abs().max().clamp_min(1e-30)) for k in want}


def test_draws_match_the_reference_recipe():
    X, frame_len, _ = batch()
    port, mine = draws_pair(99, X, frame_len)
    assert (port.enc_seed, port.dec_seed) == (mine.enc_seed, mine.dec_seed)
    assert [bool(c) for c in port.coins.tolist()] == mine.coins
    assert port.spec.planes == 3
    for (s, w), (s2, w2) in zip(port.spec.freq + port.spec.time,
                                mine.freq + mine.time):
        assert torch.equal(s[:, 0], s2) and torch.equal(w[:, 0], w2)
    # frequency masks lie inside a plane's bins; the padding row's time
    # masks are empty
    for s, w in port.spec.freq:
        assert int((s + w).max()) <= BINS
    for _, w in port.spec.time:
        assert int(w[3]) == 0


def test_plane_wise_frequency_masks_zero_the_same_bins_of_every_plane():
    X = torch.ones(B, T, 3 * BINS)
    masks = draw_spec_masks(torch.Generator().manual_seed(5), X.shape,
                            dict(SPEC, freq_width=4, time_masks=0), X=X,
                            planes=3)
    out = apply_spec_masks(X, masks).view(B, T, 3, BINS)
    assert torch.equal(out[:, :, 0], out[:, :, 1])
    assert torch.equal(out[:, :, 0], out[:, :, 2])
    assert (out == 0).any()


@pytest.mark.parametrize("seed", [99, 7])
def test_loss_and_every_gradient_match_the_reference(seed):
    mcfg = las_cfg()
    params, state = seq2seq.init_model(mcfg, seed=3)
    weights = {k: v.detach().clone() for k, v in flat(params).items()}
    X, frame_len, y = batch(seed)
    port_d, ref_d = draws_pair(seed, X, frame_len)
    loss, grads = port_step(mcfg, params, state, X, y, port_d)
    want_loss, want = ref_step(mcfg, weights, X, y, ref_d)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    gaps = grad_gaps(grads, want)
    assert max(gaps.values()) <= GRAD_RTOL, gaps


def test_bf16_run_fails_the_f32_tolerances():
    mcfg = las_cfg()
    params, state = seq2seq.init_model(mcfg, seed=3)
    weights = {k: v.detach().clone() for k, v in flat(params).items()}
    X, frame_len, y = batch(99)
    port_d, ref_d = draws_pair(99, X, frame_len)
    loss, grads = port_step(mcfg, params, state, X, y, port_d, BF16)
    want_loss, want = ref_step(mcfg, weights, X, y, ref_d)
    gaps = grad_gaps(grads, want)
    assert (abs(loss - want_loss) > LOSS_RTOL * abs(want_loss)
            or max(gaps.values()) > GRAD_RTOL)
    assert max(gaps.values()) > 100 * GRAD_RTOL


def test_three_amsgrad_steps_match_the_reference():
    mcfg = las_cfg()
    params, state = seq2seq.init_model(mcfg, seed=3)
    weights = {k: v.detach().clone() for k, v in flat(params).items()}
    p0 = {k: v.clone() for k, v in weights.items()}
    opt, opt_state = build_optimizer(OPT, params)
    ref_opt = ref.AMSGrad(OPT, weights)
    for k, seed in enumerate((11, 12, 13)):
        X, frame_len, y = batch(seed)
        port_d, ref_d = draws_pair(seed, X, frame_len)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, state = seq2seq.forward_loss(params, state, mcfg, X, y, 3.0,
                                           port_d, label_smoothing=0.1)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            opt.apply_(grads, opt_state, leaves)
        _, g = ref_step(mcfg, weights, X, y, ref_d)
        with torch.no_grad():
            ref_opt.step(weights, g)
    got = flat(params)
    gaps = {}
    for name, want in weights.items():
        step = want - p0[name]
        gaps[name] = float(torch.linalg.vector_norm(
            got[name].detach() - p0[name] - step)
            / torch.linalg.vector_norm(step))
    assert max(gaps.values()) <= STEP_RTOL, gaps


def test_teacher_forced_logits_match_the_reference():
    mcfg = las_cfg()
    params, state = seq2seq.init_model(mcfg, seed=3)
    weights = {k: v.detach().clone() for k, v in flat(params).items()}
    X, _, y = batch(4)
    with torch.no_grad():
        enc, h0, c0 = seq2seq.encode(params, state, mcfg, X)
        w = seq2seq.pack_decoder_weights(params)
        y_in = y.t()[:-1].to(torch.int32).contiguous()
        ht, _ = fused_decoder.decoder_forward(
            enc, h0, c0, w, y_in, torch.ones(U - 1, dtype=torch.int32), 0,
            0.0, 0.0)
        got = ht @ w["out_w"] + w["out_b"]
        want = ref.forced_logits(weights, mcfg, X, y)
    assert enc.shape[-1] == 128 and h0.shape[-1] == 32
    assert float((got - want).abs().max()) <= (
        LOGIT_RTOL * float(want.abs().max()))


def test_joint_layers_on_k1_k2_match_the_scan_recurrence():
    """K1 train / K2 once a layer (their plain versions, through
    seq2seq.JointLayer) against the same layer on the scan path
    (stacked_lstm_reference under autograd): outputs and gradients."""
    mcfg = las_cfg()
    params, _ = seq2seq.init_model(mcfg, seed=3)
    lp = seq2seq.direction_stacked(params["enc"]["lstm"])[1]
    g = torch.Generator().manual_seed(2)
    seq = torch.randn(10, B, 128, generator=g)
    d_y = torch.randn(10, B, 128, generator=g)

    def grads(y):
        return torch.autograd.grad((y * d_y).sum(),
                                   [x, lp["wx"], lp["wh"], lp["b"]])

    x = seq.clone().requires_grad_(True)
    for t in (lp["wx"], lp["wh"], lp["b"]):
        t.requires_grad_(True)
    y_k, _, _ = seq2seq.JointLayer.apply(x, lp["wx"], lp["wh"], lp["b"], 21,
                                         0.3, True, torch.float32)
    g_k = grads(y_k)
    xs = torch.stack([x, x.flip(0)], dim=1)
    proj = torch.matmul(xs, lp["wx"])
    wh = lp["wh"][None]
    outs = stacked_lstm_reference(proj, wh.new_zeros((0,) + wh.shape[1:]),
                                  wh, lp["b"][None], True, 21, 0.3)[0]
    y_s = torch.cat([outs[:, 0], outs[:, 1].flip(0)], dim=-1)
    g_s = grads(y_s)
    assert torch.allclose(y_k, y_s, rtol=1e-6, atol=1e-7)
    for a, b in zip(g_k, g_s):
        assert float((a - b).abs().max()) <= GRAD_RTOL * float(
            b.abs().max())


def _decoder_inputs(seed=6):
    mcfg = las_cfg()
    params, state = seq2seq.init_model(mcfg, seed=seed)
    X, _, y = batch(seed)
    with torch.no_grad():
        enc, h0, c0 = seq2seq.encode(params, state, mcfg, X)
    return mcfg, params, enc, h0, c0, y


def test_k3_k4_plain_versions_at_wide_encoder_match_the_scan_loss():
    mcfg, params, enc, h0, c0, y = _decoder_inputs()
    X = batch(6)[0]
    draws = seq2seq.make_draws(5, X, U - 1, 0.6, 0)
    leaves = tree_leaves({"attn": params["attn"], "dec": params["dec"]})
    for p in leaves:
        p.requires_grad_(True)
    enc = enc.clone().requires_grad_(True)

    def run(fn):
        loss = fn()
        return [float(loss)] + list(torch.autograd.grad(loss,
                                                        leaves + [enc]))
    fused = run(lambda: _fused_loss(params, mcfg, enc, h0, c0, y, draws))
    scan = run(lambda: seq2seq.scan_decoder_loss(
        params, mcfg, enc, h0, c0, y, 3.0, draws, 0.1))
    assert abs(fused[0] - scan[0]) <= LOSS_RTOL * abs(scan[0])
    for a, b in zip(fused[1:], scan[1:]):
        assert float((a - b).abs().max()) <= GRAD_RTOL * max(
            float(b.abs().max()), 1e-30)


def _fused_loss(params, mcfg, enc, h0, c0, y, draws):
    """K3 / K4's route of forward_loss's decoder (plain versions)."""
    drop = mcfg["dropout"]
    w = seq2seq.pack_decoder_weights(params)
    y_in = y.t()[:-1].to(torch.int32).contiguous()
    ht, _ = fused_decoder.FusedDecoder.apply(
        enc, h0, c0, *(w[k] for k in fused_decoder.W_NAMES), y_in,
        draws.coins, draws.dec_seed, float(drop["embed"]),
        float(drop["rnn"]))
    return seq2seq.sequence_loss(ht, params["dec"]["out_w"],
                                 params["dec"]["out_b"], y.t()[1:], 3.0,
                                 label_smoothing=0.1)


def test_k5_k6_plain_versions_at_wide_encoder_match_the_scan_step():
    mcfg, params, enc, h0, c0, _ = _decoder_inputs()
    w = seq2seq.decode_weights(params, mcfg=mcfg)
    step = seq2seq.plain_step(params, mcfg)
    with torch.no_grad():
        g_k = fused_infer.greedy_reference(enc, h0, c0, w, 12)
        g_s = fused_infer.greedy_reference(enc, h0, c0, w, 12, step)
        b_k = fused_infer.beam_reference(enc, h0, c0, w, 3, 3, 10)
        b_s = fused_infer.beam_reference(enc, h0, c0, w, 3, 3, 10, step=step)
    assert torch.equal(g_k, g_s)
    assert torch.equal(b_k[0], b_s[0])
    assert torch.allclose(b_k[1], b_s[1], rtol=1e-5, atol=1e-5)


def test_joint_model_decodes_without_an_encoder_pack():
    """A jointly stacked model's decode weights, made with its config,
    carry no direction-stacked encoder pack, and greedy decoding with
    them gives the tokens that decoding without them gives."""
    mcfg = las_cfg()
    params, state = seq2seq.init_model(mcfg, seed=2)
    w = seq2seq.decode_weights(params, mcfg=mcfg)
    assert w["enc"] is None
    assert seq2seq.encoder_weights(params, mcfg=mcfg) is None
    X, _, _ = batch(4)
    with torch.no_grad():
        got = seq2seq.predict_greedy(params, state, mcfg, X, 8, w=w)
        want = seq2seq.predict_greedy(params, state, mcfg, X, 8)
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])


def test_wide_encoder_shape_gates():
    assert fused_decoder.train_shapes_ok(875, 1280, 512, 1280, 2560)
    assert not fused_decoder.train_shapes_ok(100, 32, 32, 32, 48)
    assert fused_infer.decode_shapes_ok(64, 875, 1280, 512, 1280, 8, 8, 2560)
    assert not fused_infer.decode_shapes_ok(64, 875, 1280, 512, 1280, 32, 8,
                                            2560)
    mcfg = las_cfg()
    assert seq2seq.enc_width(mcfg) == 128
    assert conv_out_dim(mcfg["cnn_config"]) == 4 * 2


def test_routing_sends_las_at_full_width_to_the_kernels():
    """LAS-6-1280's bf16 shapes pass every kernel's gate on a CUDA
    device at every bucket of its cell (T' up to 875)."""
    mcfg = las_cfg(layers=6, units=1280, hidden=1280)
    mcfg["rnn_config"].update(embedding_units=512, attn_units=1280,
                              dec_vocab_size=16384)
    for Tp in (50, 875):
        assert seq2seq.use_fused_encoder(mcfg, "cuda")
        assert seq2seq.use_fused_decoder(mcfg, "cuda", T=Tp)


def _es_en_cfg(explicit):
    cfg = {"dropout": {"embed": 0.3, "rnn": 0.3, "out": 0},
           "rnn_config": {"bi_rnn": True, "enc_layers": 2, "dec_layers": 2,
                          "hidden_units": 64, "embedding_units": 32,
                          "attn_units": 64, "dec_vocab_size": V},
           "cnn_config": {"bn": True, "cnn_layers": [
               {"in_channels": None, "out_channels": 16, "ksize": [9, 13],
                "stride": [2, 13], "pad": [4, 0]},
               {"in_channels": None, "out_channels": 32, "ksize": [9, 1],
                "stride": [2, 1], "pad": [4, 0]}]}}
    if explicit:
        cfg["rnn_config"].update(enc_units=32, enc_stacking="direction")
        cfg["cnn_config"]["cnn_layers"][0]["in_channels"] = 1
    return cfg


def _digest(params):
    h = hashlib.sha256()
    for k, v in sorted(flat(params).items()):
        h.update(k.encode())
        h.update(v.detach().numpy().tobytes())
    return h.hexdigest()


# sha256 of the es_en-shaped model of _es_en_cfg(False) at seed 5, made
# by the port before the optional keys existed (numpy draws only, so the
# same on any host)
ES_EN_DIGEST = (
    "9f7bb79b64be1ade9c0a403e521a4543054e3a9bd4bf258ee979beb1590e2faa")


def test_default_keys_leave_the_es_en_model_bit_for_bit():
    base, state = seq2seq.init_model(_es_en_cfg(False), seed=5)
    expl, state2 = seq2seq.init_model(_es_en_cfg(True), seed=5)
    assert _digest(base) == _digest(expl) == ES_EN_DIGEST
    g = torch.Generator().manual_seed(1)
    X = torch.randn(B, 40, 13, generator=g)
    y = torch.randint(4, V, (B, U), generator=g)
    y[:, 0], y[:, -1] = 1, 2
    draws = seq2seq.make_draws(3, X, U - 1, 0.8, 0.25)
    losses = []
    for cfg, params, st in ((_es_en_cfg(False), base, state),
                            (_es_en_cfg(True), expl, state2)):
        loss, _ = seq2seq.forward_loss(params, st, cfg, X, y, 4.0,
                                       copy.copy(draws))
        losses.append(float(loss))
    assert losses[0] == losses[1]
    assert np.isfinite(losses[0])
