"""chip_smoke.kernel_cost, the count behind each kernel's bound_ms: its
FLOPs equal the matrix-product FLOPs that torch's FlopCounterMode counts
on the kernel's plain version, within 2 %, at a small shape (K5 and K6
with the steps the plain decode ran, K3 with the logits of the steps
whose next input is sampled).  Elementwise work is excluded from both.
Also the decode step's weight packing (ops/fused_infer.pack_step_weights).
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke
from ast_tpu_torch.ops import fused_decoder as fd
from ast_tpu_torch.ops import fused_infer as fi
from ast_tpu_torch.ops import fused_lstm as fl

T, B, L, H_ENC = 6, 3, 3, 8            # encoder: D2 = 2 directions
T_DEC, H, E, A, V, U = 7, 16, 8, 16, 23, 5


def _t(rng, *shape, scale=0.5):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))


def _dec_weights(rng):
    return {"embed": _t(rng, V, E), "wx0": _t(rng, E + A, 4 * H),
            "wx_rest": _t(rng, L - 1, H, 4 * H), "wh": _t(rng, L, H, 4 * H),
            "b": _t(rng, L, 4 * H), "wa": _t(rng, H, H), "wa_b": _t(rng, H),
            "ctx_w": _t(rng, 2 * H, A), "ctx_b": _t(rng, A),
            "out_w": _t(rng, A, V), "out_b": _t(rng, V)}


def _counted(fn):
    """(matrix-product FLOPs torch counts in fn(), fn's result)."""
    with FlopCounterMode(display=False) as mode:
        out = fn()
    return mode.get_total_flops(), out


def _steps(monkeypatch):
    """Count the plain decoder steps run while the test goes on."""
    calls = [0]
    step = fi.decode_step_reference

    def counted(*args):
        calls[0] += 1
        return step(*args)

    monkeypatch.setattr(fi, "decode_step_reference", counted)
    return calls


def _plain_run(key, rng, monkeypatch):
    """(counted FLOPs, the dims kernel_cost takes) for kernel ``key``."""
    enc_dims = dict(T=T, D2=2, B=B, H=H_ENC, L=L)
    dec_dims = dict(T=T_DEC, B=B, H=H, L=L, E=E, A=A, V=V)
    if key in ("k1", "k1t", "k2"):
        args = (_t(rng, T, 2, B, 4 * H_ENC), _t(rng, L - 1, 2, H_ENC,
                                                4 * H_ENC),
                _t(rng, L, 2, H_ENC, 4 * H_ENC), _t(rng, L, 2, 4 * H_ENC))
        if key == "k1":
            return _counted(lambda: fl.stacked_lstm_reference(*args))[0], \
                enc_dims
        res = fl.stacked_lstm_reference(*args, True, 7, 0.3)
        if key == "k1t":
            return _counted(lambda: fl.stacked_lstm_reference(
                *args, True, 7, 0.3))[0], enc_dims
        d = [_t(rng, *x.shape) for x in res[:3]]
        return _counted(lambda: fl.encoder_backward_reference(
            res[3], res[4], args[1], args[2], *d, 7, 0.3))[0], enc_dims
    w = _dec_weights(rng)
    enc = _t(rng, B, T_DEC, H, scale=1.0)
    h0, c0 = _t(rng, L, B, H), _t(rng, L, B, H)
    if key in ("k3", "k4"):
        y_in = torch.from_numpy(rng.integers(4, V, (U, B)).astype(np.int32))
        coins = torch.tensor([1, 0, 1, 0, 0], dtype=torch.int32)
        n_logits = int((coins[1:] == 0).sum())
        dims = dict(dec_dims, U=U, n_logits=n_logits)
        args = (enc, h0, c0, w, y_in, coins, 11, 0.3, 0.3)
        flops, (ht, res) = _counted(
            lambda: fd.decoder_forward_reference(*args))
        if key == "k3":
            return flops, dims
        d_ht = _t(rng, *ht.shape)
        return _counted(lambda: fd.decoder_backward_reference(
            res, ht, enc, c0, w, d_ht, 11, 0.3, 0.3))[0], dims
    calls = _steps(monkeypatch)
    if key == "k5":
        flops, _ = _counted(lambda: fi.greedy_reference(enc, h0, c0, w, 9))
        return flops, dict(dec_dims, n=calls[0], stop=9)
    flops, _ = _counted(lambda: fi.beam_reference(enc, h0, c0, w, 3, 2, 9))
    return flops, dict(dec_dims, n=calls[0], stop=9, N=3)


@pytest.mark.parametrize("key", ["k1", "k1t", "k2", "k3", "k4", "k5",
                                 "k6"])
def test_kernel_cost_flops_match_flop_counter(key, monkeypatch):
    rng = np.random.default_rng(0)
    counted, dims = _plain_run(key, rng, monkeypatch)
    flops, nbytes = chip_smoke.kernel_cost(key, dims)
    assert counted > 0 and nbytes > 0
    assert abs(flops - counted) <= 0.02 * counted, (key, flops, counted)
    ms, by = chip_smoke.bound(flops, nbytes)
    assert by in ("operations", "bytes")
    assert ms == pytest.approx(max(flops / chip_smoke.PEAK_F32_FLOPS,
                                   nbytes / chip_smoke.PEAK_BYTES) * 1e3)


def test_pack_step_weights_layout():
    """Packed column q * 16 + u of cell block c is gate q of unit 16 c + u,
    each cell's [wx; wh] one layer after another; a linear's block c holds
    columns 64 c .. 64 c + 63, zero past the matrix."""
    w = _dec_weights(np.random.default_rng(1))
    p = fi.pack_step_weights(w)
    off = 0
    for l in range(L):
        cat = torch.cat([w["wx0"] if l == 0 else w["wx_rest"][l - 1],
                         w["wh"][l]])
        K = cat.shape[0]
        blk = p["cell"][off:off + K * 4 * H].view(H // 16, K, 4, 16)
        off += K * 4 * H
        for c in range(H // 16):
            for q in range(4):
                torch.testing.assert_close(
                    blk[c, :, q], cat[:, q * H + 16 * c:q * H + 16 * c + 16],
                    rtol=0, atol=0)
    assert off == p["cell"].numel()
    for k in ("wa", "ctx_w", "out_w"):
        K, N = w[k].shape
        flat = p[k].permute(1, 0, 2).reshape(K, -1)
        assert flat.shape[1] % 64 == 0 and flat.shape[1] - N < 64
        torch.testing.assert_close(flat[:, :N], w[k], rtol=0, atol=0)
        assert not flat[:, N:].any()


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("key", ["k1t", "k2", "k3", "k4"])
def test_kernel_cost_bytes_at_bf16_match_the_tensors(key):
    """The bf16 training rows' bytes (``wbytes`` 2): each tensor the
    kernel reads or writes once, at its own element size, counted from
    the plain bf16 versions' inputs and outputs -- bf16 matrices, encoder
    states and streams; f32 biases, embedding, x0_proj, ht, cotangents
    and final states; int32 ids and coins."""
    bf = torch.bfloat16
    rng = np.random.default_rng(2)
    if key in ("k1t", "k2"):
        x0, b = _t(rng, T, 2, B, 4 * H_ENC), _t(rng, L, 2, 4 * H_ENC)
        wxr = _t(rng, L - 1, 2, H_ENC, 4 * H_ENC).to(bf)
        wh = _t(rng, L, 2, H_ENC, 4 * H_ENC).to(bf)
        out = fl.stacked_lstm_reference(x0, wxr, wh, b, True, 7, 0.3)
        dims = dict(T=T, D2=2, B=B, H=H_ENC, L=L, wbytes=2)
        if key == "k1t":
            want = _nbytes(x0, wxr, wh, b, *out)
        else:
            cot = [_t(rng, *t.shape) for t in out[:3]]
            dz = fl.encoder_backward_reference(out[3], out[4], wxr, wh, *cot,
                                               7, 0.3)
            want = _nbytes(out[3], out[4], wxr, wh, *cot, dz)
        assert chip_smoke.kernel_cost(key, dims)[1] == want
        return
    w = {k: v.to(bf) for k, v in _dec_weights(rng).items()}
    mats = [w[k] for k in ("wx0", "wx_rest", "wh", "wa", "ctx_w", "out_w")]
    small = [w[k].float() for k in ("embed", "b", "wa_b", "ctx_b", "out_b")]
    enc = _t(rng, B, T_DEC, H, scale=1.0).to(bf)
    h0, c0 = _t(rng, L, B, H), _t(rng, L, B, H)
    y_in = torch.from_numpy(rng.integers(4, V, (U, B)).astype(np.int32))
    coins = torch.tensor([1, 0, 1, 0, 0], dtype=torch.int32)
    dims = dict(T=T_DEC, B=B, H=H, L=L, E=E, A=A, V=V, U=U, wbytes=2,
                n_logits=int((coins[1:] == 0).sum()))
    ht, res = fd.decoder_forward_reference(enc, h0, c0, w, y_in, coins, 11,
                                           0.3, 0.3)
    if key == "k3":
        want = _nbytes(enc, h0, c0, *mats, *small, y_in, coins, ht,
                       *res.values())
    else:
        d_ht = _t(rng, *ht.shape)
        g = fd.decoder_backward_reference(res, ht, enc, c0, w, d_ht, 11, 0.3,
                                          0.3)
        # K4 reads c0 rounded to bf16 and no out_w
        want = _nbytes(res["acts"], res["c_all"], c0.to(bf), res["alphas"],
                       ht, d_ht, enc, *mats[:5], *g.values())
    assert chip_smoke.kernel_cost(key, dims)[1] == want
