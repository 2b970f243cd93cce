"""K1 and K2: the fused stacked-(bi)LSTM encoder recurrence and its
backward.

The counterparts of ``ast_tpu/ops/fused_lstm.py``: ``fused_stacked_lstm``
(K1, ``_fwd_kernel``, in eval and train mode) and the reverse-time pass
of its custom VJP (K2, ``_bwd_kernel``).  A CUDA tensor runs the hand
kernels (``kernels/csrc/k1_encoder.cu``, ``k2_encoder_bwd.cu``); a CPU
tensor runs the plain versions :func:`stacked_lstm_reference` and
:func:`encoder_backward_reference`, written from the JAX kernel bodies'
math.  :class:`FusedStackedLSTM` is the differentiable call: its
backward is K2 for ``dz``, then the weight gradients as time-batched
GEMMs, as ``_bwd_rule`` does.

On the card a cell (step t, layer l) runs as one product of a *wave*:
the cells of equal t + l do not depend on one another, so
:func:`wave_schedule` orders the T * L cells into T + L - 1 waves and a
wave is one launch (K1) or two (K2).  The products read the weights in
the layouts of :func:`pack_encoder_step_weights` and
:func:`pack_encoder_backward_weights`, made once per wrapper call (K1 in
eval mode also takes the first from a caller that keeps it per model).

Layout (D2 directions, H units per direction):
  x0_proj (T, D2, B, 4H), wx_rest (L-1, D2, H, 4H), wh (L, D2, H, 4H),
  b (L, D2, 4H)  ->  outs (T, D2, B, H), h_fin / c_fin (L, D2, B, H).
Train mode adds hash dropout at ``rate`` on every layer's output (mask
seed ``seed + t*L + l`` over (D2, B, H)) and the residual streams
acts (T, L, D2, B, 4H) ``[i|f|g|o]``, c_all, h_pre (pre-dropout) and
x_drop (post-dropout) (T, L, D2, B, H).

bfloat16 (eval mode; ``extras.compute_dtype: "bfloat16"``): ``wx_rest``
and ``wh`` in bf16 select it.  As in ``ast_tpu``'s kernel, each layer's
input and its h are rounded to bf16 where a product reads them and the
products accumulate in f32; ``b`` (not cast), ``x0_proj``, the gates,
the state and the outputs stay f32.  A CUDA tensor launches K1's bf16
entry (``k1_encoder_forward_bf16``) or raises.
"""

import ctypes
import functools

import numpy as np
import torch

from ast_tpu_torch.kernels import build
from ast_tpu_torch.ops.bf16 import BF16, rounded
from ast_tpu_torch.ops.dropout import drop_mask, drop_threshold
from ast_tpu_torch.ops.fused_infer import put_transposed
from ast_tpu_torch.ops.lstm import (
    layernorm, lstm_gate_acts, lstm_gates, lstm_gates_backward)

# the input-axis tile of the kernels' products: H must be a multiple
ENCODER_TILE = 32


def pack_encoder_weights(enc_layers):
    """Direction-stacked per-layer dicts -> (wx_rest, wh, b) stacks."""
    wh = torch.stack([l["wh"] for l in enc_layers])
    b = torch.stack([l["b"] for l in enc_layers])
    if len(enc_layers) > 1:
        wx_rest = torch.stack([l["wx"] for l in enc_layers[1:]])
    else:
        wx_rest = wh.new_zeros((0,) + tuple(wh.shape[1:]))
    return wx_rest.contiguous(), wh.contiguous(), b.contiguous()


@functools.lru_cache(maxsize=64)
def wave_schedule(T, L, reverse=False):
    """The order in which the kernels run the T * L cells: (cells, starts)
    as int32 arrays, cells (T * L, 2) of (t, l) and wave i the rows
    starts[i] .. starts[i + 1] - 1, by ascending layer.  Forward, wave w
    holds the cells with t + l = w: cell (t, l) reads the state of
    (t - 1, l) and the output of (t, l - 1), both of wave w - 1.  Reverse
    (K2), wave v holds those with (T - 1 - t) + (L - 1 - l) = v: the cell
    backward of (t, l) reads the products of (t + 1, l) and (t, l + 1)."""
    cells, starts = [], [0]
    for w in range(T + L - 1):
        for l in range(L):
            t = T - 1 - (w - (L - 1 - l)) if reverse else w - l
            if 0 <= t < T:
                cells.append((t, l))
        starts.append(len(cells))
    out = (np.asarray(cells, np.int32).reshape(-1, 2),
           np.asarray(starts, np.int32))
    for a in out:
        a.flags.writeable = False       # shared by every caller
    return out


def _schedule_args(T, L, reverse=False):
    """The schedule as the entry points take it: two host pointers and
    the number of waves (the arrays live in wave_schedule's cache)."""
    cells, starts = wave_schedule(T, L, reverse)
    return (cells.ctypes.data_as(ctypes.c_void_p),
            starts.ctypes.data_as(ctypes.c_void_p), len(starts) - 1)


def pack_encoder_step_weights(wx_rest, wh):
    """K1's weights as its products read them: per (layer, direction) the
    cell's [wx; wh] (K, 4H) -- K = H for layer 0, whose input arrives
    projected, 2H above -- as (H / 16 column blocks, K, 64), packed column
    q * 16 + u of block c being gate q of unit 16 c + u, so a block holds
    all four gates of its units and a tile of 32 input rows is one
    contiguous 8 KB (4 KB in bf16: the buffer takes ``wh``'s dtype);
    layer 0's directions first, then (layer, direction) above, in one
    flat buffer.  Three strided copies."""
    L, D2, H, _ = wh.shape
    flat = wh.new_empty(((2 * L - 1) * D2 * H * 4 * H,))
    n0 = D2 * H * 4 * H

    def by_unit(w):        # (..., K, 4H) -> (..., H / 16, K, 4, 16)
        return w.unflatten(-1, (4, H // 16, 16)).movedim(-2, -4)

    flat[:n0].view(D2, H // 16, H, 4, 16).copy_(by_unit(wh[0]))
    if L > 1:
        rest = flat[n0:].view(L - 1, D2, H // 16, 2 * H, 4, 16)
        rest[..., :H, :, :].copy_(by_unit(wx_rest))
        rest[..., H:, :, :].copy_(by_unit(wh[1:]))
    return flat


def pack_encoder_backward_weights(wx_rest, wh):
    """K2's weights: per (layer, direction) the transposed [wh^T | wx^T]
    (4H, N) -- N = H for layer 0, 2H above -- as (ceil(N / 64) column
    blocks, 4H, 64) with zero columns past N, so that dz @ it is the
    layer's [dh carry | dx]; layer 0's directions first, then (layer,
    direction) above, in one flat buffer.  Three strided copies when H is
    a multiple of 64."""
    L, D2, H, H4 = wh.shape
    b0, b1 = -(-H // 64), -(-2 * H // 64)
    n0 = D2 * b0 * H4 * 64
    flat = (torch.zeros if H % 64 else torch.empty)(
        (n0 + (L - 1) * D2 * b1 * H4 * 64,), dtype=wh.dtype, device=wh.device)
    put_transposed(flat[:n0].view(D2, b0, H4, 64), 0, wh[0])
    if L > 1:
        rest = flat[n0:].view(L - 1, D2, b1, H4, 64)
        put_transposed(rest, 0, wh[1:])
        put_transposed(rest, H, wx_rest)
    return flat


def _inv_keep(rate):
    return 1.0 / (1.0 - rate) if rate > 0 else 1.0


def _enc_mask(rate, seed, t, l, L, D2, B, H, device):
    return drop_mask((D2, B, H), rate, seed + t * L + l, row_axis=1,
                     global_rows=B, device=device)


def _transform(x, ln, l, relu):
    """The scan encoder's output transforms of layer ``l``: LayerNorm
    (``ln[l]`` = (g, b), each (D2, H)), then ReLU."""
    if ln is not None:
        g, bias = ln[l]
        x = layernorm(x, g[:, None, :], bias[:, None, :])
    return torch.relu(x) if relu else x


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def stacked_lstm_reference(x0_proj, wx_rest, wh, b, train=False, seed=0,
                           rate=0.0, ln=None, relu=False):
    """Plain PyTorch recurrence; same contract as
    :func:`fused_stacked_lstm` (eval) and :func:`fused_stacked_lstm_train`
    (``train=True``: also returns acts, c_all, h_pre, x_drop).

    It is also ``ast_tpu``'s scan encoder, which runs the variants K1
    does not take: ``ln`` (one ``(g, b)`` pair of (D2, H) a layer) and
    ``relu`` transform each layer's output after its dropout, in that
    order, and what the layer above and ``outs`` receive is the
    transformed output; the carried state stays the cell's own.

    With ``wx_rest`` / ``wh`` in bf16 (eval), the rounding points of the
    module docstring."""
    T, D2, B, H4 = x0_proj.shape
    H = H4 // 4
    L = wh.shape[0]
    if wh.dtype == BF16:
        wx_rest, wh = wx_rest.float(), wh.float()

        def bmm(v, w):
            return torch.bmm(rounded(v), w)
    else:
        bmm = torch.bmm
    h = [x0_proj.new_zeros((D2, B, H))] * L
    c = [x0_proj.new_zeros((D2, B, H))] * L
    outs, acts, c_all, h_pre, x_drop = [], [], [], [], []
    for t in range(T):
        x = None
        res = ([], [], [], [])
        for l in range(L):
            z = x0_proj[t] if l == 0 else bmm(x, wx_rest[l - 1])
            z = z + bmm(h[l], wh[l]) + b[l][:, None, :]
            if not train:
                h[l], c[l] = lstm_gates(z, c[l], H)
                x = _transform(h[l], ln, l, relu)
                continue
            a, h[l], c[l] = lstm_gate_acts(z, c[l], H)
            x = h[l]
            if rate > 0:
                keep = _enc_mask(rate, seed, t, l, L, D2, B, H, z.device)
                x = torch.where(keep, x * _inv_keep(rate), 0.0)
            x = _transform(x, ln, l, relu)
            for r, v in zip(res, (a, c[l], h[l], x)):
                r.append(v)
        outs.append(x)
        if train:
            for r, v in zip((acts, c_all, h_pre, x_drop), res):
                r.append(torch.stack(v))
    out = (torch.stack(outs), torch.stack(h), torch.stack(c))
    if not train:
        return out
    return out + tuple(torch.stack(r) for r in (acts, c_all, h_pre, x_drop))


def encoder_backward_reference(acts, c_all, wx_rest, wh, douts, dh_fin,
                               dc_fin, seed, rate):
    """Plain version of K2: the reverse-time pass giving ``dz`` (T, L,
    D2, B, 4H) at every cell's pre-activations, from the residuals, the
    cotangents of (outs, h_fin, c_fin) and the dropout ``rate`` the
    forward ran with (the masks are regenerated from ``seed``)."""
    T, L, D2, B, H4 = acts.shape
    H = H4 // 4
    dh, dc = list(dh_fin), list(dc_fin)
    dz_all = []
    for t in reversed(range(T)):
        dz_t = [None] * L
        cons = douts[t]
        for l in reversed(range(L)):
            if rate > 0:
                keep = _enc_mask(rate, seed, t, l, L, D2, B, H, acts.device)
                cons = torch.where(keep, cons * _inv_keep(rate), 0.0)
            c_prev = c_all[t - 1, l] if t > 0 else torch.zeros_like(dc[l])
            dz, dc[l] = lstm_gates_backward(acts[t, l], c_all[t, l], c_prev,
                                            dh[l] + cons, dc[l])
            dz_t[l] = dz
            dh[l] = torch.bmm(dz, wh[l].transpose(1, 2))
            if l > 0:
                cons = torch.bmm(dz, wx_rest[l - 1].transpose(1, 2))
        dz_all.append(torch.stack(dz_t))
    return torch.stack(dz_all[::-1])


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_weights(x0_proj, wx_rest, wh, b, dtype=torch.float32):
    T, D2, B, H4 = x0_proj.shape
    H = H4 // 4
    L = wh.shape[0]
    build.check_tensor(x0_proj, "x0_proj", (T, D2, B, 4 * H))
    build.check_tensor(wx_rest, "wx_rest", (L - 1, D2, H, 4 * H), dtype)
    build.check_tensor(wh, "wh", (L, D2, H, 4 * H), dtype)
    build.check_tensor(b, "b", (L, D2, 4 * H))
    check_encoder_shapes(H)
    return T, L, D2, B, H


def check_encoder_shapes(H):
    """Raise unless the encoder kernels take H units a direction: their
    products walk the input axis in ENCODER_TILE-row tiles."""
    if H % ENCODER_TILE:
        raise ValueError(f"encoder kernels take H that is a multiple of "
                         f"{ENCODER_TILE} (got {H})")


def fused_stacked_lstm(x0_proj, wx_rest, wh, b, packed=None):
    """Encoder recurrence, eval mode.  Returns (outs, h_fin, c_fin).
    ``packed``: :func:`pack_encoder_step_weights` of the weights, for a
    caller that keeps it over many calls; made here when not given.
    ``wx_rest`` / ``wh`` (and ``packed``) in bf16 run the bf16 mode; the
    f32 entry counts in ``launches``, the bf16 one in
    ``launches_bf16``."""
    if not x0_proj.is_cuda:
        return stacked_lstm_reference(x0_proj, wx_rest, wh, b)
    bf16 = wh.dtype == BF16
    wdt = BF16 if bf16 else torch.float32
    T, L, D2, B, H = _check_weights(x0_proj, wx_rest, wh, b, wdt)
    dev = x0_proj.device
    if packed is None:
        w = pack_encoder_step_weights(wx_rest, wh)
    else:
        w = packed
        build.check_tensor(w, "packed", ((2 * L - 1) * D2 * H * 4 * H,),
                           wdt)
    outs = torch.empty((T, D2, B, H), device=dev)
    # layer l's h at step t in slot t % 2; both start as the zero state
    hbuf = torch.zeros((2, L, D2, B, H), device=dev)
    c = torch.zeros((L, D2, B, H), device=dev)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if bf16:
        name, entry = "k1_encoder_forward_bf16", lib.k1_encoder_forward_bf16
        fused_stacked_lstm.launches_bf16 += 1
    else:
        name, entry = "k1_encoder_forward", lib.k1_encoder_forward
        fused_stacked_lstm.launches += 1
    build.check_launch(name, entry(
        x0_proj.data_ptr(), w.data_ptr(), b.data_ptr(), outs.data_ptr(),
        hbuf.data_ptr(), c.data_ptr(), *_schedule_args(T, L),
        L, D2, B, H, stream))
    return outs, hbuf[(T - 1) % 2], c


fused_stacked_lstm.launches = 0
fused_stacked_lstm.launches_bf16 = 0


def fused_stacked_lstm_train(x0_proj, wx_rest, wh, b, seed, rate):
    """Encoder recurrence, train mode: hash dropout at ``rate`` (0 keeps
    every element) and the residual streams.  Returns (outs, h_fin,
    c_fin, acts, c_all, h_pre, x_drop)."""
    if not x0_proj.is_cuda:
        return stacked_lstm_reference(x0_proj, wx_rest, wh, b, True, seed,
                                      rate)
    T, L, D2, B, H = _check_weights(x0_proj, wx_rest, wh, b)
    dev = x0_proj.device
    w = pack_encoder_step_weights(wx_rest, wh)
    outs = torch.empty((T, D2, B, H), device=dev)
    acts = torch.empty((T, L, D2, B, 4 * H), device=dev)
    c_all, h_pre, x_drop = (torch.empty((T, L, D2, B, H), device=dev)
                            for _ in range(3))
    zero = torch.zeros((D2, B, H), device=dev)      # h and c before t = 0
    lib = build.library()
    fused_stacked_lstm_train.launches += 1
    build.check_launch("k1_encoder_forward_train",
                       lib.k1_encoder_forward_train(
        x0_proj.data_ptr(), w.data_ptr(), b.data_ptr(),
        outs.data_ptr(), acts.data_ptr(), c_all.data_ptr(),
        h_pre.data_ptr(), x_drop.data_ptr(), zero.data_ptr(),
        *_schedule_args(T, L), L, D2, B, H, seed & 0xFFFFFFFF,
        drop_threshold(rate), _inv_keep(rate),
        torch.cuda.current_stream(dev).cuda_stream))
    return (outs, h_pre[-1].clone(), c_all[-1].clone(), acts, c_all, h_pre,
            x_drop)


fused_stacked_lstm_train.launches = 0


def encoder_backward(acts, c_all, wx_rest, wh, douts, dh_fin, dc_fin, seed,
                     rate):
    """K2: ``dz`` (T, L, D2, B, 4H); see :func:`encoder_backward_reference`."""
    if not acts.is_cuda:
        return encoder_backward_reference(acts, c_all, wx_rest, wh, douts,
                                          dh_fin, dc_fin, seed, rate)
    T, L, D2, B, H4 = acts.shape
    H = H4 // 4
    build.check_tensor(acts, "acts", (T, L, D2, B, 4 * H))
    build.check_tensor(c_all, "c_all", (T, L, D2, B, H))
    build.check_tensor(wx_rest, "wx_rest", (L - 1, D2, H, 4 * H))
    build.check_tensor(wh, "wh", (L, D2, H, 4 * H))
    build.check_tensor(douts, "douts", (T, D2, B, H))
    build.check_tensor(dh_fin, "dh_fin", (L, D2, B, H))
    build.check_tensor(dc_fin, "dc_fin", (L, D2, B, H))
    check_encoder_shapes(H)
    dev = acts.device
    w_t = pack_encoder_backward_weights(wx_rest, wh)
    # per layer (D2, B, H or 2H): [dh carry | dx for the layer below]; the
    # carry starts as dh_fin, dx is written before it is read
    n0 = D2 * B * H
    carry = torch.empty((n0 + (L - 1) * D2 * B * 2 * H,), device=dev)
    carry[:n0].view(D2, B, H).copy_(dh_fin[0])
    if L > 1:
        carry[n0:].view(L - 1, D2, B, 2 * H)[..., :H].copy_(dh_fin[1:])
    dc = dc_fin.clone()
    dz = torch.empty((T, L, D2, B, 4 * H), device=dev)
    lib = build.library()
    encoder_backward.launches += 1
    build.check_launch("k2_encoder_backward", lib.k2_encoder_backward(
        acts.data_ptr(), c_all.data_ptr(), w_t.data_ptr(), douts.data_ptr(),
        carry.data_ptr(), dc.data_ptr(), dz.data_ptr(),
        *_schedule_args(T, L, True), L, D2, B, H, seed & 0xFFFFFFFF,
        drop_threshold(rate), _inv_keep(rate),
        torch.cuda.current_stream(dev).cuda_stream))
    return dz


encoder_backward.launches = 0


# ---------------------------------------------------------------------------
# differentiable call
# ---------------------------------------------------------------------------

def _grad_or_zeros(g, like):
    return torch.zeros_like(like) if g is None else g.contiguous()


class FusedStackedLSTM(torch.autograd.Function):
    """Differentiable fused encoder (``ast_tpu``'s ``fused_stacked_lstm``
    custom VJP).  ``apply(x0_proj, wx_rest, wh, b, seed, train, rate)``
    -> (outs, h_fin, c_fin).  When gradients are needed in eval mode the
    forward still keeps its residuals, with rate 0."""

    @staticmethod
    def forward(ctx, x0_proj, wx_rest, wh, b, seed, train, rate):
        rate = float(rate) if train else 0.0
        if not train and not any(ctx.needs_input_grad[:4]):
            return fused_stacked_lstm(x0_proj, wx_rest, wh, b)
        (outs, h_fin, c_fin, acts, c_all, h_pre,
         x_drop) = fused_stacked_lstm_train(x0_proj, wx_rest, wh, b, seed,
                                            rate)
        ctx.save_for_backward(wx_rest, wh, acts, c_all, h_pre, x_drop)
        ctx.seed, ctx.rate = seed, rate
        return outs, h_fin, c_fin

    @staticmethod
    def backward(ctx, douts, dh_fin, dc_fin):
        wx_rest, wh, acts, c_all, h_pre, x_drop = ctx.saved_tensors
        dz = encoder_backward(
            acts, c_all, wx_rest, wh, _grad_or_zeros(douts, x_drop[:, -1]),
            _grad_or_zeros(dh_fin, h_pre[-1]),
            _grad_or_zeros(dc_fin, c_all[-1]), ctx.seed, ctx.rate)
        # weight gradients as time-batched GEMMs
        h_prev = torch.cat([torch.zeros_like(h_pre[:1]), h_pre[:-1]])
        dwh = torch.einsum("tldbh,tldbk->ldhk", h_prev, dz)
        dwx = torch.einsum("tldbh,tldbk->ldhk", x_drop[:, :-1], dz[:, 1:])
        return (dz[:, 0], dwx, dwh, dz.sum(dim=(0, 3)), None, None, None)
