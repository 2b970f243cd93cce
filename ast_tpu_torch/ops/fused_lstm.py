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
x_drop (post-dropout) (T, L, D2, B, H).  The train-mode calls also take
``row_offset`` / ``global_rows`` (``ast_tpu``'s arguments): the B rows
are rows ``row_offset .. row_offset + B - 1`` of a global batch of
``global_rows`` and each mask is the global batch's (D2, global_rows, H)
mask's rows, so that a data-parallel rank's shard (``ast_tpu_torch.
parallel``) draws what one process over the whole batch draws.  The
defaults, 0 and B, are a whole batch.

bfloat16 (``extras.compute_dtype: "bfloat16"``): ``wx_rest`` and ``wh``
in bf16 select it.  As in ``ast_tpu``'s kernels, each layer's input and
its h are rounded to bf16 where a product reads them and the products
accumulate in f32; ``b`` (not cast), ``x0_proj``, the gates, the state,
``outs``, ``h_fin`` and ``c_fin`` stay f32.  In train mode the residual
streams are stored in bf16 (``res_dtype = wh.dtype``; x_drop is
``round(h * inv_keep)``); K2 reads them widened, computes ``dz`` in f32,
stores it in bf16 and feeds its carries the rounded ``dz``.  The weight
gradients are f32 sums over the bf16 streams and come back f32, not
rounded (``FusedStackedLSTM``'s ``dtype``).  A CUDA tensor launches the
bf16 entries (``k1_encoder_forward_bf16``,
``k1_encoder_forward_train_bf16``, ``k2_encoder_backward_bf16``) or
raises.
"""

import ctypes
import functools

import numpy as np
import torch

from ast_tpu_torch.kernels import build
from ast_tpu_torch.ops.bf16 import BF16, rounded, widen
from ast_tpu_torch.ops.dropout import drop_mask, drop_threshold
from ast_tpu_torch.ops.fused_infer import (
    put_transposed, put_transposed_tiles, unit_tiles)
from ast_tpu_torch.ops.lstm import (
    layernorm, lstm_gate_acts, lstm_gates, lstm_gates_backward)

# the input-axis tile of the kernels' products: H must be a multiple
ENCODER_TILE = 32
# a weight tile of the bf16 products, in the tensor cores' B-fragment
# order (fused_infer.mma_tiles): 32 input rows x 64 columns
_MMA_TILE = ENCODER_TILE * 64


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
    contiguous 8 KB; layer 0's directions first, then (layer, direction)
    above, in one flat buffer.  Three strided copies.

    In bf16 (the buffer takes ``wh``'s dtype) each (layer, direction) is
    (H / 16, K / 32, 2048) instead: the same column blocks with each 32 x
    64 tile (4 KB) in ``fused_infer.mma_tiles``' order, which the tensor
    cores' waves read; the same offsets and size, H a multiple of 32
    (:func:`check_encoder_shapes`).  Three permuted copies."""
    L, D2, H, _ = wh.shape
    flat = wh.new_empty(((2 * L - 1) * D2 * H * 4 * H,))
    n0 = D2 * H * 4 * H
    if wh.dtype == BF16:
        check_encoder_shapes(H)
        kt = H // ENCODER_TILE
        unit_tiles(wh[0], flat[:n0].view(D2, H // 16, kt, _MMA_TILE))
        if L > 1:
            # [wx; wh]: a tile lies in one of the two (H rows each)
            rest = flat[n0:].view(L - 1, D2, H // 16, 2 * kt, _MMA_TILE)
            unit_tiles(wx_rest, rest[..., :kt, :])
            unit_tiles(wh[1:], rest[..., kt:, :])
        return flat

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
    a multiple of 64.  In bf16 each block is (4H / 32, 2048) instead, its
    tiles in ``fused_infer.mma_tiles``' order for the tensor cores' waves
    (``put_transposed_tiles``; a ragged block through a zero block): the
    same offsets and size."""
    L, D2, H, H4 = wh.shape
    b0, b1 = -(-H // 64), -(-2 * H // 64)
    n0 = D2 * b0 * H4 * 64
    flat = (torch.zeros if H % 64 else torch.empty)(
        (n0 + (L - 1) * D2 * b1 * H4 * 64,), dtype=wh.dtype, device=wh.device)
    put, block = put_transposed, (H4, 64)
    if wh.dtype == BF16:
        check_encoder_shapes(H)
        put, block = put_transposed_tiles, (H4 // ENCODER_TILE, _MMA_TILE)
    put(flat[:n0].view(D2, b0, *block), 0, wh[0])
    if L > 1:
        rest = flat[n0:].view(L - 1, D2, b1, *block)
        put(rest, 0, wh[1:])
        put(rest, H, wx_rest)
    return flat


def _inv_keep(rate):
    return 1.0 / (1.0 - rate) if rate > 0 else 1.0


def _enc_mask(rate, seed, t, l, L, D2, B, H, device, row_offset=0,
              global_rows=None):
    return drop_mask((D2, B, H), rate, seed + t * L + l, row_axis=1,
                     row_offset=row_offset, global_rows=global_rows or B,
                     device=device)


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
                           rate=0.0, ln=None, relu=False, row_offset=0,
                           global_rows=None, compute_dtype=torch.float32):
    """Plain PyTorch recurrence; same contract as
    :func:`fused_stacked_lstm` (eval) and :func:`fused_stacked_lstm_train`
    (``train=True``: also returns acts, c_all, h_pre, x_drop).

    It is also ``ast_tpu``'s scan encoder, which runs the variants K1
    does not take: ``ln`` (one ``(g, b)`` pair of (D2, H) a layer) and
    ``relu`` transform each layer's output after its dropout, in that
    order, and what the layer above and ``outs`` receive is the
    transformed output; the carried state stays the cell's own.
    ``row_offset`` / ``global_rows``: the masks' global rows (module
    docstring).

    With ``wx_rest`` / ``wh`` in bf16, the rounding points of the module
    docstring (K1's), and in train mode the residual streams in bf16.
    With f32 weights and ``compute_dtype`` bf16, ``ast_tpu``'s scan
    encoder's rounding points instead: a layer above the first
    multiplies its rounded input by its rounded ``wx`` (both rounded at
    every step, as the scan body casts them, so each step's gradient is
    rounded on its own) and accumulates in f32, while ``h @ wh`` stays
    f32 -- K1 rounds ``wh`` and the scan does not."""
    T, D2, B, H4 = x0_proj.shape
    H = H4 // 4
    L = wh.shape[0]
    res_dtype = wh.dtype
    if wh.dtype == BF16:
        wx_rest, wh = wx_rest.float(), wh.float()

        def bmm_x(v, w):
            return torch.bmm(rounded(v), w)
        bmm_h = bmm_x
    elif compute_dtype == BF16:
        def bmm_x(v, w):
            return torch.bmm(rounded(v), rounded(w))
        bmm_h = torch.bmm
    else:
        bmm_x = bmm_h = torch.bmm
    h = [x0_proj.new_zeros((D2, B, H))] * L
    c = [x0_proj.new_zeros((D2, B, H))] * L
    outs, acts, c_all, h_pre, x_drop = [], [], [], [], []
    for t in range(T):
        x = None
        res = ([], [], [], [])
        for l in range(L):
            z = x0_proj[t] if l == 0 else bmm_x(x, wx_rest[l - 1])
            z = z + bmm_h(h[l], wh[l]) + b[l][:, None, :]
            if not train:
                h[l], c[l] = lstm_gates(z, c[l], H)
                x = _transform(h[l], ln, l, relu)
                continue
            a, h[l], c[l] = lstm_gate_acts(z, c[l], H)
            x = h[l]
            if rate > 0:
                keep = _enc_mask(rate, seed, t, l, L, D2, B, H, z.device,
                                 row_offset, global_rows)
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
    return out + tuple(torch.stack(r).to(res_dtype)
                       for r in (acts, c_all, h_pre, x_drop))


def encoder_backward_reference(acts, c_all, wx_rest, wh, douts, dh_fin,
                               dc_fin, seed, rate, forced_dz=None,
                               row_offset=0, global_rows=None):
    """Plain version of K2: the reverse-time pass giving ``dz`` (T, L,
    D2, B, 4H) at every cell's pre-activations, from the residuals, the
    cotangents of (outs, h_fin, c_fin) and the dropout ``rate`` the
    forward ran with (the masks are regenerated from ``seed``).  With
    bf16 residuals and weights: ``dz`` computed in f32 from the widened
    streams, returned in bf16, and rounded where the carries' products
    read it.  With ``forced_dz`` (e.g. a kernel's ``dz``) the carries'
    products read it in place of this pass's own: each step of this
    pass then starts where that one's did.  ``row_offset`` /
    ``global_rows``: the masks' global rows, as the forward's."""
    T, L, D2, B, H4 = acts.shape
    H = H4 // 4
    res_dtype = acts.dtype
    lhs = rounded if res_dtype == BF16 else (lambda v: v)
    acts, c_all, wx_rest, wh = (widen(t) for t in (acts, c_all, wx_rest, wh))
    dh, dc = list(dh_fin), list(dc_fin)
    dz_all = []
    for t in reversed(range(T)):
        dz_t = [None] * L
        cons = douts[t]
        for l in reversed(range(L)):
            if rate > 0:
                keep = _enc_mask(rate, seed, t, l, L, D2, B, H, acts.device,
                                 row_offset, global_rows)
                cons = torch.where(keep, cons * _inv_keep(rate), 0.0)
            c_prev = c_all[t - 1, l] if t > 0 else torch.zeros_like(dc[l])
            dz, dc[l] = lstm_gates_backward(acts[t, l], c_all[t, l], c_prev,
                                            dh[l] + cons, dc[l])
            dz_t[l] = dz
            if forced_dz is not None:
                dz = widen(forced_dz[t, l])
            dh[l] = torch.bmm(lhs(dz), wh[l].transpose(1, 2))
            if l > 0:
                cons = torch.bmm(lhs(dz), wx_rest[l - 1].transpose(1, 2))
        dz_all.append(torch.stack(dz_t))
    return torch.stack(dz_all[::-1]).to(res_dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _global_rows(B, row_offset, global_rows):
    """The global batch's rows (``global_rows``, default B), checked to
    hold the call's rows ``row_offset .. row_offset + B - 1``."""
    rows = B if global_rows is None else int(global_rows)
    if row_offset < 0 or row_offset + B > rows:
        raise ValueError(f"rows {row_offset} .. {row_offset + B - 1} lie "
                         f"outside a global batch of {rows}")
    return rows


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


def encoder_shapes_ok(H):
    """Whether the encoder kernels take H units a direction: their
    products walk the input axis in ENCODER_TILE-row tiles.  The routing
    (``models.seq2seq.use_fused_encoder``) sends any other width to the
    plain recurrence; :func:`check_encoder_shapes` raises where this is
    False."""
    return H % ENCODER_TILE == 0


def check_encoder_shapes(H):
    """Raise unless :func:`encoder_shapes_ok`."""
    if not encoder_shapes_ok(H):
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


def fused_stacked_lstm_train(x0_proj, wx_rest, wh, b, seed, rate,
                             row_offset=0, global_rows=None):
    """Encoder recurrence, train mode: hash dropout at ``rate`` (0 keeps
    every element) over the global rows ``row_offset ..`` of a batch of
    ``global_rows`` (module docstring) and the residual streams.  Returns
    (outs, h_fin, c_fin, acts, c_all, h_pre, x_drop).  ``wx_rest`` /
    ``wh`` in bf16 run the bf16 mode: the four streams in bf16, outs /
    h_fin / c_fin f32; the f32 entry counts in ``launches``, the bf16 one
    in ``launches_bf16``."""
    if not x0_proj.is_cuda:
        return stacked_lstm_reference(x0_proj, wx_rest, wh, b, True, seed,
                                      rate, row_offset=row_offset,
                                      global_rows=global_rows)
    bf16 = wh.dtype == BF16
    rdt = BF16 if bf16 else torch.float32
    T, L, D2, B, H = _check_weights(x0_proj, wx_rest, wh, b, rdt)
    dev = x0_proj.device
    w = pack_encoder_step_weights(wx_rest, wh)
    outs = torch.empty((T, D2, B, H), device=dev)
    acts = torch.empty((T, L, D2, B, 4 * H), dtype=rdt, device=dev)
    c_all, h_pre, x_drop = (torch.empty((T, L, D2, B, H), dtype=rdt,
                                        device=dev) for _ in range(3))
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = (row_offset, _global_rows(B, row_offset, global_rows))
    drop = (seed & 0xFFFFFFFF, drop_threshold(rate), _inv_keep(rate))
    if not bf16:
        zero = torch.zeros((D2, B, H), device=dev)  # h and c before t = 0
        fused_stacked_lstm_train.launches += 1
        build.check_launch("k1_encoder_forward_train",
                           lib.k1_encoder_forward_train(
            x0_proj.data_ptr(), w.data_ptr(), b.data_ptr(),
            outs.data_ptr(), acts.data_ptr(), c_all.data_ptr(),
            h_pre.data_ptr(), x_drop.data_ptr(), zero.data_ptr(),
            *_schedule_args(T, L), L, D2, B, H, *rows, *drop, stream))
        return (outs, h_pre[-1].clone(), c_all[-1].clone(), acts, c_all,
                h_pre, x_drop)
    # the f32 state the recurrence carries: layer l's h and its dropped
    # output at step t in slot t % 2 (both start as the zero state), c
    hbuf = torch.zeros((2, L, D2, B, H), device=dev)
    xbuf = torch.empty((2, L, D2, B, H), device=dev)
    c = torch.zeros((L, D2, B, H), device=dev)
    fused_stacked_lstm_train.launches_bf16 += 1
    build.check_launch("k1_encoder_forward_train_bf16",
                       lib.k1_encoder_forward_train_bf16(
        x0_proj.data_ptr(), w.data_ptr(), b.data_ptr(), outs.data_ptr(),
        acts.data_ptr(), c_all.data_ptr(), h_pre.data_ptr(),
        x_drop.data_ptr(), hbuf.data_ptr(), xbuf.data_ptr(), c.data_ptr(),
        *_schedule_args(T, L), L, D2, B, H, *rows, *drop, stream))
    return outs, hbuf[(T - 1) % 2], c, acts, c_all, h_pre, x_drop


fused_stacked_lstm_train.launches = 0
fused_stacked_lstm_train.launches_bf16 = 0


def encoder_backward(acts, c_all, wx_rest, wh, douts, dh_fin, dc_fin, seed,
                     rate, row_offset=0, global_rows=None):
    """K2: ``dz`` (T, L, D2, B, 4H); see :func:`encoder_backward_reference`.
    bf16 residuals and weights run the bf16 mode (``dz`` in bf16; the
    cotangents and carries f32), counted in ``launches_bf16``."""
    if not acts.is_cuda:
        return encoder_backward_reference(
            acts, c_all, wx_rest, wh, douts, dh_fin, dc_fin, seed, rate,
            row_offset=row_offset, global_rows=global_rows)
    T, L, D2, B, H4 = acts.shape
    H = H4 // 4
    bf16 = acts.dtype == BF16
    rdt = BF16 if bf16 else torch.float32
    build.check_tensor(acts, "acts", (T, L, D2, B, 4 * H), rdt)
    build.check_tensor(c_all, "c_all", (T, L, D2, B, H), rdt)
    build.check_tensor(wx_rest, "wx_rest", (L - 1, D2, H, 4 * H), rdt)
    build.check_tensor(wh, "wh", (L, D2, H, 4 * H), rdt)
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
    dz = torch.empty((T, L, D2, B, 4 * H), dtype=rdt, device=dev)
    lib = build.library()
    args = (acts.data_ptr(), c_all.data_ptr(), w_t.data_ptr(),
            douts.data_ptr(), carry.data_ptr(), dc.data_ptr(), dz.data_ptr())
    tail = (*_schedule_args(T, L, True), L, D2, B, H, row_offset,
            _global_rows(B, row_offset, global_rows), seed & 0xFFFFFFFF,
            drop_threshold(rate), _inv_keep(rate),
            torch.cuda.current_stream(dev).cuda_stream)
    if not bf16:
        encoder_backward.launches += 1
        build.check_launch("k2_encoder_backward",
                           lib.k2_encoder_backward(*args, *tail))
        return dz
    # the f32 dz of a launch's cells, which its product reads (rounded)
    work = torch.empty((lib.k2_work_rows(), B, 4 * H), device=dev)
    encoder_backward.launches_bf16 += 1
    build.check_launch("k2_encoder_backward_bf16",
                       lib.k2_encoder_backward_bf16(*args, work.data_ptr(),
                                                    *tail))
    return dz


encoder_backward.launches = 0
encoder_backward.launches_bf16 = 0


# ---------------------------------------------------------------------------
# differentiable call
# ---------------------------------------------------------------------------

def _grad_or_zeros(g, like):
    return torch.zeros_like(like) if g is None else g.contiguous()


class FusedStackedLSTM(torch.autograd.Function):
    """Differentiable fused encoder (``ast_tpu``'s ``fused_stacked_lstm``
    custom VJP).  ``apply(x0_proj, wx_rest, wh, b, seed, train, rate[,
    dtype[, row_offset, global_rows]])`` -> (outs, h_fin, c_fin).  When
    gradients are needed in eval mode the forward still keeps its
    residuals, with rate 0.  ``row_offset`` / ``global_rows``: the masks'
    global rows (module docstring), for a data-parallel rank's shard.

    ``dtype`` bf16 (``compute_dtype``): ``wx_rest`` / ``wh`` come in f32
    and are cast to bf16 here, so that their gradients -- f32 sums over
    the bf16 streams -- reach them unrounded, as ``ast_tpu``'s custom VJP
    returns them (autograd would round a gradient returned for a bf16
    input to bf16)."""

    @staticmethod
    def forward(ctx, x0_proj, wx_rest, wh, b, seed, train, rate,
                dtype=torch.float32, row_offset=0, global_rows=None):
        rate = float(rate) if train else 0.0
        if dtype == BF16:
            wx_rest, wh = wx_rest.to(BF16), wh.to(BF16)
        if not train and not any(ctx.needs_input_grad[:4]):
            return fused_stacked_lstm(x0_proj, wx_rest, wh, b)
        (outs, h_fin, c_fin, acts, c_all, h_pre,
         x_drop) = fused_stacked_lstm_train(
             x0_proj, wx_rest, wh, b, seed, rate, row_offset=row_offset,
             global_rows=global_rows)
        ctx.save_for_backward(wx_rest, wh, acts, c_all, h_pre, x_drop)
        ctx.drop = (seed, rate)
        ctx.rows = dict(row_offset=row_offset, global_rows=global_rows)
        return outs, h_fin, c_fin

    @staticmethod
    def backward(ctx, douts, dh_fin, dc_fin):
        wx_rest, wh, acts, c_all, h_pre, x_drop = ctx.saved_tensors
        dz = encoder_backward(
            acts, c_all, wx_rest, wh,
            _grad_or_zeros(douts, widen(x_drop[:, -1])),
            _grad_or_zeros(dh_fin, widen(h_pre[-1])),
            _grad_or_zeros(dc_fin, widen(c_all[-1])), *ctx.drop,
            **ctx.rows)
        # weight gradients as time-batched GEMMs, f32 sums (of the bf16
        # streams' values at bf16)
        dz, h_pre, x_drop = widen(dz), widen(h_pre), widen(x_drop)
        h_prev = torch.cat([torch.zeros_like(h_pre[:1]), h_pre[:-1]])
        dwh = torch.einsum("tldbh,tldbk->ldhk", h_prev, dz)
        dwx = torch.einsum("tldbh,tldbk->ldhk", x_drop[:, :-1], dz[:, 1:])
        return (dz[:, 0], dwx, dwh, dz.sum(dim=(0, 3))) + (None,) * 6
