"""K3 and K4: the fused attention-LSTM decoder of training and its
backward.

The counterparts of ``ast_tpu/ops/fused_decoder.py``: the forward
kernel (K3, ``_fwd_kernel``: scheduled-sampling input selection,
embedding with dropout, the L-layer LSTM with dropout, Luong attention,
``ht = tanh(ctx([cv; h_top]))`` and the argmax feed) and the
reverse-time kernel of its custom VJP (K4, ``_bwd_kernel``).  A CUDA
tensor runs the hand kernels (``kernels/csrc/k3_decoder_fwd.cu``,
``k4_decoder_bwd.cu``, both on the products and attention of
``decode_step.cu``); a CPU tensor runs the plain versions
:func:`decoder_forward_reference` and :func:`decoder_backward_reference`,
written from the JAX kernel bodies' math.  :class:`FusedDecoder` is the
differentiable call; its backward is K4, then ``d_enc`` and the weight
gradients as time-batched GEMMs, as ``_fd_bwd`` does.

The kernels' products read their weights as (column blocks, K, 64)
tiles; at bf16, where they run on the tensor cores, each 32 x 64 tile in
the m16n8k16 B-fragment order (``fused_infer.mma_tiles``).  In training
the weights change every step, so each wrapper packs them once per call:
K3 the decode step's layout (``fused_infer.pack_decode_step``:
``pack_step_weights``, at bf16 ``pack_step_weights_mma``), K4 the
transposed matrices of its backward products
(:func:`pack_backward_weights`, at bf16 in the fragment order).

The selected inputs are int ids (``sel``), not one-hot rows: the
embedding is a row gather, and its gradient the one-hot product of
``ops.embedding.embedding_grad``, whose sum runs in a fixed order.  The
post-dropout layer outputs ``x_drop`` are streamed, not regenerated.
``w`` is the dict of ``models.seq2seq.pack_decoder_weights`` (no vocab
padding).  Dropout rates are the effective ones (0 outside training);
the mask seeds are ``seed + 2t`` for the embedding over (B, E) and
``seed + 2(t*L + l) + 1`` for LSTM layer l over (B, H), each hashing the
global row ``row_offset + r`` (``ast_tpu``'s ``row_offset``: a
data-parallel rank's shard draws the rows one process over the whole
batch draws; 0 for a whole batch).  The forward divides kept values by
``1 - p``, the backward multiplies by ``1 / (1 - p)``, as the TPU
kernels do.

bfloat16 (``extras.compute_dtype: "bfloat16"``): every leaf of ``w`` and
``enc`` in bf16 select it (``ast_tpu``'s ``pack_decoder_weights(params,
bf16)`` and ``enc.astype(bf16)``); h0, c0 and ``ht`` stay f32.  The
forward rounds each product's left operand (``[emb; ht_prev]``, h, the
dropped h, ``[cv; h_top]``, ``ht`` for the argmax logits), scores the
encoder states against the unrounded query, rounds the attention weights
before the context sum, adds the (bf16) biases in f32, and stores the
streams of RES_NAMES_BF16 in bf16 -- not ``x_drop``: as in ``ast_tpu``
the backward regenerates it as ``round(h) * inv_keep``.  The backward
reads the streams widened, rounds ``d_pre``, ``d_q``, ``dz`` and
``d_scores`` where its products read them (``c_prev`` of step 0 is the
rounded ``c0``), stores its streams in bf16 and keeps dh0 / dc0 f32;
the weight gradients and ``d_enc`` of :class:`FusedDecoder` reach their
bf16 inputs rounded to bf16, as ``_fd_bwd`` casts them.  A CUDA tensor
launches the bf16 entries (``k3_decoder_forward_bf16``,
``k4_decoder_backward_bf16``) or raises.
"""

import torch

from ast_tpu_torch.kernels import build
from ast_tpu_torch.ops import embedding
from ast_tpu_torch.ops.bf16 import BF16, rounded, widen
from ast_tpu_torch.ops.dropout import drop_mask, drop_threshold
from ast_tpu_torch.ops.fused_infer import (
    STEP_ORDER, check_decoder_inputs, pack_decode_step, put_transposed,
    put_transposed_tiles)
from ast_tpu_torch.ops.lstm import lstm_gate_acts, lstm_gates_backward

W_NAMES = ("wx0", "wx_rest", "wh", "b", "wa", "wa_b", "ctx_w", "ctx_b",
           "out_w", "out_b", "embed")
# the residual streams of the forward, besides ht
RES_NAMES = ("sel", "acts", "c_all", "h_all", "x_drop", "alphas", "q", "cv",
             "emb")
# at bf16 (x_drop is regenerated by the backward)
RES_NAMES_BF16 = tuple(k for k in RES_NAMES if k != "x_drop")
GRAD_NAMES = ("dz", "d_pre", "d_scores", "d_cv", "d_q", "d_emb", "dh0",
              "dc0")
# the products' tiles (decode_step.cu): 32 input rows by 64 columns
_TILE_K, _TILE_N = 32, 64
# shared memory a block may use on the H100
_SMEM_BYTES = 227 * 1024


def embed_drop_mask(rate, seed, t, B, E, device, row_offset=0):
    """Keep-mask of step t's embedding dropout, (B, E), of the global
    rows ``row_offset ..``."""
    return drop_mask((B, E), rate, seed + 2 * t, row_axis=0,
                     row_offset=row_offset, device=device)


def rnn_drop_mask(rate, seed, t, l, L, B, H, device, row_offset=0):
    """Keep-mask of step t's LSTM layer l output dropout, (B, H), of the
    global rows ``row_offset ..``."""
    return drop_mask((B, H), rate, seed + 2 * (t * L + l) + 1, row_axis=0,
                     row_offset=row_offset, device=device)


def rnn_drop_masks(rate, seed, U, L, B, H, device, row_offset=0):
    """The keep-masks of every step and layer, (U, L, B, H): mask (t, l)
    is :func:`rnn_drop_mask`'s."""
    tl = torch.arange(U * L, dtype=torch.int64, device=device).view(
        U, L, 1, 1)
    return drop_mask((B, H), rate, seed + 2 * tl + 1, row_axis=0,
                     row_offset=row_offset, device=device)


def regen_x_drop(h_all, seed, rate, row_offset=0):
    """The post-dropout layer outputs (U, L, B, H) of the bf16 mode's
    weight gradients, regenerated as ``ast_tpu``'s ``_fd_bwd`` does: the
    widened bf16 ``h_all`` times ``1 / (1 - rate)`` where the forward's
    mask kept it (not the forward's rounded ``h / (1 - rate)``)."""
    if rate <= 0:
        return h_all
    U, L, B, H = h_all.shape
    keep = rnn_drop_masks(rate, seed, U, L, B, H, h_all.device, row_offset)
    return torch.where(keep, h_all * (1.0 / (1.0 - rate)), 0.0)


def res_names(dtype):
    """The forward's streams at the weights' ``dtype``."""
    return RES_NAMES_BF16 if dtype == BF16 else RES_NAMES


def _plain_math(enc, w):
    """(enc, w, lhs): the plain versions' operands in f32 and the rounding
    of a product's left operand -- ``ops.bf16.rounded`` with bf16
    weights, else none."""
    if w["wh"].dtype != BF16:
        return enc, w, lambda v: v
    return (enc.float(), {k: v.float() for k, v in w.items()}, rounded)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def decoder_forward_reference(enc, h0, c0, w, y_in, coins, seed, drop_emb,
                              drop_rnn, forced_ids=None, row_offset=0):
    """Plain version of K3 over U steps.

    enc (B, T, He); h0 / c0 (L, B, H); y_in (U, B) teacher ids; coins (U,)
    with 1 = teacher-forced, and coins[0] == 1 (the first step has no
    prediction to feed).  With ``forced_ids`` (U, B), e.g. a kernel's
    ``sel``, those ids are the inputs of every step instead.
    ``row_offset``: the masks' global row of row 0.  Returns (ht (U, B,
    A), dict of the streams RES_NAMES)."""
    U, B = y_in.shape
    L, _, H = h0.shape
    A = w["ctx_w"].shape[1]
    sdt = w["wh"].dtype
    enc, w, lhs = _plain_math(enc, w)
    coin = [int(v) for v in coins.tolist()]
    if forced_ids is None and not coin[0]:
        raise ValueError("coins[0] must be 1: step 0 is teacher-forced")
    h, c = list(h0), list(c0)
    ht = enc.new_zeros((B, A))
    prev = None
    names = RES_NAMES + ("ht",)
    out = {k: [] for k in names}
    for t in range(U):
        if forced_ids is not None:
            sel = forced_ids[t].long()
        else:
            sel = y_in[t].long() if coin[t] else prev
        emb = w["embed"][sel]
        if drop_emb > 0:
            keep = embed_drop_mask(drop_emb, seed, t, B, emb.shape[1],
                                   enc.device, row_offset)
            emb = torch.where(keep, emb / (1.0 - drop_emb), 0.0)
        x = torch.cat([emb, ht], dim=-1)
        acts, xs = [], []
        for l in range(L):
            wx = w["wx0"] if l == 0 else w["wx_rest"][l - 1]
            z = lhs(x) @ wx + lhs(h[l]) @ w["wh"][l] + w["b"][l]
            a, h[l], c[l] = lstm_gate_acts(z, c[l], H)
            x = h[l]
            if drop_rnn > 0:
                keep = rnn_drop_mask(drop_rnn, seed, t, l, L, B, H,
                                     enc.device, row_offset)
                x = torch.where(keep, x / (1.0 - drop_rnn), 0.0)
            acts.append(a)
            xs.append(x)
        q = lhs(x) @ w["wa"] + w["wa_b"]
        alphas = torch.softmax(torch.bmm(enc, q[:, :, None])[..., 0], dim=-1)
        cv = torch.bmm(lhs(alphas)[:, None], enc)[:, 0]
        ht = torch.tanh(lhs(torch.cat([cv, x], dim=-1)) @ w["ctx_w"]
                        + w["ctx_b"])
        if forced_ids is None and t + 1 < U and not coin[t + 1]:
            prev = torch.argmax(lhs(ht) @ w["out_w"] + w["out_b"], dim=-1)
        for k, v in zip(names, (sel.to(torch.int32), torch.stack(acts),
                                torch.stack(c), torch.stack(h),
                                torch.stack(xs), alphas, q, cv, emb, ht)):
            out[k].append(v)
    out = {k: torch.stack(v) for k, v in out.items()}
    ht = out.pop("ht")
    if sdt == BF16:
        out = {k: out[k] if k == "sel" else out[k].to(BF16)
               for k in RES_NAMES_BF16}
    return ht, out


def sampled_shortfall(ht, w, sel, coins):
    """How far each sampled input id (steps t with coins[t] == 0) falls
    below the largest logit of step t-1, from a forward's ``ht`` and
    ``sel``: 0 where the id is that step's argmax.  Returns (U, B)."""
    _, w, lhs = _plain_math(ht, w)
    logits = lhs(ht[:-1]) @ w["out_w"] + w["out_b"]         # (U-1, B, V)
    short = (logits.amax(dim=-1)
             - logits.gather(2, sel[1:, :, None].long())[..., 0])
    sampled = (coins[1:] == 0)[:, None]
    return torch.cat([torch.zeros_like(short[:1]),
                      torch.where(sampled, short, 0.0)])


def decoder_backward_reference(res, ht, enc, c0, w, d_ht, seed, drop_emb,
                               drop_rnn, row_offset=0):
    """Plain version of K4: from the forward's streams, ``ht`` and the
    cotangent ``d_ht`` (U, B, A), the per-step gradients of every
    product's inputs, the masks those of the forward at ``row_offset``.
    Returns a dict of GRAD_NAMES."""
    U, L, B, H4 = res["acts"].shape
    H = H4 // 4
    He = enc.shape[2]
    E = w["embed"].shape[1]
    sdt = w["wh"].dtype
    enc, w, lhs = _plain_math(enc, w)
    res = {k: widen(v) for k, v in res.items() if k != "sel"}
    if sdt == BF16:
        c0 = rounded(c0)        # ast_tpu's c_prev of step 0: c0 in bf16
    dh = [torch.zeros_like(c0[0])] * L
    dc = [torch.zeros_like(c0[0])] * L
    dht = torch.zeros_like(ht[0])
    names = GRAD_NAMES[:6]
    out = {k: [] for k in names}
    for t in reversed(range(U)):
        d_pre = (d_ht[t] + dht) * (1.0 - ht[t] * ht[t])
        d_ctx_in = lhs(d_pre) @ w["ctx_w"].t()
        d_cv, cons = d_ctx_in[:, :He], d_ctx_in[:, He:]
        alphas = res["alphas"][t]
        d_alphas = torch.bmm(enc, d_cv[:, :, None])[..., 0]
        d_scores = alphas * (d_alphas
                             - (d_alphas * alphas).sum(-1, keepdim=True))
        d_q = torch.bmm(lhs(d_scores)[:, None], enc)[:, 0]
        cons = cons + lhs(d_q) @ w["wa"].t()
        dz_t = [None] * L
        for l in reversed(range(L)):
            if drop_rnn > 0:
                keep = rnn_drop_mask(drop_rnn, seed, t, l, L, B, H,
                                     enc.device, row_offset)
                cons = torch.where(keep, cons * (1.0 / (1.0 - drop_rnn)), 0.0)
            c_prev = res["c_all"][t - 1, l] if t > 0 else c0[l]
            dz, dc[l] = lstm_gates_backward(res["acts"][t, l],
                                            res["c_all"][t, l], c_prev,
                                            dh[l] + cons, dc[l])
            dz_t[l] = dz
            dh[l] = lhs(dz) @ w["wh"][l].t()
            if l > 0:
                cons = lhs(dz) @ w["wx_rest"][l - 1].t()
        dx0 = lhs(dz_t[0]) @ w["wx0"].t()
        d_emb, dht = dx0[:, :E], dx0[:, E:]
        if drop_emb > 0:
            keep = embed_drop_mask(drop_emb, seed, t, B, E, enc.device,
                                   row_offset)
            d_emb = torch.where(keep, d_emb * (1.0 / (1.0 - drop_emb)), 0.0)
        for k, v in zip(names, (torch.stack(dz_t), d_pre, d_scores, d_cv,
                                d_q, d_emb)):
            out[k].append(v)
    out = {k: torch.stack(v[::-1]).to(sdt) for k, v in out.items()}
    out["dh0"], out["dc0"] = torch.stack(dh), torch.stack(dc)
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _row_offset(row_offset):
    """The masks' global row of row 0, as the kernels take it."""
    if row_offset < 0:
        raise ValueError(f"row_offset {row_offset} < 0")
    return int(row_offset)


def train_shapes_problem(T, H, E, A, He=None):
    """Why the training decoder's kernels do not take these shapes, or
    None: E, A, H and the encoder states' He (default H) must be
    multiples of the products' 32-wide input tiles, and the attention's
    shared memory (one row's query, two context partials and T scores)
    within a block's."""
    He = H if He is None else He
    if E % _TILE_K or A % _TILE_K or H % _TILE_K or He % _TILE_K:
        return (f"training decoder kernels take E, A, H, He that are "
                f"multiples of {_TILE_K} (got {E}, {A}, {H}, {He})")
    attn = 4 * (2 * He + T + 2)
    if attn > _SMEM_BYTES:
        return (f"training attention needs {attn} bytes of shared "
                f"memory at T={T}, He={He}; a block has {_SMEM_BYTES}")
    return None


def train_shapes_ok(T, H, E, A, He=None):
    """Whether K3 / K4 take these shapes (:func:`train_shapes_problem`):
    the routing (``models.seq2seq.use_fused_decoder``) sends any other
    call to the plain scan loss."""
    return train_shapes_problem(T, H, E, A, He) is None


def check_train_shapes(T, H, E, A, He=None):
    """Raise unless :func:`train_shapes_ok`."""
    problem = train_shapes_problem(T, H, E, A, He)
    if problem:
        raise ValueError(problem)


def pack_backward_weights(w):
    """The transposed matrices of K4's products, each as (column blocks,
    K, 64) with zero columns past N, views of one buffer (``flat``), He
    the encoder states' width:

      ``cv``    ctx_w[:He]^T           (A, He):     d_cv = d_pre @ cv
      ``top``   [wa^T ; ctx_w[He:]^T]  (He + A, H): d_top = [d_q|d_pre] @ top
      ``layer`` per layer [wh^T | wx^T]  (4H, H + E + A, or 2H above layer 0):
                [dh_prev | dx] = dz @ layer[l]; back to back in ``flat``

    A matrix goes in by one strided copy when its columns start and end on
    a block (8 copies at L = 3), with up to two more for a ragged edge.
    At bf16, where the products run on the tensor cores, each 32 x 64
    tile in the B-fragment order (``fused_infer.put_transposed_tiles``,
    the same copies): each view (column blocks, K / 32, 2048), the same
    sizes and offsets (K, a multiple of 32, is A, He + A and 4H).  Made
    once per backward call: the weights change every step."""
    L, H = w["wh"].shape[0], w["wh"].shape[1]
    He = w["wa"].shape[1]
    A = w["ctx_w"].shape[1]
    wxs = [w["wx0"]] + [w["wx_rest"][l] for l in range(L - 1)]
    shapes = [(A, He), (He + A, H)] + [(4 * H, H + wx.shape[0])
                                       for wx in wxs]
    sizes = [-(-N // _TILE_N) * K * _TILE_N for K, N in shapes]
    ragged = any(N % _TILE_N for _, N in shapes)
    flat = (torch.zeros if ragged else torch.empty)(
        (sum(sizes),), dtype=w["wh"].dtype, device=w["wh"].device)
    # a view's second axis counts K rows, or (bf16) tiles of 32 rows
    k = _TILE_K if flat.dtype == BF16 else 1
    put = put_transposed_tiles if k > 1 else put_transposed
    views, off = [], 0
    for (K, _), size in zip(shapes, sizes):
        views.append(flat[off:off + size].view(-1, K // k, k * _TILE_N))
        off += size
    cv, top, layers = views[0], views[1], views[2:]
    put(cv, 0, w["ctx_w"][:He])
    put(top[:, :He // k], 0, w["wa"])
    put(top[:, He // k:], 0, w["ctx_w"][He:])
    for lay, wh, wx in zip(layers, w["wh"], wxs):
        put(lay, 0, wh)
        put(lay, H, wx)
    return {"flat": flat, "cv": cv, "top": top, "layer": layers}


def decoder_forward(enc, h0, c0, w, y_in, coins, seed, drop_emb, drop_rnn,
                    row_offset=0):
    """K3; the contract of :func:`decoder_forward_reference` without
    ``forced_ids``.  ``y_in`` (U, B) and ``coins`` (U,) are int32 on the
    card; the kernel reads the coins itself (no host sync).  bf16 ``w``
    and ``enc`` run the bf16 mode (streams of RES_NAMES_BF16 in bf16),
    counted in ``launches_bf16``."""
    if not enc.is_cuda:
        return decoder_forward_reference(enc, h0, c0, w, y_in, coins, seed,
                                         drop_emb, drop_rnn,
                                         row_offset=row_offset)
    B, T, H, L, E, A, V, dt, He = check_decoder_inputs(enc, h0, c0, w)
    check_train_shapes(T, H, E, A, He)
    U = y_in.shape[0]
    for name, t, shape in (("y_in", y_in, (U, B)), ("coins", coins, (U,))):
        if (not t.is_cuda or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: the kernel takes a contiguous int32 "
                             f"CUDA tensor of shape {shape}")
    dev = enc.device
    f32 = dict(device=dev)
    packed = pack_decode_step(w)
    shapes = {"acts": (U, L, B, 4 * H), "c_all": (U, L, B, H),
              "h_all": (U, L, B, H), "x_drop": (U, L, B, H),
              "alphas": (U, B, T), "q": (U, B, He), "cv": (U, B, He),
              "emb": (U, B, E)}
    res = {"sel": torch.empty((U, B), dtype=torch.int32, device=dev)}
    res.update({k: torch.empty(shapes[k], dtype=dt, device=dev)
                for k in res_names(dt)[1:]})
    ht = torch.empty((U, B, A), **f32)
    # zero logits: a step that samples before any logits were computed
    # (coins[0] == 0, outside the contract) takes id 0
    logits = torch.zeros((B, V), **f32)
    ht0 = torch.zeros((B, A), **f32)
    lib = build.library()
    head = (enc.data_ptr(), *(packed[k].data_ptr() for k in STEP_ORDER),
            h0.data_ptr())
    ins = (y_in.data_ptr(), coins.data_ptr(), logits.data_ptr(),
           ht0.data_ptr(), ht.data_ptr())
    tail = (B, T, H, L, E, A, V, U, _row_offset(row_offset),
            seed & 0xFFFFFFFF, drop_threshold(drop_emb), 1.0 - drop_emb,
            drop_threshold(drop_rnn), 1.0 - drop_rnn, He,
            torch.cuda.current_stream(dev).cuda_stream)
    if dt == torch.float32:
        decoder_forward.launches += 1
        build.check_launch("k3_decoder_forward", lib.k3_decoder_forward(
            *head, c0.data_ptr(), *ins,
            *(res[k].data_ptr() for k in RES_NAMES), *tail))
        return ht, res
    # the f32 state of the bf16 mode: h (two slots), c (from c0), each
    # layer's dropped h, the step's q, cv and dropped embedding
    state = (torch.empty((2, L, B, H), **f32), c0.clone(),
             torch.empty((L, B, H), **f32), torch.empty((B, He), **f32),
             torch.empty((B, He), **f32), torch.empty((B, E), **f32))
    decoder_forward.launches_bf16 += 1
    build.check_launch("k3_decoder_forward_bf16",
                       lib.k3_decoder_forward_bf16(
        *head, *ins, *(res[k].data_ptr() for k in RES_NAMES_BF16),
        *(t.data_ptr() for t in state), *tail))
    return ht, res


decoder_forward.launches = 0
decoder_forward.launches_bf16 = 0


def decoder_backward(res, ht, enc, c0, w, d_ht, seed, drop_emb, drop_rnn,
                     row_offset=0):
    """K4; the contract of :func:`decoder_backward_reference`.  bf16
    streams, ``w`` and ``enc`` run the bf16 mode (the GRAD_NAMES streams
    but dh0 / dc0 in bf16), counted in ``launches_bf16``."""
    if not enc.is_cuda:
        return decoder_backward_reference(res, ht, enc, c0, w, d_ht, seed,
                                          drop_emb, drop_rnn, row_offset)
    U, L, B, H4 = res["acts"].shape
    H = H4 // 4
    T, He = enc.shape[1], enc.shape[2]
    V, E = w["embed"].shape
    A = w["ctx_w"].shape[1]
    dt = BF16 if w["wh"].dtype == BF16 else torch.float32
    build.check_tensor(enc, "enc_states", (B, T, He), dt)
    build.check_tensor(c0, "dec_c0", (L, B, H))
    build.check_tensor(ht, "ht", (U, B, A))
    build.check_tensor(d_ht, "d_ht", (U, B, A))
    for k, shape in (("acts", (U, L, B, 4 * H)), ("c_all", (U, L, B, H)),
                     ("alphas", (U, B, T))):
        build.check_tensor(res[k], k, shape, dt)
    for k, shape in (("wx0", (E + A, 4 * H)), ("wx_rest", (L - 1, H, 4 * H)),
                     ("wh", (L, H, 4 * H)), ("wa", (H, He)),
                     ("ctx_w", (He + H, A))):
        build.check_tensor(w[k], k, shape, dt)
    check_train_shapes(T, H, E, A, He)
    dev = enc.device
    packed = pack_backward_weights(w)
    dh = torch.zeros((L, B, H), device=dev)     # carries, in place
    dc = torch.zeros((L, B, H), device=dev)
    sdt = dict(dtype=dt, device=dev)
    g = {"dz": torch.empty((U, L, B, 4 * H), **sdt),
         "d_pre": torch.empty((U, B, A), **sdt),
         "d_scores": torch.empty((U, B, T), **sdt),
         "d_cv": torch.empty((U, B, He), **sdt),
         "d_q": torch.empty((U, B, He), **sdt),
         "d_emb": torch.empty((U, B, E), **sdt)}
    lib = build.library()
    ins = (res["acts"].data_ptr(), res["c_all"].data_ptr())
    mid = (res["alphas"].data_ptr(), ht.data_ptr(), d_ht.data_ptr(),
           enc.data_ptr(), packed["cv"].data_ptr(), packed["top"].data_ptr(),
           packed["layer"][0].data_ptr(), dh.data_ptr(), dc.data_ptr(),
           *(g[k].data_ptr() for k in GRAD_NAMES[:6]))
    tail = (B, T, H, L, E, A, U, _row_offset(row_offset),
            seed & 0xFFFFFFFF, drop_threshold(drop_emb),
            1.0 / (1.0 - drop_emb), drop_threshold(drop_rnn),
            1.0 / (1.0 - drop_rnn), He,
            torch.cuda.current_stream(dev).cuda_stream)
    if dt == torch.float32:
        decoder_backward.launches += 1
        build.check_launch("k4_decoder_backward", lib.k4_decoder_backward(
            *ins, c0.data_ptr(), *mid, *tail))
    else:
        # ast_tpu's c_prev of step 0 is c0 in bf16; the f32 values the
        # next launches read: each layer's dz, the step's d_pre, d_cv, d_q
        c0_16 = c0.to(BF16)
        work = (torch.empty((L, B, 4 * H), device=dev),
                torch.empty((B, A), device=dev),
                torch.empty((B, He), device=dev),
                torch.empty((B, He), device=dev))
        decoder_backward.launches_bf16 += 1
        build.check_launch("k4_decoder_backward_bf16",
                           lib.k4_decoder_backward_bf16(
            *ins, c0_16.data_ptr(), *mid, *(t.data_ptr() for t in work),
            *tail))
    g["dh0"], g["dc0"] = dh, dc
    return g


decoder_backward.launches = 0
decoder_backward.launches_bf16 = 0


# ---------------------------------------------------------------------------
# differentiable call
# ---------------------------------------------------------------------------

class FusedDecoder(torch.autograd.Function):
    """Differentiable fused decoder (``ast_tpu``'s ``fused_decoder_apply``).

    ``apply(enc, h0, c0, wx0, wx_rest, wh, b, wa, wa_b, ctx_w, ctx_b,
    out_w, out_b, embed, y_in, coins, seed, drop_emb, drop_rnn[,
    row_offset])`` -> (ht (U, B, A), sel (U, B) int32, not
    differentiable); ``row_offset``: the masks' global row of row 0 (a
    data-parallel rank's shard).  ``out_w`` and
    ``out_b`` serve only the argmax feed and get no gradient here: theirs
    comes from the loss logits outside.  With bf16 weights and ``enc``
    (the bf16 mode), the weight gradients and ``d_enc`` are f32 sums over
    the widened streams, which reach their bf16 inputs rounded, and the
    post-dropout layer outputs are regenerated as ``round(h) *
    inv_keep`` (:func:`regen_x_drop`), as ``_fd_bwd`` does."""

    @staticmethod
    def forward(ctx, enc, h0, c0, *args):
        w = dict(zip(W_NAMES, args[:11]))
        y_in, coins, seed, drop_emb, drop_rnn = args[11:16]
        row_offset = args[16] if len(args) > 16 else 0
        ht, res = decoder_forward(enc, h0, c0, w, y_in, coins, seed,
                                  drop_emb, drop_rnn, row_offset=row_offset)
        ctx.names = res_names(w["wh"].dtype)
        ctx.save_for_backward(enc, h0, c0, ht, *args[:11],
                              *(res[k] for k in ctx.names))
        ctx.hyper = (seed, drop_emb, drop_rnn, row_offset)
        ctx.mark_non_differentiable(res["sel"])
        return ht, res["sel"]

    @staticmethod
    def backward(ctx, d_ht, _):
        saved = ctx.saved_tensors
        enc, h0, c0, ht = saved[:4]
        w = dict(zip(W_NAMES, saved[4:15]))
        res = dict(zip(ctx.names, saved[15:]))
        g = decoder_backward(res, ht, enc, c0, w, d_ht.contiguous(),
                             *ctx.hyper[:3], row_offset=ctx.hyper[3])
        L = h0.shape[0]
        g = {k: widen(v) for k, v in g.items()}
        res = {k: v if k == "sel" else widen(v) for k, v in res.items()}
        dz = g["dz"]
        if "x_drop" in res:
            x_drop = res["x_drop"]
        else:
            x_drop = regen_x_drop(res["h_all"], ctx.hyper[0], ctx.hyper[2],
                                  ctx.hyper[3])
        h_top = x_drop[:, L - 1]
        ein = torch.einsum
        d_enc = (ein("ubt,ubh->bth", res["alphas"], g["d_cv"])
                 + ein("ubt,ubh->bth", g["d_scores"], res["q"]))
        ctx_in = torch.cat([res["cv"], h_top], dim=-1)
        h_prev = torch.cat([h0[None], res["h_all"][:-1]])
        ht_prev = torch.cat([torch.zeros_like(ht[:1]), ht[:-1]])
        x0 = torch.cat([res["emb"], ht_prev], dim=-1)
        d_embed = embedding.embedding_grad(res["sel"], g["d_emb"],
                                           w["embed"].shape[0])
        grads = {
            "wx0": ein("ubi,ubk->ik", x0, dz[:, 0]),
            "wx_rest": ein("ulbh,ulbk->lhk", x_drop[:, :-1], dz[:, 1:]),
            "wh": ein("ulbh,ulbk->lhk", h_prev, dz),
            "b": dz.sum(dim=(0, 2)),
            "wa": ein("ubh,ubk->hk", h_top, g["d_q"]),
            "wa_b": g["d_q"].sum(dim=(0, 1)),
            "ctx_w": ein("ubc,uba->ca", ctx_in, g["d_pre"]),
            "ctx_b": g["d_pre"].sum(dim=(0, 1)),
            "embed": d_embed,
        }
        grads["out_w"] = grads["out_b"] = None
        # f32; autograd casts each to its input's dtype, so in the bf16
        # mode d_enc and the weight gradients reach the (f32) parameters
        # rounded to bf16, as _fd_bwd casts them
        return ((d_enc, g["dh0"], g["dc0"])
                + tuple(grads[k] for k in W_NAMES) + (None,) * 6)
