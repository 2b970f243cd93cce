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
tiles.  In training the weights change every step, so each wrapper packs
them once per call: K3 the forward layout
(``fused_infer.pack_step_weights``), K4 the transposed matrices of its
backward products (:func:`pack_backward_weights`).

The selected inputs are int ids (``sel``), not one-hot rows: the
embedding is a row gather, and its gradient the one-hot product of
``ops.embedding.embedding_grad``, whose sum runs in a fixed order.  The
post-dropout layer outputs ``x_drop`` are streamed, not regenerated.
``w`` is the dict of ``models.seq2seq.pack_decoder_weights`` (no vocab
padding).  Dropout rates are the effective ones (0 outside training);
the mask seeds are ``seed + 2t`` for the embedding over (B, E) and
``seed + 2(t*L + l) + 1`` for LSTM layer l over (B, H).  The forward
divides kept values by ``1 - p``, the backward multiplies by
``1 / (1 - p)``, as the TPU kernels do.
"""

import torch

from ast_tpu_torch.kernels import build
from ast_tpu_torch.ops import embedding
from ast_tpu_torch.ops.dropout import drop_mask, drop_threshold
from ast_tpu_torch.ops.fused_infer import (
    STEP_ORDER, check_decoder_inputs, pack_step_weights, put_transposed)
from ast_tpu_torch.ops.lstm import lstm_gate_acts, lstm_gates_backward

W_NAMES = ("wx0", "wx_rest", "wh", "b", "wa", "wa_b", "ctx_w", "ctx_b",
           "out_w", "out_b", "embed")
# the residual streams of the forward, besides ht
RES_NAMES = ("sel", "acts", "c_all", "h_all", "x_drop", "alphas", "q", "cv",
             "emb")
GRAD_NAMES = ("dz", "d_pre", "d_scores", "d_cv", "d_q", "d_emb", "dh0",
              "dc0")
# the products' tiles (decode_step.cu): 32 input rows by 64 columns
_TILE_K, _TILE_N = 32, 64
# shared memory a block may use on the H100
_SMEM_BYTES = 227 * 1024


def embed_drop_mask(rate, seed, t, B, E, device):
    """Keep-mask of step t's embedding dropout, (B, E)."""
    return drop_mask((B, E), rate, seed + 2 * t, row_axis=0, device=device)


def rnn_drop_mask(rate, seed, t, l, L, B, H, device):
    """Keep-mask of step t's LSTM layer l output dropout, (B, H)."""
    return drop_mask((B, H), rate, seed + 2 * (t * L + l) + 1, row_axis=0,
                     device=device)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def decoder_forward_reference(enc, h0, c0, w, y_in, coins, seed, drop_emb,
                              drop_rnn, forced_ids=None):
    """Plain version of K3 over U steps.

    enc (B, T, H); h0 / c0 (L, B, H); y_in (U, B) teacher ids; coins (U,)
    with 1 = teacher-forced, and coins[0] == 1 (the first step has no
    prediction to feed).  With ``forced_ids`` (U, B), e.g. a kernel's
    ``sel``, those ids are the inputs of every step instead.  Returns
    (ht (U, B, A), dict of the streams RES_NAMES)."""
    U, B = y_in.shape
    L, _, H = h0.shape
    A = w["ctx_w"].shape[1]
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
                                   enc.device)
            emb = torch.where(keep, emb / (1.0 - drop_emb), 0.0)
        x = torch.cat([emb, ht], dim=-1)
        acts, xs = [], []
        for l in range(L):
            wx = w["wx0"] if l == 0 else w["wx_rest"][l - 1]
            z = x @ wx + h[l] @ w["wh"][l] + w["b"][l]
            a, h[l], c[l] = lstm_gate_acts(z, c[l], H)
            x = h[l]
            if drop_rnn > 0:
                keep = rnn_drop_mask(drop_rnn, seed, t, l, L, B, H, enc.device)
                x = torch.where(keep, x / (1.0 - drop_rnn), 0.0)
            acts.append(a)
            xs.append(x)
        q = x @ w["wa"] + w["wa_b"]
        alphas = torch.softmax(torch.bmm(enc, q[:, :, None])[..., 0], dim=-1)
        cv = torch.bmm(alphas[:, None], enc)[:, 0]
        ht = torch.tanh(torch.cat([cv, x], dim=-1) @ w["ctx_w"] + w["ctx_b"])
        if forced_ids is None and t + 1 < U and not coin[t + 1]:
            prev = torch.argmax(ht @ w["out_w"] + w["out_b"], dim=-1)
        for k, v in zip(names, (sel.to(torch.int32), torch.stack(acts),
                                torch.stack(c), torch.stack(h),
                                torch.stack(xs), alphas, q, cv, emb, ht)):
            out[k].append(v)
    out = {k: torch.stack(v) for k, v in out.items()}
    return out.pop("ht"), out


def sampled_shortfall(ht, w, sel, coins):
    """How far each sampled input id (steps t with coins[t] == 0) falls
    below the largest logit of step t-1, from a forward's ``ht`` and
    ``sel``: 0 where the id is that step's argmax.  Returns (U, B)."""
    logits = ht[:-1] @ w["out_w"] + w["out_b"]              # (U-1, B, V)
    short = (logits.amax(dim=-1)
             - logits.gather(2, sel[1:, :, None].long())[..., 0])
    sampled = (coins[1:] == 0)[:, None]
    return torch.cat([torch.zeros_like(short[:1]),
                      torch.where(sampled, short, 0.0)])


def decoder_backward_reference(res, ht, enc, c0, w, d_ht, seed, drop_emb,
                               drop_rnn):
    """Plain version of K4: from the forward's streams, ``ht`` and the
    cotangent ``d_ht`` (U, B, A), the per-step gradients of every
    product's inputs.  Returns a dict of GRAD_NAMES."""
    U, L, B, H4 = res["acts"].shape
    H = H4 // 4
    E = w["embed"].shape[1]
    dh = [torch.zeros_like(c0[0])] * L
    dc = [torch.zeros_like(c0[0])] * L
    dht = torch.zeros_like(ht[0])
    names = GRAD_NAMES[:6]
    out = {k: [] for k in names}
    for t in reversed(range(U)):
        d_pre = (d_ht[t] + dht) * (1.0 - ht[t] * ht[t])
        d_ctx_in = d_pre @ w["ctx_w"].t()
        d_cv, cons = d_ctx_in[:, :H], d_ctx_in[:, H:]
        alphas = res["alphas"][t]
        d_alphas = torch.bmm(enc, d_cv[:, :, None])[..., 0]
        d_scores = alphas * (d_alphas
                             - (d_alphas * alphas).sum(-1, keepdim=True))
        d_q = torch.bmm(d_scores[:, None], enc)[:, 0]
        cons = cons + d_q @ w["wa"].t()
        dz_t = [None] * L
        for l in reversed(range(L)):
            if drop_rnn > 0:
                keep = rnn_drop_mask(drop_rnn, seed, t, l, L, B, H, enc.device)
                cons = torch.where(keep, cons * (1.0 / (1.0 - drop_rnn)), 0.0)
            c_prev = res["c_all"][t - 1, l] if t > 0 else c0[l]
            dz, dc[l] = lstm_gates_backward(res["acts"][t, l],
                                            res["c_all"][t, l], c_prev,
                                            dh[l] + cons, dc[l])
            dz_t[l] = dz
            dh[l] = dz @ w["wh"][l].t()
            if l > 0:
                cons = dz @ w["wx_rest"][l - 1].t()
        dx0 = dz_t[0] @ w["wx0"].t()
        d_emb, dht = dx0[:, :E], dx0[:, E:]
        if drop_emb > 0:
            keep = embed_drop_mask(drop_emb, seed, t, B, E, enc.device)
            d_emb = torch.where(keep, d_emb * (1.0 / (1.0 - drop_emb)), 0.0)
        for k, v in zip(names, (torch.stack(dz_t), d_pre, d_scores, d_cv,
                                d_q, d_emb)):
            out[k].append(v)
    out = {k: torch.stack(v[::-1]) for k, v in out.items()}
    out["dh0"], out["dc0"] = torch.stack(dh), torch.stack(dc)
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def check_train_shapes(T, H, E, A):
    """Raise unless the training decoder's kernels take these shapes: E, A
    and H multiples of the products' 32-wide input tiles, and the
    attention's shared memory (one row's query, two context partials and
    T scores) within a block's."""
    if E % _TILE_K or A % _TILE_K or H % _TILE_K:
        raise ValueError(f"training decoder kernels take E, A, H that are "
                         f"multiples of {_TILE_K} (got {E}, {A}, {H})")
    attn = 4 * (2 * H + T + 2)
    if attn > _SMEM_BYTES:
        raise ValueError(f"training attention needs {attn} bytes of shared "
                         f"memory at T={T}, H={H}; a block has "
                         f"{_SMEM_BYTES}")


def pack_backward_weights(w):
    """The transposed matrices of K4's products, each as (column blocks,
    K, 64) with zero columns past N, views of one buffer (``flat``):

      ``cv``    ctx_w[:H]^T              (A, H):      d_cv = d_pre @ cv
      ``top``   [wa^T ; ctx_w[H:]^T]     (H + A, H):  d_top = [d_q | d_pre] @ top
      ``layer`` per layer [wh^T | wx^T]  (4H, H + E + A, or 2H above layer 0):
                [dh_prev | dx] = dz @ layer[l]; back to back in ``flat``

    A matrix goes in by one strided copy when its columns start and end on
    a block (8 copies at L = 3), with up to two more for a ragged edge.
    Made once per backward call: the weights change every step."""
    L, H = w["wh"].shape[0], w["wh"].shape[1]
    A = w["ctx_w"].shape[1]
    wxs = [w["wx0"]] + [w["wx_rest"][l] for l in range(L - 1)]
    shapes = [(A, H), (H + A, H)] + [(4 * H, H + wx.shape[0]) for wx in wxs]
    sizes = [-(-N // _TILE_N) * K * _TILE_N for K, N in shapes]
    ragged = any(N % _TILE_N for _, N in shapes)
    flat = (torch.zeros if ragged else torch.empty)(
        (sum(sizes),), dtype=w["wh"].dtype, device=w["wh"].device)
    views, off = [], 0
    for (K, _), size in zip(shapes, sizes):
        views.append(flat[off:off + size].view(-1, K, _TILE_N))
        off += size
    cv, top, layers = views[0], views[1], views[2:]
    put_transposed(cv, 0, w["ctx_w"][:H])
    put_transposed(top[:, :H], 0, w["wa"])
    put_transposed(top[:, H:], 0, w["ctx_w"][H:])
    for lay, wh, wx in zip(layers, w["wh"], wxs):
        put_transposed(lay, 0, wh)
        put_transposed(lay, H, wx)
    return {"flat": flat, "cv": cv, "top": top, "layer": layers}


def decoder_forward(enc, h0, c0, w, y_in, coins, seed, drop_emb, drop_rnn):
    """K3; the contract of :func:`decoder_forward_reference` without
    ``forced_ids``.  ``y_in`` (U, B) and ``coins`` (U,) are int32 on the
    card; the kernel reads the coins itself (no host sync)."""
    if not enc.is_cuda:
        return decoder_forward_reference(enc, h0, c0, w, y_in, coins, seed,
                                         drop_emb, drop_rnn)
    B, T, H, L, E, A, V, dt = check_decoder_inputs(enc, h0, c0, w)
    if dt != torch.float32:
        raise ValueError("K3 takes float32 weights (training at bfloat16 "
                         "is not ported)")
    check_train_shapes(T, H, E, A)
    U = y_in.shape[0]
    for name, t, shape in (("y_in", y_in, (U, B)), ("coins", coins, (U,))):
        if (not t.is_cuda or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: the kernel takes a contiguous int32 "
                             f"CUDA tensor of shape {shape}")
    dev = enc.device
    f32 = dict(device=dev)
    packed = pack_step_weights(w)
    res = {"sel": torch.empty((U, B), dtype=torch.int32, device=dev),
           "acts": torch.empty((U, L, B, 4 * H), **f32),
           "c_all": torch.empty((U, L, B, H), **f32),
           "h_all": torch.empty((U, L, B, H), **f32),
           "x_drop": torch.empty((U, L, B, H), **f32),
           "alphas": torch.empty((U, B, T), **f32),
           "q": torch.empty((U, B, H), **f32),
           "cv": torch.empty((U, B, H), **f32),
           "emb": torch.empty((U, B, E), **f32)}
    ht = torch.empty((U, B, A), **f32)
    # zero logits: a step that samples before any logits were computed
    # (coins[0] == 0, outside the contract) takes id 0
    logits = torch.zeros((B, V), **f32)
    ht0 = torch.zeros((B, A), **f32)
    lib = build.library()
    decoder_forward.launches += 1
    build.check_launch("k3_decoder_forward", lib.k3_decoder_forward(
        enc.data_ptr(), *(packed[k].data_ptr() for k in STEP_ORDER),
        h0.data_ptr(), c0.data_ptr(), y_in.data_ptr(), coins.data_ptr(),
        logits.data_ptr(), ht0.data_ptr(), ht.data_ptr(),
        *(res[k].data_ptr() for k in RES_NAMES),
        B, T, H, L, E, A, V, U, seed & 0xFFFFFFFF,
        drop_threshold(drop_emb), 1.0 - drop_emb, drop_threshold(drop_rnn),
        1.0 - drop_rnn, torch.cuda.current_stream(dev).cuda_stream))
    return ht, res


decoder_forward.launches = 0


def decoder_backward(res, ht, enc, c0, w, d_ht, seed, drop_emb, drop_rnn):
    """K4; the contract of :func:`decoder_backward_reference`."""
    if not enc.is_cuda:
        return decoder_backward_reference(res, ht, enc, c0, w, d_ht, seed,
                                          drop_emb, drop_rnn)
    U, L, B, H4 = res["acts"].shape
    H = H4 // 4
    T = enc.shape[1]
    V, E = w["embed"].shape
    A = w["ctx_w"].shape[1]
    build.check_tensor(enc, "enc_states", (B, T, H))
    build.check_tensor(c0, "dec_c0", (L, B, H))
    build.check_tensor(ht, "ht", (U, B, A))
    build.check_tensor(d_ht, "d_ht", (U, B, A))
    for k, shape in (("acts", (U, L, B, 4 * H)), ("c_all", (U, L, B, H)),
                     ("alphas", (U, B, T))):
        build.check_tensor(res[k], k, shape)
    for k, shape in (("wx0", (E + A, 4 * H)), ("wx_rest", (L - 1, H, 4 * H)),
                     ("wh", (L, H, 4 * H)), ("wa", (H, H)),
                     ("ctx_w", (2 * H, A))):
        build.check_tensor(w[k], k, shape)
    check_train_shapes(T, H, E, A)
    dev = enc.device
    packed = pack_backward_weights(w)
    dh = torch.zeros((L, B, H), device=dev)     # carries, in place
    dc = torch.zeros((L, B, H), device=dev)
    g = {"dz": torch.empty((U, L, B, 4 * H), device=dev),
         "d_pre": torch.empty((U, B, A), device=dev),
         "d_scores": torch.empty((U, B, T), device=dev),
         "d_cv": torch.empty((U, B, H), device=dev),
         "d_q": torch.empty((U, B, H), device=dev),
         "d_emb": torch.empty((U, B, E), device=dev)}
    lib = build.library()
    decoder_backward.launches += 1
    build.check_launch("k4_decoder_backward", lib.k4_decoder_backward(
        res["acts"].data_ptr(), res["c_all"].data_ptr(), c0.data_ptr(),
        res["alphas"].data_ptr(), ht.data_ptr(), d_ht.data_ptr(),
        enc.data_ptr(), packed["cv"].data_ptr(), packed["top"].data_ptr(),
        packed["layer"][0].data_ptr(), dh.data_ptr(), dc.data_ptr(),
        *(g[k].data_ptr() for k in GRAD_NAMES[:6]),
        B, T, H, L, E, A, U, seed & 0xFFFFFFFF, drop_threshold(drop_emb),
        1.0 / (1.0 - drop_emb), drop_threshold(drop_rnn),
        1.0 / (1.0 - drop_rnn), torch.cuda.current_stream(dev).cuda_stream))
    g["dh0"], g["dc0"] = dh, dc
    return g


decoder_backward.launches = 0


# ---------------------------------------------------------------------------
# differentiable call
# ---------------------------------------------------------------------------

class FusedDecoder(torch.autograd.Function):
    """Differentiable fused decoder (``ast_tpu``'s ``fused_decoder_apply``).

    ``apply(enc, h0, c0, wx0, wx_rest, wh, b, wa, wa_b, ctx_w, ctx_b,
    out_w, out_b, embed, y_in, coins, seed, drop_emb, drop_rnn)`` ->
    (ht (U, B, A), sel (U, B) int32, not differentiable).  ``out_w`` and
    ``out_b`` serve only the argmax feed and get no gradient here: theirs
    comes from the loss logits outside."""

    @staticmethod
    def forward(ctx, enc, h0, c0, *args):
        w = dict(zip(W_NAMES, args[:11]))
        y_in, coins, seed, drop_emb, drop_rnn = args[11:]
        ht, res = decoder_forward(enc, h0, c0, w, y_in, coins, seed,
                                  drop_emb, drop_rnn)
        ctx.save_for_backward(enc, h0, c0, ht, *args[:11],
                              *(res[k] for k in RES_NAMES))
        ctx.hyper = (seed, drop_emb, drop_rnn)
        ctx.mark_non_differentiable(res["sel"])
        return ht, res["sel"]

    @staticmethod
    def backward(ctx, d_ht, _):
        saved = ctx.saved_tensors
        enc, h0, c0, ht = saved[:4]
        w = dict(zip(W_NAMES, saved[4:15]))
        res = dict(zip(RES_NAMES, saved[15:]))
        g = decoder_backward(res, ht, enc, c0, w, d_ht.contiguous(),
                             *ctx.hyper)
        L = h0.shape[0]
        x_drop, dz = res["x_drop"], g["dz"]
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
            "out_w": None, "out_b": None,
            "embed": d_embed,
        }
        return ((d_enc, g["dh0"], g["dc0"])
                + tuple(grads[k] for k in W_NAMES) + (None,) * 5)
