"""Luong *general* attention (the counterpart of ``ast_tpu/ops/
attention.py``): ``n_attn`` heads whose context vectors are concatenated
before the context layer, an optional encoder mask, and the streaming
(online-softmax) form over encoder-time blocks.

Attention is unmasked over padded frames unless a mask is given, as in
``ast_tpu`` (the reference's masking line is commented out).  A masked
score is -1e9 in the dense form, -1e30 in the blockwise one, as there.

``compute_dtype`` bfloat16 (``ast_tpu``'s scan path): the encoder states
and each head's query (``dec_h @ wa + b`` taken in f32) are rounded to
bf16, the scores are their product accumulated in f32, the softmax runs
in f32 and its weights are rounded to bf16 before the context sum (the
blockwise form rounds each block's ``p``); the context layer and
``tanh`` stay f32.  A product of two bf16 values is exact in f32, so
each bf16 product here is an f32 product of the rounded operands (in
``dec_h``'s dtype: f64 where a float64 run takes the sums exactly);
under autograd each rounding also rounds the gradient that reaches it,
and a rounded tensor read by several products sums their gradients in
bf16, as XLA's transpose of the casts does.
"""

import torch

from ast_tpu_torch.ops.bf16 import BF16, widen


def luong_attention(enc_states, dec_h, heads, ctx_w, ctx_b, enc_mask=None,
                    block_size=0, compute_dtype=torch.float32):
    """enc_states (R, T, H), dec_h (R, H); ``heads``: one ``(wa (H, H),
    wa_b (H,))`` pair a head (``attn.wa[i].w / .b``); ``ctx_w``
    ((n_attn + 1) H, A) as ``attn.context.w``; ``enc_mask`` (R, T) bool,
    True where a frame is attended; ``block_size > 0`` attends block by
    block when T exceeds it (:func:`blockwise_attend`);
    ``compute_dtype`` bf16: the rounding points of the module docstring
    (``enc_states`` may come in bf16).
    Returns (ht (R, A), alphas (R, T) of the first head)."""
    bf16, dt = compute_dtype == BF16, dec_h.dtype
    enc_c = _bf16(enc_states, bf16)
    cvs, alphas0 = [], None
    for wa, wa_b in heads:
        q = _bf16(dec_h @ wa + wa_b, bf16)                     # (R, H)
        if block_size and enc_states.shape[1] > block_size:
            cv, alphas = blockwise_attend(enc_c, q, enc_mask, block_size)
        else:
            scores = torch.bmm(enc_c.to(dt), q.to(dt).unsqueeze(-1))[..., 0]
            if enc_mask is not None:
                scores = torch.where(enc_mask, scores, -1e9)
            alphas = torch.softmax(scores, dim=-1)
            cv = torch.bmm(_bf16(alphas, bf16).to(dt).unsqueeze(1),
                           enc_c.to(dt))[:, 0]
        cvs.append(cv)
        if alphas0 is None:
            alphas0 = alphas
    ht = torch.tanh(torch.cat(cvs + [dec_h], dim=-1) @ ctx_w + ctx_b)
    return ht, alphas0


def _bf16(x, on):
    """``x`` rounded to bf16 (kept in bf16) where ``on``, else as it
    is: one of the rounding points."""
    return x.to(BF16) if on else x


def blockwise_attend(enc, q, enc_mask, block_size):
    """Online-softmax attention over encoder-time blocks of
    ``block_size`` frames (``ast_tpu``'s ``_blockwise_attend``): a
    running (max, sum, weighted sum) triple, the tail block padded with
    masked frames.  enc (R, T, H), q (R, H), both f32 or both bf16 (then
    each block's ``p`` is rounded to bf16 before its weighted sum; the
    products and the running triple are f32).  Returns (cv (R, H),
    alphas (R, T)), the alphas rebuilt from the blocks' scores."""
    R, T, H = enc.shape
    dev = enc.device
    dtype = widen(q).dtype
    mask = (enc_mask if enc_mask is not None
            else torch.ones((R, T), dtype=torch.bool, device=dev))
    pad = (-T) % block_size
    if pad:
        enc = torch.nn.functional.pad(enc, (0, 0, 0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad), value=False)
    m = torch.full((R,), -float("inf"), dtype=dtype, device=dev)
    s = torch.zeros((R,), dtype=dtype, device=dev)
    acc = torch.zeros((R, H), dtype=dtype, device=dev)
    all_scores = []
    for b0 in range(0, T + pad, block_size):
        e_blk = enc[:, b0:b0 + block_size]
        scores = torch.bmm(e_blk.to(dtype), q.to(dtype).unsqueeze(-1))[..., 0]
        scores = torch.where(mask[:, b0:b0 + block_size], scores, -1e30)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        scale = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[:, None])
        s = s * scale + p.sum(dim=-1)
        acc = acc * scale[:, None] + torch.bmm(
            p.to(e_blk.dtype).to(dtype).unsqueeze(1), e_blk.to(dtype))[:, 0]
        m = m_new
        all_scores.append(scores)
    scores = torch.cat(all_scores, dim=1)[:, :T]
    return acc / s[:, None], torch.exp(scores - m[:, None]) / s[:, None]
