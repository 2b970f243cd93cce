"""Luong *general* attention (the counterpart of ``ast_tpu/ops/
attention.py``): ``n_attn`` heads whose context vectors are concatenated
before the context layer, an optional encoder mask, and the streaming
(online-softmax) form over encoder-time blocks.

Attention is unmasked over padded frames unless a mask is given, as in
``ast_tpu`` (the reference's masking line is commented out).  A masked
score is -1e9 in the dense form, -1e30 in the blockwise one, as there.
"""

import torch


def luong_attention(enc_states, dec_h, heads, ctx_w, ctx_b, enc_mask=None,
                    block_size=0):
    """enc_states (R, T, H), dec_h (R, H); ``heads``: one ``(wa (H, H),
    wa_b (H,))`` pair a head (``attn.wa[i].w / .b``); ``ctx_w``
    ((n_attn + 1) H, A) as ``attn.context.w``; ``enc_mask`` (R, T) bool,
    True where a frame is attended; ``block_size > 0`` attends block by
    block when T exceeds it (:func:`blockwise_attend`).
    Returns (ht (R, A), alphas (R, T) of the first head)."""
    cvs, alphas0 = [], None
    for wa, wa_b in heads:
        q = dec_h @ wa + wa_b                                  # (R, H)
        if block_size and enc_states.shape[1] > block_size:
            cv, alphas = blockwise_attend(enc_states, q, enc_mask,
                                          block_size)
        else:
            scores = torch.bmm(enc_states, q.unsqueeze(-1))[..., 0]
            if enc_mask is not None:
                scores = torch.where(enc_mask, scores, -1e9)
            alphas = torch.softmax(scores, dim=-1)
            cv = torch.bmm(alphas.unsqueeze(1), enc_states)[:, 0]
        cvs.append(cv)
        if alphas0 is None:
            alphas0 = alphas
    ht = torch.tanh(torch.cat(cvs + [dec_h], dim=-1) @ ctx_w + ctx_b)
    return ht, alphas0


def blockwise_attend(enc, q, enc_mask, block_size):
    """Online-softmax attention over encoder-time blocks of
    ``block_size`` frames (``ast_tpu``'s ``_blockwise_attend``): a
    running (max, sum, weighted sum) triple, the tail block padded with
    masked frames.  enc (R, T, H), q (R, H).  Returns (cv (R, H), alphas
    (R, T)), the alphas rebuilt from the blocks' scores."""
    R, T, H = enc.shape
    mask = (enc_mask if enc_mask is not None
            else torch.ones((R, T), dtype=torch.bool, device=enc.device))
    pad = (-T) % block_size
    if pad:
        enc = torch.nn.functional.pad(enc, (0, 0, 0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad), value=False)
    m = torch.full((R,), -float("inf"), device=enc.device)
    s = enc.new_zeros((R,))
    acc = enc.new_zeros((R, H))
    all_scores = []
    for b0 in range(0, T + pad, block_size):
        e_blk = enc[:, b0:b0 + block_size]
        scores = torch.bmm(e_blk, q.unsqueeze(-1))[..., 0]
        scores = torch.where(mask[:, b0:b0 + block_size], scores, -1e30)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        scale = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[:, None])
        s = s * scale + p.sum(dim=-1)
        acc = acc * scale[:, None] + torch.bmm(p.unsqueeze(1), e_blk)[:, 0]
        m = m_new
        all_scores.append(scores)
    scores = torch.cat(all_scores, dim=1)[:, :T]
    return acc / s[:, None], torch.exp(scores - m[:, None]) / s[:, None]
