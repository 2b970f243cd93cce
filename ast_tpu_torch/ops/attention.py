"""Luong *general* attention, dense path only (the counterpart of
``ast_tpu/ops/attention.py`` ``luong_attention`` with one head, no mask
and no blocking -- what the decode gate admits)."""

import torch


def luong_attention(enc_states, dec_h, wa, wa_b, ctx_w, ctx_b):
    """enc_states (R, T, H), dec_h (R, H); ``wa (H, H)``, ``ctx_w (2H, A)``
    as ``attn.wa[0].w`` and ``attn.context.w``.
    Returns (ht (R, A), alphas (R, T))."""
    q = dec_h @ wa + wa_b                                      # (R, H)
    scores = torch.bmm(enc_states, q.unsqueeze(-1))[..., 0]    # (R, T)
    alphas = torch.softmax(scores, dim=-1)
    cv = torch.bmm(alphas.unsqueeze(1), enc_states)[:, 0]      # (R, H)
    ht = torch.tanh(torch.cat([cv, dec_h], dim=-1) @ ctx_w + ctx_b)
    return ht, alphas
