"""Batched beam search and host-side reranking.

The counterpart of ``ast_tpu/ops/beam.py``: the decoder keeps the same
``(hyps, scores, lengths)`` contract, with the frontier loop in the K6
kernel (``ops/fused_infer.beam_decode_fused``) for the variant and the
shapes ``seq2seq.use_fused_infer`` admits and without ``return_attn``;
otherwise the same frontier loop (``fused_infer.beam_reference``) runs
over ``seq2seq.plain_step`` as plain PyTorch on the caller's device, as
``ast_tpu`` runs its XLA loop.  Both run at either compute dtype: at
bfloat16 K6 takes the encoder states rounded to bf16, and the plain
loop takes them f32 and its attention rounds them (``ast_tpu``'s
``enc_tiled`` is not cast), with ``return_attn`` too.  Hypotheses are
reranked by ``score / (len - 2)^W`` on the host.
"""

import torch

from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.ops.fused_infer import beam_decode_fused, beam_reference


def make_beam_decoder(mcfg, N, K, stop_limit, return_attn=False,
                      compute_dtype=torch.float32):
    """Build ``(params, state, X, w=None, enc_mask=None) -> (hyps,
    scores, lengths)``; ``w`` is ``seq2seq.decode_weights(params,
    compute_dtype)``, made per call when not given; ``enc_mask`` (B, T')
    (``seq2seq.make_enc_mask``) masks the attention.  At
    ``compute_dtype`` bf16 the encoder runs at bf16 and its states are
    rounded to bf16 before K6 (``ast_tpu``'s ``fused_decode``), or go to
    the plain frontier loop at bf16 as they are.

    hyps: (B, N, stop_limit+1) int32 token ids beginning with GO;
    scores: (B, N) summed log-probs; lengths: (B, N) valid token counts.
    ``return_attn``: also the attention history (B, N, stop_limit+1, T')
    of each hypothesis (``fused_infer.beam_reference``)."""
    V = mcfg["rnn_config"]["dec_vocab_size"]
    if K > V:
        raise ValueError(
            f"beam width K={K} exceeds the decoder vocabulary "
            f"({V} tokens) — at most V continuations exist per step")
    if N < 1 or K < 1:
        raise ValueError(f"beam sizes must be >= 1 (got N={N}, K={K})")

    def decode(params, state, X, w=None, enc_mask=None):
        if w is None:
            w = seq2seq.decode_weights(params, compute_dtype, mcfg)
        enc_states, dec_h0, dec_c0 = seq2seq.encode(params, state, mcfg, X,
                                                    w, compute_dtype)
        if not return_attn and seq2seq.use_fused_infer(
                mcfg, X.device, *enc_states.shape[:2], N, K, enc_mask):
            return beam_decode_fused(enc_states.to(w["wh"].dtype), dec_h0,
                                     dec_c0, w, N, K, stop_limit)
        rows_mask = (None if enc_mask is None
                     else enc_mask.repeat_interleave(N, dim=0))
        return beam_reference(enc_states, dec_h0, dec_c0, w, N, K,
                              stop_limit,
                              step=seq2seq.plain_step(params, mcfg,
                                                      rows_mask,
                                                      compute_dtype),
                              return_attn=return_attn)

    return decode


def rerank_hypothesis(beam_hyps, weight):
    """[(hyp_ids, score[, ...])] -> sorted [(hyp_ids, norm_score, len)]."""
    return sorted(
        [(e[0], e[1] / (max(1, len(e[0]) - 2) ** weight), len(e[0]))
         for e in beam_hyps],
        reverse=True, key=lambda t: t[1])


def get_best_hyps(utts_beam, W):
    """{utt: [(hyp_ids, score)]} -> {utt: best hyp_ids} after length-norm."""
    return {u: list(rerank_hypothesis(hyps, W)[0][0])
            for u, hyps in utts_beam.items()}
