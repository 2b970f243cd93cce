"""Unigram precision/recall metrics (a copy of ``ast_tpu.eval.metrics``
over the port's own ``eval.bleu`` and ``symbols``).

Capability parity with the reference's legacy metrics
(reference: nmt_run.py:124-189 ``basic_precision_recall`` /
nmt_run.py:105-122 ``count_match``): corpus unigram precision from clipped
counts, and recall against the single best-recall reference per segment.
"""

from collections import Counter

from ast_tpu_torch.eval.bleu import modified_precision
from ast_tpu_torch.symbols import SYMBOLS


def _count_match(ref, hyp):
    """Clipped unigram matches, ignoring UNK/EOS ids/tokens."""
    skip = {SYMBOLS.UNK_ID, SYMBOLS.EOS_ID, SYMBOLS.UNK, SYMBOLS.EOS,
            SYMBOLS.UNK.decode(), SYMBOLS.EOS.decode()}
    c_ref = Counter(t for t in ref if t not in skip)
    c_hyp = Counter(t for t in hyp if t not in skip)
    common = set(c_ref) & set(c_hyp)
    matches = sum(min(c_ref[w], c_hyp[w]) for w in common)
    return matches, sum(c_hyp.values()), sum(c_ref.values())


def unigram_precision_recall(list_of_references, hypotheses):
    """Returns (precision%, recall%) over the corpus."""
    p_num = p_den = r_num = r_den = 0
    for references, hypothesis in zip(list_of_references, hypotheses):
        if len(hypothesis) > 0:
            num, den = modified_precision(references, hypothesis, 1)
            p_num += num
            p_den += den

        best = None
        for ref in references:
            matches, _, t = _count_match(ref, hypothesis)
            recall = matches / t if t > 0 else 0
            if best is None or recall > best[0]:
                best = (recall, matches, t)
        if best is not None:
            r_num += best[1]
            r_den += best[2]

    prec = (p_num / p_den) * 100 if p_den > 0 else 0
    rec = (r_num / r_den) * 100 if r_den > 0 else 0
    return prec, rec
