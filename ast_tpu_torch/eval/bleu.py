"""Corpus BLEU scoring and the file-based eval protocol of the dev
decode: the port's own copy of ``ast_tpu/eval/bleu.py`` (``Eval``,
``corpus_bleu``, ``export_meteor_refs`` and their helpers, same names
and behaviour), so the
port imports nothing of ``ast_tpu``.

Multi-reference corpus BLEU with Lin & Och (2004) add-one smoothing
("method2": +1 to numerator and denominator of every n-gram precision
except unigrams), as NLTK's ``corpus_bleu(..., smoothing_function=
method2)``.  ``Eval`` reads ``eval.ids`` (the utterance order) and
``ref.en0..N-1`` (the reference translations).
"""

import math
import os
from collections import Counter


def _ngrams(seq, n):
    return [tuple(seq[i:i + n]) for i in range(len(seq) - n + 1)]


def modified_precision(references, hypothesis, n):
    """Clipped n-gram precision numerator/denominator for one segment."""
    counts = Counter(_ngrams(hypothesis, n))
    if not counts:
        return 0, max(1, len(hypothesis) - n + 1) if len(hypothesis) >= n else 1
    max_counts = {}
    for ref in references:
        for ng, c in Counter(_ngrams(ref, n)).items():
            max_counts[ng] = max(max_counts.get(ng, 0), c)
    numerator = sum(min(c, max_counts.get(ng, 0)) for ng, c in counts.items())
    denominator = max(1, sum(counts.values()))
    return numerator, denominator


def closest_ref_length(references, hyp_len):
    """Length of the reference closest to the hypothesis (ties -> shortest)."""
    return min(
        (len(ref) for ref in references),
        key=lambda rl: (abs(rl - hyp_len), rl),
    )


def corpus_bleu(list_of_references, hypotheses,
                weights=(0.25, 0.25, 0.25, 0.25), smoothing="method2"):
    """Corpus-level BLEU over pre-tokenized segments.

    ``list_of_references``: per segment, a list/tuple of reference token
    lists.  ``hypotheses``: per segment, a hypothesis token list.
    """
    assert len(list_of_references) == len(hypotheses)
    p_num = Counter()
    p_den = Counter()
    hyp_len_total = 0
    ref_len_total = 0
    for references, hypothesis in zip(list_of_references, hypotheses):
        for i, _ in enumerate(weights, start=1):
            num, den = modified_precision(references, hypothesis, i)
            p_num[i] += num
            p_den[i] += den
        hyp_len = len(hypothesis)
        hyp_len_total += hyp_len
        ref_len_total += closest_ref_length(references, hyp_len)

    if p_num[1] == 0:
        return 0.0

    # add-one smoothing on every order above unigram
    precisions = []
    for i, _ in enumerate(weights, start=1):
        if i == 1:
            precisions.append(p_num[i] / p_den[i])
        elif smoothing == "method2":
            precisions.append((p_num[i] + 1) / (p_den[i] + 1))
        else:
            precisions.append(p_num[i] / p_den[i] if p_den[i] else 0.0)

    if min(precisions) <= 0:
        return 0.0

    if hyp_len_total == 0:
        return 0.0
    bp = 1.0 if hyp_len_total > ref_len_total else math.exp(
        1 - ref_len_total / hyp_len_total
    )
    score = bp * math.exp(
        sum(w * math.log(p) for w, p in zip(weights, precisions))
    )
    return score


def _read_ref_files(path, n_evals):
    """``ref.en0..N-1`` as N lists of raw lines (newline stripped)."""
    refs = []
    for i in range(n_evals):
        with open(os.path.join(path, f"ref.en{i}"), "r",
                  encoding="utf-8") as f:
            refs.append([line.rstrip("\n") for line in f])
    return refs


def export_meteor_refs(refs_dir, n_evals, out_path=None):
    """Write the METEOR multi-reference file from ``ref.en0..N-1``.

    The reference's eval dirs ship a ``meteor_4refs.en`` alongside the
    per-system ref files (reference: data/fisher/refs/*/meteor_4refs.en):
    for each utterance in ``eval.ids`` order, its N references appear as
    N consecutive lines — the layout ``meteor -r N`` expects.  Returns
    the output path.
    """
    refs = _read_ref_files(refs_dir, n_evals)
    if len({len(r) for r in refs}) != 1:
        raise ValueError(
            f"ref.en0..{n_evals - 1} in {refs_dir} disagree on line count")
    if out_path is None:
        out_path = os.path.join(refs_dir, f"meteor_{n_evals}refs.en")
    with open(out_path, "w", encoding="utf-8") as out:
        for lines in zip(*refs):
            for line in lines:
                out.write(line + "\n")
    return out_path


class Eval:
    """Multi-reference BLEU evaluation over a refs directory."""

    def __init__(self, path: str, n_evals: int) -> None:
        with open(os.path.join(path, "eval.ids"), "r", encoding="utf-8") as f:
            self.ids = [line.strip() for line in f]

        refs = [[line.split() for line in r]
                for r in _read_ref_files(path, n_evals)]
        self.refs = list(zip(*refs))

    def calc_bleu(self, hyps):
        en_hyp = [hyps[u] for u in self.ids]
        return corpus_bleu(self.refs, en_hyp)

    def write_to_file(self, hyps, fname):
        with open(fname, "w", encoding="utf-8") as out_f:
            for u in self.ids:
                out_f.write("{0:s}\n".format(" ".join(hyps[u])))
