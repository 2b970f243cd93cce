"""Word-error-rate scorer for the sclite ``trn`` reference files (a
copy of ``ast_tpu.eval.wer``, held equal to it by
``tests/test_torch_transfer.py``).

The corpus preprocessor emits ``<set>.clean.wer`` files — one
``text (utt_id)`` line per utterance (reference:
preprocessing/preprocess_gp.py:165-176) — but the reference repo ships
no scorer for them: scoring relied on Kaldi's external ``compute-wer``
(reference: linking_files/fisher/kaldi/steps/scoring/
score_kaldi_wer.sh).  This module closes that loop natively: a
Levenshtein alignment with Kaldi's conventions (uniform costs,
corpus WER = total errors / total reference words) plus the trn
reader and a CLI:

``python -m ast_tpu_torch.eval.wer refs.clean.wer hyps.en
[--ids eval.ids] [--per-utt]``

Hypotheses may be a trn file too, or plain text lines ordered by an
``eval.ids`` file (the BLEU protocol's hyp-file layout, ``eval/bleu.py``).
"""

import argparse


def edit_stats(ref, hyp):
    """(substitutions, insertions, deletions) of the minimum-cost
    alignment of token lists ``hyp`` to ``ref`` (uniform costs; ties
    resolved substitution-first, like Kaldi's compute-wer)."""
    R, H = len(ref), len(hyp)
    # DP over (cost, sub, ins, del); deletions = ref tokens dropped
    prev = [(j, 0, j, 0) for j in range(H + 1)]
    for i in range(1, R + 1):
        cur = [(i, 0, 0, i)]
        for j in range(1, H + 1):
            if ref[i - 1] == hyp[j - 1]:
                cur.append(prev[j - 1])
                continue
            c_sub = prev[j - 1]
            c_ins = cur[j - 1]
            c_del = prev[j]
            best = min(
                (c_sub[0] + 1, c_sub[1] + 1, c_sub[2], c_sub[3]),
                (c_ins[0] + 1, c_ins[1], c_ins[2] + 1, c_ins[3]),
                (c_del[0] + 1, c_del[1], c_del[2], c_del[3] + 1),
                key=lambda t: t[0],
            )
            cur.append(best)
        prev = cur
    _, sub, ins, dele = prev[H]
    return sub, ins, dele


def corpus_wer(refs, hyps):
    """Aggregate WER over ``{utt: [tokens]}`` dicts.

    Returns {"wer": fraction, "sub", "ins", "del", "errors", "n_ref",
    "n_utts", "per_utt": {utt: (sub, ins, del, n_ref)}}.  Utterances
    missing from ``hyps`` score as fully deleted (Kaldi's behavior for
    empty hypotheses).
    """
    unknown = sorted(set(hyps) - set(refs))
    if unknown:
        # Kaldi's compute-wer errors on unmatched utterance sets in its
        # default strict mode; silently ignoring them would both hide
        # the stray hypotheses' errors AND score their references as
        # all-deletions — fail loudly instead.
        raise ValueError(
            f"{len(unknown)} hypothesis utterance(s) not in the "
            f"references (first few: {unknown[:5]}); fix the id "
            "mismatch or drop the stray entries")
    tot = {"sub": 0, "ins": 0, "del": 0, "n_ref": 0}
    per_utt = {}
    for utt, ref in refs.items():
        hyp = hyps.get(utt, [])
        s, i, d = edit_stats(ref, hyp)
        per_utt[utt] = (s, i, d, len(ref))
        tot["sub"] += s
        tot["ins"] += i
        tot["del"] += d
        tot["n_ref"] += len(ref)
    errors = tot["sub"] + tot["ins"] + tot["del"]
    return {
        "wer": errors / max(1, tot["n_ref"]),
        "sub": tot["sub"], "ins": tot["ins"], "del": tot["del"],
        "errors": errors, "n_ref": tot["n_ref"], "n_utts": len(refs),
        "per_utt": per_utt,
    }


def read_trn(path):
    """Parse sclite trn lines ``text (utt_id)`` -> {utt: [tokens]}."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if not line.endswith(")") or "(" not in line:
                raise ValueError(
                    f"{path}: not a trn line (missing '(utt_id)'): "
                    f"{line[:60]!r}")
            text, utt = line[:-1].rsplit("(", 1)
            out[utt.strip()] = text.split()
    return out


def _read_hyps(path, ids_path):
    if ids_path is None:
        return read_trn(path)
    with open(ids_path, encoding="utf-8") as f:
        ids = [line.strip() for line in f if line.strip()]
    with open(path, encoding="utf-8") as f:
        lines = [line.strip() for line in f]
    while lines and not lines[-1]:
        lines.pop()                       # trailing blank lines are fine
    if len(lines) > len(ids):
        raise ValueError(
            f"{path}: {len(lines)} hypothesis lines but only "
            f"{len(ids)} ids in {ids_path} — wrong split or ids file")
    if len(lines) < len(ids):
        lines += [""] * (len(ids) - len(lines))
    return {u: line.split() for u, line in zip(ids, lines)}


def format_report(stats):
    """Kaldi ``compute-wer``-style one-liner."""
    return ("%WER {:.2f} [ {} / {}, {} ins, {} del, {} sub ]".format(
        100.0 * stats["wer"], stats["errors"], stats["n_ref"],
        stats["ins"], stats["del"], stats["sub"]))


def main(argv=None):
    parser = argparse.ArgumentParser(description="WER over trn refs")
    parser.add_argument("refs", help="reference .wer (sclite trn) file")
    parser.add_argument("hyps", help="hypotheses: trn file, or plain "
                                     "lines ordered by --ids")
    parser.add_argument("--ids", default=None,
                        help="eval.ids ordering for plain-line hyps")
    parser.add_argument("--per-utt", action="store_true")
    args = parser.parse_args(argv)

    stats = corpus_wer(read_trn(args.refs), _read_hyps(args.hyps, args.ids))
    if args.per_utt:
        for utt, (s, i, d, n) in sorted(stats["per_utt"].items()):
            print(f"{utt}: {s + i + d}/{n} (sub {s}, ins {i}, del {d})")
    print(format_report(stats))
    return stats


if __name__ == "__main__":
    main()
