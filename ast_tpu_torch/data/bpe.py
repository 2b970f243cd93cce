"""Byte-pair encoding: in-repo learner + applier -- the port's copy of
``ast_tpu/data/bpe.py``, whose merges files it writes byte for byte.

The reference shells out to the external ``subword-nmt`` package
(reference: linking_files/get_bpe.sh:13-19 — learn-joint-bpe-and-vocab
with 1000 merge ops, apply-bpe with vocabulary threshold 1).  This module
implements the same algorithm natively so target units are regenerable
without external dependencies.  Conventions match subword-nmt: a word is
segmented as subwords where every non-final piece carries the ``@@``
continuation marker; ``</w>`` is the internal end-of-word symbol during
learning.
"""

from collections import Counter


def _word_to_symbols(word):
    return tuple(word[:-1]) + (word[-1] + "</w>",)


def learn_bpe(corpus, num_merges=1000, min_frequency=2):
    """Learn merge operations from an iterable of token lists.

    Returns an ordered list of merge pairs [(a, b), ...].
    """
    word_freq = Counter()
    for sent in corpus:
        word_freq.update(sent)

    vocab = {_word_to_symbols(w): f for w, f in word_freq.items()}
    merges = []

    for _ in range(num_merges):
        pairs = Counter()
        for word, freq in vocab.items():
            for i in range(len(word) - 1):
                pairs[(word[i], word[i + 1])] += freq
        if not pairs:
            break
        best, best_freq = pairs.most_common(1)[0]
        if best_freq < min_frequency:
            break
        merges.append(best)
        merged = best[0] + best[1]
        new_vocab = {}
        for word, freq in vocab.items():
            out = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1
                        and (word[i], word[i + 1]) == best):
                    out.append(merged)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            new_vocab[tuple(out)] = freq
        vocab = new_vocab

    return merges


def apply_bpe(merges, tokens):
    """Segment a token list with learned merges.

    Returns subword tokens with ``@@`` continuation markers (the format
    the reference's detokenizer joins back: dataloader.py:176-177).
    """
    rank = {pair: i for i, pair in enumerate(merges)}
    out = []
    for word in tokens:
        symbols = list(_word_to_symbols(word))
        while len(symbols) > 1:
            best_i, best_rank = -1, None
            for i in range(len(symbols) - 1):
                r = rank.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_i, best_rank = i, r
            if best_rank is None:
                break
            symbols[best_i: best_i + 2] = [
                symbols[best_i] + symbols[best_i + 1]]
        pieces = [s.replace("</w>", "") for s in symbols]
        pieces = [p for p in pieces if p]
        out.extend(
            p + "@@" if i < len(pieces) - 1 else p
            for i, p in enumerate(pieces)
        )
    return out


def save_merges(merges, path):
    with open(path, "w", encoding="utf-8") as f:
        f.write("#version: ast_tpu bpe\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")


def load_merges(path):
    merges = []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            # only the writer's version header is a comment — a merge
            # whose first symbol itself starts with '#' (corpus token
            # like '#yes') must round-trip, so later '#' lines are data
            if i == 0 and line.startswith("#version:"):
                continue
            parts = line.rstrip("\n").split(" ")
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
    return merges
