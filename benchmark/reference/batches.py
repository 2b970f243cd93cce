"""The batches of a training epoch, worked out again from the corpus and
the experiment's seed as the configuration's training recipe defines
them (the Fisher recipe's bucketed loader).

- Utterance u goes to bucket ``min(frames // width, n_buckets - 1)``,
  each bucket listing its utterances in corpus order.
- Epoch ``e`` of split ``s`` shuffles with ``random.Random(f"{seed}|{s}|
  {e}")`` (``seed`` the experiment's seed string): each bucket's list in
  bucket order, cut into batches of ``batch`` utterances, then the list
  of batches; with runs of G > 1 the batches are regrouped into runs of
  up to G of one bucket (each bucket's first appearance keeps its place,
  later batches of it pulled forward).
- A batch of bucket b is padded to ``(b + 1) * width`` frames (the last
  bucket to ``(n_buckets + 1) * width``) and to ``batch`` rows, a last
  partial batch to the smallest repeated half of ``batch`` that holds it
  and stays a multiple of 8.
- Frame dropout (``zero_input`` r, training split): for each utterance
  in stream order ``int(r * frames)`` frames, drawn with replacement
  from ``numpy.random.RandomState(stable_seed(tag, 32))`` over the same
  tag, are zeroed.
- Targets: ``[GO] + ids[:max_pred - 2] + [EOS]``, PAD-padded to the
  bucket's length: the most tokens + 2 of any utterance of the bucket,
  capped at ``max_pred``, rounded up to 16 and capped again.
"""

import random

import numpy as np

from benchmark.reference.draws import stable_seed

GO, EOS = 1, 2
N_SPECIAL = 4


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def buckets_of(frames, n_buckets, width):
    """[[utt index, ...] per bucket] of the frame counts in corpus
    order."""
    out = [[] for _ in range(n_buckets)]
    for u, f in enumerate(frames):
        out[min(int(f) // width, n_buckets - 1)].append(u)
    return out


def target_lengths(buckets, n_tokens, max_pred, mult=16):
    out = []
    for bucket in buckets:
        n = max([2] + [min(int(n_tokens[u]) + 2, max_pred) for u in bucket])
        out.append(min(_round_up(n, mult), max_pred))
    return out


def _group_runs(batch_list, G):
    pending, order = {}, []
    for item in batch_list:
        pending.setdefault(item[1], []).append(item)
        order.append(item[1])
    out = []
    for b in order:
        q = pending[b]
        take, pending[b] = q[:G], q[G:]
        out.extend(take)
    return out


def tail_rows(n, b_size, min_rows=8):
    B = b_size
    while B // 2 >= max(n, min_rows) and (B // 2) % min_rows == 0:
        B //= 2
    return B


def epoch_batches(corpus, seed_str, split, epoch, batch, n_buckets, width,
                  max_pred, group=1, n_first=None):
    """The first ``n_first`` (all: None) batches of the epoch as dicts
    {"utts": [index, ...], "bucket", "rows", "T", "U"}."""
    names = corpus["names"]
    buckets = buckets_of(corpus["frames"], n_buckets, width)
    tag = f"{seed_str}|{split}|{epoch}"
    py_rng = random.Random(tag)
    batch_list = []
    for b, bucket in enumerate(buckets):
        bucket = [names[u] for u in bucket]
        py_rng.shuffle(bucket)
        for i in range(0, len(bucket), batch):
            batch_list.append((bucket[i:i + batch], b))
    py_rng.shuffle(batch_list)
    if group > 1:
        batch_list = _group_runs(batch_list, group)
    index = {n: i for i, n in enumerate(names)}
    U = target_lengths(buckets, corpus["n_tokens"], max_pred)
    max_sp = (n_buckets + 1) * width
    out = []
    for utts, b in batch_list[:n_first]:
        out.append({
            "utts": [index[u] for u in utts], "names": list(utts),
            "bucket": b,
            "rows": batch if len(utts) == batch else tail_rows(len(utts),
                                                               batch),
            "T": max_sp if b == n_buckets - 1 else (b + 1) * width,
            "U": U[b]})
    return out, tag


def frame_masks(corpus, batches, tag, rate, max_sp):
    """The frame-dropout keep masks, one (frames,) float32 array an
    utterance of ``batches`` in stream order, drawn from the epoch's
    stream from its start."""
    rng = np.random.RandomState(stable_seed(tag, bits=32))
    masks = []
    for bt in batches:
        row = []
        for u in bt["utts"]:
            n = min(int(corpus["frames"][u]), max_sp)
            m = np.ones(n, dtype=np.float32)
            num = int(rate * n)
            if num > 0:
                m[rng.choice(np.arange(n), size=num)] = 0
            row.append(m)
        masks.append(row)
    return masks


def batch_arrays(corpus, feats, bt, masks=None):
    """(X (rows, T, D) float32, y (rows, U) int64, n_real) of one batch;
    ``feats(u)`` the (frames, D) features of utterance ``u``."""
    D = corpus["feat_dim"]
    X = np.zeros((bt["rows"], bt["T"], D), dtype=np.float32)
    y = np.zeros((bt["rows"], bt["U"]), dtype=np.int64)
    for j, u in enumerate(bt["utts"]):
        x = feats(u)[:bt["T"]]
        if masks is not None:
            x = x * masks[j][:len(x), None]
        X[j, :len(x)] = x
        ids = [N_SPECIAL + int(w) for w in corpus["tokens"][u]]
        seq = [GO] + ids[:corpus["max_pred"] - 2] + [EOS]
        y[j, :len(seq)] = seq
    return X, y, len(bt["utts"])
