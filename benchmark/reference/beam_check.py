"""The comparison that decides a beam-decoding cell's ``correct``.

For a sample of the answers the window produced (each an utterance with
its N hypotheses, their lengths and their scores), the reference
encodes the utterance at its bucket's padded width and follows each
hypothesis's tokens with the eval-mode decoder (``model.follow``), in
float32:

- ``token``: the widest gap by which a hypothesis token's log-probability
  lies below the reference's K-th best at its position (a beam keeps
  only tokens among the K best of their slot, so a sound search reads
  rounding, an altered token reads its distance from the top K);
- ``score``: the widest gap between a hypothesis's returned score and
  the reference's sum of the log-probabilities of its tokens (EOS
  included), over the larger of that sum's size and 1;
- ``order``: the utterances whose N hypotheses do not come in the order
  of their returned scores, best first (exact: 0);
- ``dup``: the utterances with two hypotheses of the same tokens (exact:
  0; a beam keeps N distinct candidates).

The control (a lower precision in the program's place) reads, at the
same positions, the gap of the worst token among the K that the lower
precision ranks best, the lower precision's sums as the scores, and
their order.  ``last_step`` is a fault of the search put in the
program's place: each hypothesis scored by its last token's
log-probability alone.
"""

import numpy as np
import torch

from benchmark.reference import model
from benchmark.reference.precision import exact_float32

NUMBERS = ("token", "score", "order", "dup")


def padded_width(frames, n_buckets, width):
    """The frames of the batch an utterance of ``frames`` is padded to."""
    b = min(int(frames) // width, n_buckets - 1)
    return (n_buckets + 1) * width if b == n_buckets - 1 else (b + 1) * width


def readings(config, corpus, feats, weights, answers, K, device,
             mode=None, rows=64):
    """{"token", "score", "order", "dup"} over ``answers`` [(utt index,
    hyps (N, S) int, lengths (N,), scores (N,))], in groups of one padded
    width of at most ``rows`` hypotheses.  ``mode``: read the control at
    that precision, or the ``last_step`` fault, instead of the given
    answers' own tokens and scores."""
    mcfg, data = config["model_cfg"], config["train_cfg"]["data"]
    nb, width = data["buckets_num"], data["buckets_width"]
    groups = {}
    for a in answers:
        T = padded_width(corpus["frames"][a[0]], nb, width)
        groups.setdefault(T, []).append(a)
    out = dict.fromkeys(NUMBERS, 0.0)
    with exact_float32(), torch.no_grad():
        for T, group in sorted(groups.items()):
            N = len(group[0][1])
            per = max(1, rows // N)
            for i in range(0, len(group), per):
                got = _group(mcfg, feats, weights, group[i:i + per], T, K,
                             device, mode)
                out["token"] = max(out["token"], got["token"])
                out["score"] = max(out["score"], got["score"])
                out["order"] += got["order"]
                out["dup"] += got["dup"]
    return out


def _group(mcfg, feats, weights, group, T, K, device, mode):
    D = feats(group[0][0]).shape[1]
    X = np.zeros((len(group), T, D), dtype=np.float32)
    for j, a in enumerate(group):
        x = feats(a[0])[:T]
        X[j, :len(x)] = x
    enc, h0, c0 = model.encode_eval(weights, mcfg,
                                    torch.from_numpy(X).to(device))
    N = len(group[0][1])
    S = max(int(l) for a in group for l in a[2])
    hyps = np.stack([np.asarray(a[1])[:, :S] for a in group])   # (G, N, S)
    tokens = torch.tensor(hyps.reshape(-1, S), dtype=torch.long,
                          device=device)
    lengths = torch.tensor(np.concatenate([a[2] for a in group]),
                           device=device)
    rep = lambda t, d: t.repeat_interleave(N, dim=d)   # noqa: E731
    logp = model.follow(weights, mcfg, rep(enc, 0), rep(h0, 1), rep(c0, 1),
                        tokens)                        # (R, S - 1, V)
    pos = torch.arange(S - 1, device=device)
    live = pos[None, :] < (lengths[:, None] - 1)       # scored positions
    kth = torch.topk(logp, K, dim=-1).values[..., -1]
    chosen = logp.gather(-1, tokens[:, 1:, None])[..., 0]
    ref_sum = torch.where(live, chosen, 0.0).sum(1).double()
    if mode is None:
        gap = kth - chosen
        scores = torch.tensor(np.concatenate([np.asarray(a[3], np.float64)
                                              for a in group]),
                              device=device)
    elif mode == "last_step":
        gap = torch.zeros_like(chosen)
        last = (lengths - 2).clamp_min(0).long()
        scores = chosen.gather(1, last[:, None])[:, 0].double()
    else:
        enc_l, h0_l, c0_l = model.encode_eval(
            weights, mcfg, torch.from_numpy(X).to(device), mode)
        low = model.follow(weights, mcfg, rep(enc_l, 0), rep(h0_l, 1),
                           rep(c0_l, 1), tokens, mode)
        gap = kth - logp.gather(-1, torch.topk(low, K, dim=-1).indices
                                ).amin(-1)
        scores = torch.where(live, low.gather(-1, tokens[:, 1:, None])[..., 0],
                             0.0).sum(1).double()
    score = ((scores - ref_sum).abs()
             / ref_sum.abs().clamp_min(1.0)).amax()
    by_utt = scores.reshape(len(group), N)
    order = int((by_utt[:, 1:] > by_utt[:, :-1]).any(1).sum())
    dup = sum(len({tuple(h[:int(n)]) for h, n in zip(u, a[2])}) < N
              for u, a in zip(hyps.tolist(), group))
    return {"token": float(torch.where(live, gap, 0.0).amax().clamp_min(0)),
            "score": float(score), "order": float(order),
            "dup": float(dup)}
