"""The comparison that decides a training cell's ``correct``.

The reference trains the first ``n`` steps of epoch 1 from the
benchmark's weights on its own batches (``batches.py``) and draws
(``draws.py``), in plain PyTorch (``model.py``) at a precision ``mode``.
What the program's timed path produced for the same steps is held
against it:

- ``feed``: the number of the first steps whose utterances differ from
  the reference's batch (an exact comparison);
- ``loss``: the largest relative gap of a step's loss;
- ``grad``: the gradient of step 1 as the optimizer received it (the
  program's: its first moment after one step over ``1 - b1``): by the
  worst leaf, the gap between the two norms over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change``: the parameters' change over the ``n`` steps, by the worst
  leaf as ``grad``, leaving out leaves whose reference gradient of step
  1 is under a thousandth of the median leaf's (they move by round-off
  alone);
- ``grad_median``: ``grad``'s gap of the median leaf, steady from seed to
  seed where the worst leaf's is the tail of the leaves' rounding.
"""

import torch

from benchmark.reference import batches as bt
from benchmark.reference import model
from benchmark.reference.draws import make_draws, step_seed
from benchmark.reference.precision import exact_float32

N_STEPS = 3


def first_batches(config, corpus, seed, n=N_STEPS):
    """(the first ``n`` batches of epoch 1, their frame-dropout masks)."""
    tcfg = config["train_cfg"]
    data = tcfg["data"]
    G = int(tcfg["extras"].get("steps_per_dispatch", 1))
    nb, width = data["buckets_num"], data["buckets_width"]
    out, tag = bt.epoch_batches(corpus, f"bench-{seed}", "bench_train", 1,
                                tcfg["batch_size"], nb, width,
                                data["max_pred"], group=G, n_first=n)
    rate = float(data.get("zero_input", 0))
    masks = (bt.frame_masks(corpus, out, tag, rate, (nb + 1) * width)
             if rate > 0 else [None] * len(out))
    return out, masks


def reference_run(config, corpus, feats, weights, seed, device, mode="f32",
                  n=N_STEPS, half=False):
    """Train ``n`` steps from ``weights`` (flat, copied); returns {"utts":
    [[name, ...] a step], "losses": [float], "g1": flat gradient of step
    1 as the moments received it, "p0", "p": flat parameters before and
    after, "inputs": [(U - 1, B) decoder input tokens a step]}.
    ``half``: the fault of a step that leaves out the second half of its
    batch and takes the mean over the rest."""
    mcfg, tcfg = config["model_cfg"], config["train_cfg"]
    extras = tcfg["extras"]
    steps, masks = first_batches(config, corpus, seed, n)
    p = {k: v.detach().clone() for k, v in weights.items()}
    p0 = {k: v.clone() for k, v in p.items()}
    opt = model.AMSGrad(tcfg["optimizer"], p)
    out = {"utts": [], "losses": [], "p0": p0, "inputs": []}
    with exact_float32():
        for k, (b, m) in enumerate(zip(steps, masks)):
            X, y, n_real = bt.batch_arrays(corpus, feats, b, m)
            if half:
                n_real = max(1, n_real // 2)
                X, y = X[:n_real], y[:n_real]
            X = torch.from_numpy(X).to(device)
            y = torch.from_numpy(y).to(device)
            draws = make_draws(step_seed(f"bench-{seed}", 1, k), X,
                               y.shape[1] - 1, float(extras["teach_ratio"]),
                               float(extras["speech_noise"]))
            leaves = {kk: v.requires_grad_(True) for kk, v in p.items()}
            inputs = []
            loss = model.train_loss(leaves, mcfg, X, y, n_real, draws, mode,
                                    inputs)
            out["inputs"].append(torch.stack(inputs))
            grads = torch.autograd.grad(loss, list(leaves.values()))
            with torch.no_grad():
                p = {kk: v.detach() for kk, v in leaves.items()}
                g = opt.step(p, dict(zip(leaves, grads)))
            if k == 0:
                out["g1"] = g
            out["utts"].append(b["names"])
            out["losses"].append(float(loss.detach()))
    out["p"] = p
    return out


def _median(vals):
    v = sorted(vals)
    return v[len(v) // 2]


def leaf_gaps(prog, ref, keys):
    """Each leaf's gap of norms, over the larger of the reference's norm
    of the leaf and of the median leaf."""
    rn = {k: float(torch.linalg.vector_norm(ref[k].float())) for k in keys}
    pn = {k: float(torch.linalg.vector_norm(prog[k].float())) for k in keys}
    med = _median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}


def leaf_gap(prog, ref, keys):
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    return max(leaf_gaps(prog, ref, keys).values())


def compare(prog, ref):
    """{name: number} of the program's readings against the reference's
    (both as :func:`reference_run` returns them; the program's ``p0`` is
    the reference's)."""
    feed = sum(a != b for a, b in zip(prog["utts"], ref["utts"]))
    feed += abs(len(prog["utts"]) - len(ref["utts"]))
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["losses"], ref["losses"]))
    keys = sorted(ref["g1"])
    gaps = leaf_gaps(prog["g1"], ref["g1"], keys)
    gn = {k: float(torch.linalg.vector_norm(ref["g1"][k])) for k in keys}
    med = _median(gn.values())
    moving = [k for k in keys if gn[k] >= 1e-3 * med]
    d_prog = {k: prog["p"][k].float() - ref["p0"][k] for k in moving}
    d_ref = {k: ref["p"][k] - ref["p0"][k] for k in moving}
    change = leaf_gap(d_prog, d_ref, moving)
    return {"feed": float(feed), "loss": loss, "grad": max(gaps.values()),
            "change": change, "grad_median": _median(gaps.values())}


def diagnose(prog, ref):
    """Where the readings come from: each leaf's grad and change gaps,
    and the decoder inputs of the checked steps that differ from the
    reference's (``prog["inputs"]``: the program's, where known)."""
    keys = sorted(ref["g1"])
    gn = {k: float(torch.linalg.vector_norm(ref["g1"][k])) for k in keys}
    med = _median(gn.values())
    moving = [k for k in keys if gn[k] >= 1e-3 * med]
    out = {"grad_leaves": leaf_gaps(prog["g1"], ref["g1"], keys),
           "change_leaves": leaf_gaps(
               {k: prog["p"][k].float() - ref["p0"][k] for k in moving},
               {k: ref["p"][k] - ref["p0"][k] for k in moving}, moving),
           "losses": [prog["losses"], ref["losses"]]}
    if prog.get("inputs") and all(a.shape == b.shape for a, b in
                                  zip(prog["inputs"], ref["inputs"])):
        out["input_flips"] = [
            int((a.to(b.device).long() != b).sum())
            for a, b in zip(prog["inputs"], ref["inputs"])]
    return out
