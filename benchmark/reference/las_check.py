"""The comparison that decides the LAS cell's ``correct``: the readings
of ``train_check`` (``feed``, ``loss``, ``grad``, ``change``,
``grad_median``) over the first ``n`` steps of epoch 1, with the LAS
reference (``las_model.py``) training them from the benchmark's weights
on its own batches (``batches.py``) and draws (``las_model.make_draws``
from the step seed of ``draws.py``), at a precision ``mode``.
"""

import torch

from benchmark.reference import batches as bt
from benchmark.reference import las_model
from benchmark.reference.draws import step_seed
from benchmark.reference.precision import exact_float32
from benchmark.reference.train_check import N_STEPS, first_batches


def frame_lengths(corpus, bt_, rows):
    """(rows,) true frames of a batch's rows, cut to its padded length;
    0 for padding rows."""
    n = [min(int(corpus["frames"][u]), bt_["T"]) for u in bt_["utts"]]
    return torch.tensor(n + [0] * (rows - len(n)))


def reference_run(config, corpus, feats, weights, seed, device, mode="f32",
                  n=N_STEPS, half=False):
    """Train ``n`` steps from ``weights`` (flat, copied); returns the dict
    of ``train_check.reference_run``.  ``half``: the fault of a step that
    leaves out the second half of its batch and takes the mean over the
    rest."""
    mcfg, tcfg = config["model_cfg"], config["train_cfg"]
    extras, spec = tcfg["extras"], tcfg["data"]["spec_augment"]
    bins = int(mcfg["cnn_config"]["plane_bins"])
    eps = float(extras.get("label_smoothing", 0.0))
    steps, _ = first_batches(config, corpus, seed, n)
    p = {k: v.detach().clone() for k, v in weights.items()}
    p0 = {k: v.clone() for k, v in p.items()}
    opt = las_model.AMSGrad(tcfg["optimizer"], p)
    out = {"utts": [], "losses": [], "p0": p0, "inputs": []}
    with exact_float32():
        for k, b in enumerate(steps):
            X, y, n_real = bt.batch_arrays(corpus, feats, b)
            frame_len = frame_lengths(corpus, b, X.shape[0])
            if half:
                n_real = max(1, n_real // 2)
                X, y, frame_len = X[:n_real], y[:n_real], frame_len[:n_real]
            X = torch.from_numpy(X).to(device)
            y = torch.from_numpy(y).to(device)
            draws = las_model.make_draws(
                step_seed(f"bench-{seed}", 1, k), X.shape[0], bins,
                y.shape[1] - 1, float(extras["teach_ratio"]), spec, frame_len)
            leaves = {kk: v.requires_grad_(True) for kk, v in p.items()}
            inputs = []
            loss = las_model.train_loss(leaves, mcfg, X, y, n_real, draws,
                                        eps, mode, inputs, remat=True)
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
