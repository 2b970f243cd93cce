"""Training harness: the ``NN`` facade of ``ast_tpu/train/trainer.py``.

``NN(cfg_path, device)`` builds the config, the bucketed data loader,
the model and the optimizer for one experiment directory and resumes
from its latest checkpoint; ``train_epoch`` runs one epoch of training
steps, ``predict`` greedy-decodes a split, ``save`` writes the epoch's
snapshot (params, BN state and optimizer state, in ``ast_tpu``'s
flat-NPZ layout).

One step: the host batch goes to the device; its random numbers
(speech noise, dropout seeds, scheduled-sampling coins) are drawn from
generators seeded by ``stable_seed(f"{seed}|{epoch}|{batch}")``, so a
rerun or a resumed epoch replays the same draws.  The gradients need not
be bit-equal between runs on a GPU: the embedding gradient's
``index_add_`` and cuDNN's conv backward sum with atomics, in no fixed
order.  ``forward_loss`` runs the conv front-end, K1 (train), K3 and the
loss, autograd runs K4, K2 and the weight-gradient GEMMs; the update is
added to the parameters in place.  Losses stay on the device until the
epoch's end.  Not ported (ROADMAP.md queue 1): multi-step dispatch,
prefetch threads, in-flight snapshots and preemption, data parallelism
and ``eval_loss``.
"""

import os
import time

import numpy as np
import torch

from ast_tpu_torch.config import Config
from ast_tpu_torch.checkpoint import (
    checkpoint_path, flatten, latest_checkpoint, load_checkpoint,
    save_checkpoint, unflatten)
from ast_tpu_torch.data.dataloader import make_dataloader
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.ops.fused_infer import require_train_variant
from ast_tpu_torch.params import torch_device, tree_map
from ast_tpu_torch.train.optimizer import (
    build_optimizer, tree_leaves, tree_unflatten)
from ast_tpu_torch.utils.seeding import stable_seed


def to_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def merge(template, loaded, what):
    """``loaded`` (numpy tree) as torch tensors in ``template``'s place:
    the same flat keys, shapes and dtypes, or ValueError."""
    want = flatten(to_numpy(template))
    got = flatten(loaded)
    if sorted(want) != sorted(got):
        raise ValueError(f"{what}: keys differ from this model's "
                         f"({sorted(set(want) ^ set(got))[:4]} ...)")
    for k, a in want.items():
        if np.shape(a) != np.shape(got[k]):
            raise ValueError(f"{what}: {k} has shape {np.shape(got[k])}, "
                             f"not {np.shape(a)}")
    device = tree_leaves(template)[0].device
    return tree_map(lambda a: torch.as_tensor(a).to(device),
                    unflatten({k: np.asarray(v, want[k].dtype)
                               for k, v in got.items()}))


class StepTimer:
    """Wall time and items over externally timed regions."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time, self.total_items = 0.0, 0

    def add(self, dt, n_items):
        self.total_time += dt
        self.total_items += n_items

    @property
    def items_per_sec(self):
        return self.total_items / self.total_time if self.total_time else 0.0


class NN:
    """Model, optimizer and data of one experiment directory."""

    def __init__(self, cfg_path, device="cuda"):
        self.device = torch_device(device)
        self.cfg = Config(cfg_path)
        self.model_dir = self.cfg.model["model_dir"]
        self.mcfg = self.cfg.model
        tcfg = self.cfg.train
        require_train_variant(self.mcfg, tcfg)
        self.seed = stable_seed(tcfg["seed"], bits=31)
        self.data_loader = make_dataloader(tcfg, self.model_dir)
        self.params, self.state = seq2seq.init_model(
            self.mcfg, seed=self.seed, device=self.device)
        self.opt, self.opt_state = build_optimizer(tcfg["optimizer"],
                                                   self.params)
        ckpt, epoch = latest_checkpoint(self.model_dir)
        self.max_epoch = 0
        if ckpt is not None:
            self._load_snapshot(load_checkpoint(ckpt))
            self.max_epoch = epoch
        for p in tree_leaves(self.params):
            p.requires_grad_(True)
        self.train_log = os.path.join(self.model_dir, "train.log")
        self.dev_log = os.path.join(self.model_dir, "dev.log")
        # tail batches pad to a repeated half of the batch size, kept a
        # multiple of 8 rows (ast_tpu on one device)
        self.tail_shrink = (8 if tcfg["extras"].get("shrink_tail_batches",
                                                    True) else 0)
        self.timer = StepTimer()

    def _load_snapshot(self, loaded):
        self.params = merge(self.params, loaded["params"], "params")
        if loaded.get("state") is not None:
            self.state = merge(self.state, loaded["state"], "state")
        if loaded.get("opt") is not None:
            try:
                self.opt_state = merge(self.opt_state, loaded["opt"], "opt")
            except ValueError as e:
                print(f"warning: optimizer state not restored ({e}); "
                      "restarting moments")

    def train_step(self, batch, seed):
        """One update from a host batch; returns the loss (on device)."""
        extras = self.cfg.train["extras"]
        X = torch.from_numpy(batch["X"]).to(self.device)
        y = torch.from_numpy(batch["y"]).to(self.device).long()
        draws = seq2seq.make_draws(seed, X, y.shape[1] - 1,
                                   extras["teach_ratio"],
                                   extras["speech_noise"])
        loss, new_state = seq2seq.forward_loss(
            self.params, self.state, self.mcfg, X, y,
            float(batch["n_real"]), draws)
        leaves = tree_leaves(self.params)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            updates, self.opt_state = self.opt.update(
                tree_unflatten(self.params, grads), self.opt_state,
                self.params)
            torch._foreach_add_(leaves, tree_leaves(updates))
        self.state = new_state
        return loss.detach()

    def train_epoch(self, set_key, epoch=0):
        """One epoch over ``set_key`` in the loader's order for ``epoch``;
        returns the mean over batches of loss / real rows."""
        tcfg = self.cfg.train
        gen = self.data_loader.get_batch(
            tcfg["batch_size"], set_key, train=True, labels=True,
            curriculum=tcfg.get("curriculum", False), epoch=epoch,
            tail_shrink=self.tail_shrink)
        losses, sizes = [], []
        t0 = time.perf_counter()
        for i, batch in enumerate(gen):
            losses.append(self.train_step(
                batch, stable_seed(f"{self.seed}|{epoch}|{i}")))
            sizes.append(max(1, len(batch["utts"])))
        if not losses:
            return 0.0
        vals = torch.stack(losses).cpu().numpy()     # the epoch's one sync
        self.timer.add(time.perf_counter() - t0, sum(sizes))
        return float(sum(v / s for v, s in zip(vals, sizes)) / len(vals))

    def predict(self, set_key):
        """Greedy-decode a split (K1 eval + K5): [(utt, ids)] with each
        row's full ``max_pred`` ids."""
        tcfg = self.cfg.train
        stop_limit = tcfg["data"]["max_pred"]
        preds = []
        with torch.inference_mode():
            w = seq2seq.decode_weights(self.params)   # once for the split
            for batch in self.data_loader.get_batch(
                    tcfg["batch_size"], set_key, train=False, labels=False,
                    tail_shrink=self.tail_shrink):
                X = torch.from_numpy(batch["X"]).to(self.device)
                p, _ = seq2seq.predict_greedy(self.params, self.state,
                                              self.mcfg, X, stop_limit, w)
                p = p[:len(batch["utts"])].cpu().numpy()
                preds.extend(zip(batch["utts"], p.tolist()))
        return preds

    def save(self, epoch):
        save_checkpoint(checkpoint_path(self.model_dir, epoch),
                        to_numpy(self.params), to_numpy(self.state),
                        to_numpy(self.opt_state))
