"""The training driver: ``NN.train_epoch`` over a mix's corpus, epoch
after epoch, for the window.

Set-up builds the program's trainer (``ast_tpu_torch.train.trainer.NN``)
on the run's experiment directory, puts the benchmark's weights of
``--seed`` into it, and trains the start of epoch 1 through the window's
own call and feed (``warm_steps``): its first three steps, the ones held
against the reference, then the first run of each bucket, so that every
shape of the mix and a full run of ``steps_per_dispatch`` steps is met.
The window then trains epochs 2, 3, ... on the same object and ends at
the first step boundary past ``--seconds``: the device drained, the
time read.  It counts the steps and the utterances of the steps completed.
After the window the program is freed and the reference trains the same
three steps (``benchmark.reference.train_check``).
"""

import functools
import gc
import os
import sys
import time

import torch

from benchmark.core.corpus import SPLIT, Corpus, write_experiment
from benchmark.core.probes import (
    Deadline, KernelTimers, StopWindow, instance_attr, timed_kernels)
from benchmark.core.weights import flat_leaves, load_into, make_weights
from benchmark.reference import train_check
from benchmark.yardstick.model_flops import train_step_flops



def _moments(opt_state):
    """The program's AMSGrad first moment tree: the chain link [count,
    mu, nu, nu_max]."""
    for link in opt_state:
        if (isinstance(link, list) and len(link) == 4
                and torch.is_tensor(link[0]) and link[0].dim() == 0):
            return link[1]
    raise ValueError("no AMSGrad state in the program's optimizer chain")


def _shape(batch):
    """(rows, frames, target columns) of a step's batch."""
    X = batch.get("X")
    if X is None:
        X = batch["drop_mask"]
    return int(X.shape[0]), int(X.shape[1]), int(batch["y"].shape[1])


class StepProbe:
    """Stands in for ``nn.train_step``: counts the window's steps, keeps
    the first ``n_check`` steps' readings, ends the window."""

    def __init__(self, nn, deadline, n_check, stop_after_check=False):
        self.nn, self.step = nn, nn.train_step
        self.deadline, self.n_check = deadline, n_check
        self.stop_after_check = stop_after_check
        self.n = 0
        self.window = False
        self.steps, self.utts, self.shapes = 0, 0, []
        self.utt_lists, self.losses = [], []
        self.g1 = self.p = None
        nn.train_step = self

    def __call__(self, batch, seed):
        self.deadline.check()
        loss = self.step(batch, seed)
        self.n += 1
        if self.window:
            self.steps += 1
            self.utts += int(batch["n_real"])
            self.shapes.append(_shape(batch))
        elif self.n <= self.n_check:
            self.utt_lists.append(list(batch["utts"]))
            self.losses.append(loss)
            if self.n == 1:
                b1 = 0.9
                self.g1 = {k: v.detach().float() / (1 - b1) for k, v in
                           flat_leaves(_moments(self.nn.opt_state)).items()}
            if self.n == self.n_check:
                self.p = {k: v.detach().clone()
                          for k, v in flat_leaves(self.nn.params).items()}
                if self.stop_after_check:
                    raise StopWindow()
        return loss


def warm_steps(nn, n_first):
    """While installed (a context), the program's loader yields the first
    ``n_first`` batches of an epoch, then of each bucket the batches of
    its first run (up to ``steps_per_dispatch``) that it has not yet
    yielded, in the epoch's order."""
    get_batch, G = nn.data_loader.get_batch, nn.steps_per_dispatch

    def warm(*a, **kw):
        taken = {}
        for i, batch in enumerate(get_batch(*a, **kw)):
            b = batch["bucket"]
            if i < n_first or taken.get(b, 0) < G:
                taken[b] = taken.get(b, 0) + 1
                yield batch
    return instance_attr(nn.data_loader, "get_batch", warm)


def _setup(ctx, stop_after_check=False):
    """The program's trainer with the benchmark's weights and the probe
    around its step; (nn, probe, corpus)."""
    from ast_tpu_torch.train.trainer import NN

    cfg = ctx.config
    corpus = Corpus(ctx.cache, dict(ctx.mix["corpus"],
                                    vocab_words=cfg["vocab_size"] - 4))
    exp = write_experiment(os.path.join(ctx.cache, "exp", ctx.name), cfg,
                           corpus, ctx.seed)
    nn = NN(exp, str(ctx.device))
    load_into(nn.params, make_weights(cfg["model_cfg"], corpus.vocab_size,
                                      ctx.seed, ctx.device))
    probe = StepProbe(nn, Deadline(ctx.device), train_check.N_STEPS,
                      stop_after_check)
    return nn, probe, corpus


def _check(ctx, probe, corpus, controls=(), inputs=None):
    """Free the program, run the reference over the checked steps and
    compare: the readings, and with ``controls`` (precision modes, or
    ``half``: the half-batch fault in the reference) also each control's
    readings against the reference and where the gaps lie."""
    cfg = ctx.config
    prog = {"utts": probe.utt_lists,
            "losses": [float(v) for v in probe.losses],
            "g1": probe.g1, "p": probe.p, "inputs": inputs}
    probe.nn.train_step = probe.step
    probe.nn = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    weights = make_weights(cfg["model_cfg"], corpus.vocab_size, ctx.seed,
                           ctx.device)
    data = corpus.as_dict(cfg["train_cfg"]["data"]["max_pred"])

    def ref_run(mode):
        return train_check.reference_run(
            cfg, data, corpus.feats, weights, ctx.seed, ctx.device,
            "f32" if mode == "half" else mode, half=mode == "half")
    ref = ref_run("f32")
    out = {"readings": train_check.compare(prog, ref)}
    if controls:
        out["where"] = {"program": train_check.diagnose(prog, ref)}
    for mode in controls:
        low = ref_run(mode)
        out[mode] = train_check.compare(low, ref)
        out["where"][mode] = train_check.diagnose(low, ref)
    return out


def calibrate(ctx, controls):
    """The readings of the program's first steps and of ``controls``,
    without a window; the program's decoder inputs (K3's) are kept."""
    from ast_tpu_torch.ops import fused_decoder

    nn, probe, corpus = _setup(ctx, stop_after_check=True)
    forward, inputs = fused_decoder.decoder_forward, []

    @functools.wraps(forward)
    def kept(*a, **kw):
        ht, res = forward(*a, **kw)
        inputs.append(res["sel"].detach().clone())
        return ht, res
    fused_decoder.decoder_forward = kept
    try:
        nn.train_epoch(SPLIT, epoch=1)
    except StopWindow:
        pass
    finally:
        fused_decoder.decoder_forward = forward
    del nn
    return _check(ctx, probe, corpus, controls, inputs)


def run(ctx):
    nn, probe, corpus = _setup(ctx)
    deadline = probe.deadline
    V, mcfg = corpus.vocab_size, ctx.config["model_cfg"]
    with warm_steps(nn, train_check.N_STEPS):
        nn.train_epoch(SPLIT, epoch=1)
    ctx.sync()
    rec = {"kind": "train", "setup_s": time.perf_counter() - ctx.t_start}

    kernels = timed_kernels(ctx.metrics)
    timers = KernelTimers(kernels) if kernels else None
    with ctx.window(timers) as win:
        probe.window = True
        t0 = time.perf_counter()
        deadline.at = t0 + ctx.seconds
        epoch = 2
        try:
            while True:
                t, n = nn.timer.total_time, nn.timer.total_items
                nn.train_epoch(SPLIT, epoch=epoch)
                rate = ((nn.timer.total_items - n)
                        / (nn.timer.total_time - t))
                print(f"epoch {epoch}: {rate:.1f} utts/s", file=sys.stderr,
                      flush=True)
                epoch += 1
        except StopWindow:
            pass
        rec["window_s"] = deadline.t_end - t0
    rec.update(win.result())
    rec.update(attempted=probe.steps, failed=0, utts=probe.utts,
               memory_peak_bytes=ctx.memory_peak())
    dtype = ctx.config["train_cfg"]["extras"].get("compute_dtype", "float32")
    rec["peak_flops"] = ctx.peak_flops(dtype)
    rec["model_flops"] = sum(train_step_flops(mcfg, V, B, T, U)
                             for B, T, U in probe.shapes)
    if timers is not None:
        rec["kernels"] = timers.results()
    del nn
    rec.update(_check(ctx, probe, corpus))
    return rec
