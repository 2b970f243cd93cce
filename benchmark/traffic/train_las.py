"""The LAS training driver: ``NN.train_epoch`` over a mix's corpus, epoch
after epoch, for the window, with LAS-6-1280's weights, FLOP count,
kernel timers and reference.

It is ``train.py``'s run with what this model changes: the weights
(``core/las_weights.py``), the listener's layers as K1 / K2 calls of one
layer each (``k1_train`` / ``k2`` timed by ``core.probes``), the
training decoder's kernels at encoder states wider than the decoder
(``k3_wide`` / ``k4_wide``, ``core.wide_probes``), the model FLOPs
(``yardstick/las_flops.py``) and the check (``reference/las_check.py``,
the readings of ``train_check.compare``).

A program that does not know ``rnn_config.enc_stacking`` (a listener
whose layers read both directions of the layer below) would train
another model: before anything else this module builds the program's
model at a tiny size on the host and gives no result, at once, unless
its layer 1 reads both directions.
"""

import contextlib
import functools
import gc
import os
import sys
import time

import torch

from benchmark.core.corpus import SPLIT, Corpus, write_experiment
from benchmark.core.las_weights import make_weights
from benchmark.core.probes import (
    Deadline, KernelTimers, StopWindow, timed_kernels)
from benchmark.core.weights import load_into
from benchmark.core.wide_probes import WideTimers, timed_wide
from benchmark.reference import las_check, train_check
from benchmark.traffic.train import StepProbe, warm_steps
from benchmark.yardstick.las_flops import train_step_flops


def require_joint_stacking(mcfg):
    """Raise SystemExit unless the program builds ``mcfg``'s listener
    jointly stacked (checked on a copy cut to 2 layers of 32 units on the
    host)."""
    from ast_tpu_torch.models import seq2seq

    tiny = {k: dict(v) if isinstance(v, dict) else v
            for k, v in mcfg.items()}
    tiny["rnn_config"] = dict(mcfg["rnn_config"], enc_layers=2,
                              enc_units=32, hidden_units=32, attn_units=32,
                              embedding_units=32, dec_vocab_size=8)
    params, _ = seq2seq.init_model(tiny, seed=0)
    wx = params["enc"]["lstm"][1]["wx"]
    if wx.shape[-2] != 64:
        raise SystemExit("no result: the program does not stack the "
                         "listener's layers jointly (rnn_config."
                         "enc_stacking); its layer 1 reads "
                         f"{wx.shape[-2]} inputs, not 64")


def _setup(ctx, stop_after_check=False):
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
    compare: the readings; with ``inputs`` (the program's decoder inputs
    of the checked steps) also where the gaps lie, the decoder inputs
    that differ from the reference's among them; with ``controls``
    (precision modes, or ``half``: the half-batch fault in the
    reference) each control's readings against the reference and where
    its gaps lie."""
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
        return las_check.reference_run(
            cfg, data, corpus.feats, weights, ctx.seed, ctx.device,
            "f32" if mode == "half" else mode, half=mode == "half")
    ref = ref_run("f32")
    out = {"readings": train_check.compare(prog, ref)}
    if controls or inputs is not None:
        out["where"] = {"program": train_check.diagnose(prog, ref)}
    for mode in controls:
        low = ref_run(mode)
        out[mode] = train_check.compare(low, ref)
        out["where"][mode] = train_check.diagnose(low, ref)
    return out


def calibrate(ctx, controls):
    """The readings of the program's first steps and of ``controls``,
    without a window, and where the gaps lie: the program's decoder
    inputs (K3's) are kept."""
    from ast_tpu_torch.ops import fused_decoder

    require_joint_stacking(ctx.config["model_cfg"])
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
    mcfg = ctx.config["model_cfg"]
    require_joint_stacking(mcfg)
    nn, probe, corpus = _setup(ctx)
    deadline = probe.deadline
    with warm_steps(nn, train_check.N_STEPS):
        nn.train_epoch(SPLIT, epoch=1)
    ctx.sync()
    rec = {"kind": "train", "setup_s": time.perf_counter() - ctx.t_start}

    kernels, wide = timed_kernels(ctx.metrics), timed_wide(ctx.metrics)
    timers = KernelTimers(kernels) if kernels else None
    wide_timers = WideTimers(wide) if wide else None
    with ctx.window(timers) as win, (
            wide_timers or contextlib.nullcontext()):
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
    rec["model_flops"] = sum(train_step_flops(mcfg, corpus.vocab_size, B, T,
                                              U)
                             for B, T, U in probe.shapes)
    rec["kernels"] = {}
    for t in (timers, wide_timers):
        if t is not None:
            rec["kernels"].update(t.results())
    print(f"steps {probe.steps} shapes "
          f"{sorted(set(probe.shapes))}", file=sys.stderr, flush=True)
    del nn
    rec.update(_check(ctx, probe, corpus))
    # every reading, those the cell's limits leave out too
    print(f"readings {rec['readings']}", file=sys.stderr, flush=True)
    return rec
