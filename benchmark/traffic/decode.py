"""The beam-decoding driver: ``NN.decode_beam_set`` over a mix's
corpus, pass after pass, for the window.

Set-up builds the program's trainer on the run's experiment directory
with the benchmark's weights of ``--seed`` and decodes the first batch
of each padded width of the split (``first_of_each_bucket``), through
the window's own call.  The window decodes passes of
the split (N, K and the batch from the mix, ``max_pred`` the
configuration's stop) and ends at the first batch boundary past
``--seconds``: the device drained, the time read.  It counts the
utterances of the batches decoded and keeps their answers.  After the
window the program is freed and the reference reads a sample of the
answers drawn from the seed, the longest utterance's among them
(``benchmark.reference.beam_check``).
"""

import gc
import os
import random
import time

import torch

from benchmark.core.corpus import SPLIT, Corpus, write_experiment
from benchmark.core.probes import (
    Deadline, KernelTimers, StopWindow, instance_attr, timed_kernels)
from benchmark.core.weights import load_into, make_weights
from benchmark.reference import beam_check
from benchmark.yardstick.model_flops import beam_flops


class DecodeProbe:
    """Wraps the program's beam decoder and feature call: each decoded
    batch's utterances and answers (device tensors) are kept; the
    deadline is checked before each batch."""

    def __init__(self, nn, deadline):
        from ast_tpu_torch.ops import beam as beam_ops
        self.beam_ops, self.make = beam_ops, beam_ops.make_beam_decoder
        self.nn, self.features = nn, nn.features
        self.deadline = deadline
        self.window = False
        self.cur = None
        self.batches = []
        nn.features = self._features
        beam_ops.make_beam_decoder = self._make

    def _features(self, batch):
        self.cur = batch
        return self.features(batch)

    def _make(self, *a, **kw):
        decode = self.make(*a, **kw)

        def probed(params, state, X, w=None, enc_mask=None):
            self.deadline.check()
            out = decode(params, state, X, w, enc_mask)
            if self.window:
                self.batches.append((list(self.cur["utts"]),
                                     int(X.shape[1]), out))
            return out
        return probed

    def close(self):
        self.beam_ops.make_beam_decoder = self.make
        self.nn.features = self.features


def _setup(ctx):
    """The program's trainer at the mix's stop, with the benchmark's
    weights and the probe; (nn, probe, corpus, cfg)."""
    from ast_tpu_torch.train.trainer import NN

    cfg, mix = ctx.config, ctx.mix
    corpus = Corpus(ctx.cache, dict(mix["corpus"],
                                    vocab_words=cfg["vocab_size"] - 4))
    cfg = dict(cfg, train_cfg=dict(cfg["train_cfg"]))
    cfg["train_cfg"]["data"] = dict(cfg["train_cfg"]["data"])
    if "max_pred" in mix:
        cfg["train_cfg"]["data"]["max_pred"] = mix["max_pred"]
    exp = write_experiment(os.path.join(ctx.cache, "exp", ctx.name), cfg,
                           corpus, ctx.seed)
    nn = NN(exp, str(ctx.device))
    load_into(nn.params, make_weights(cfg["model_cfg"], corpus.vocab_size,
                                      ctx.seed, ctx.device))
    return nn, DecodeProbe(nn, Deadline(ctx.device)), corpus, cfg


def first_of_each_bucket(nn):
    """While installed (a context), the program's loader yields only the
    first batch of each bucket of a split: one of each padded width."""
    get_batch = nn.data_loader.get_batch

    def firsts(*a, **kw):
        seen = set()
        for batch in get_batch(*a, **kw):
            if batch["bucket"] not in seen:
                seen.add(batch["bucket"])
                yield batch
    return instance_attr(nn.data_loader, "get_batch", firsts)


def _answers(probe):
    """[(names, padded width, hyps, scores, lengths on the host)] of the
    kept batches."""
    return [(names, T, hyps, scores, lengths.cpu().numpy())
            for names, T, (hyps, scores, lengths) in probe.batches]


def _check(ctx, corpus, cfg, answers, controls=()):
    """Sample the answers from the seed (the longest utterance's among
    them), free the program's tensors, read the reference: the
    readings, and each control's."""
    K = ctx.mix["beam"][1]
    index = {n: i for i, n in enumerate(corpus.names)}
    flat = [(b, j) for b, a in enumerate(answers) for j in range(len(a[0]))]
    rng = random.Random(ctx.seed)
    pick = rng.sample(flat, min(int(ctx.mix.get("sample", 32)) - 1,
                                len(flat)))
    longest = max(flat, key=lambda bj: corpus.frames[
        index[answers[bj[0]][0][bj[1]]]])
    chosen = []
    for b, j in pick + [longest]:
        names, _, hyps, scores, lengths = answers[b]
        chosen.append((index[names[j]], hyps[j].cpu().numpy(), lengths[j],
                       scores[j].cpu().numpy()))
    answers.clear()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    weights = make_weights(cfg["model_cfg"], corpus.vocab_size, ctx.seed,
                           ctx.device)
    data = corpus.as_dict(cfg["train_cfg"]["data"]["max_pred"])
    out = {"readings": beam_check.readings(cfg, data, corpus.feats, weights,
                                           chosen, K, ctx.device)}
    for mode in controls:
        out[mode] = beam_check.readings(cfg, data, corpus.feats, weights,
                                        chosen, K, ctx.device, mode)
    return out


def calibrate(ctx, controls):
    """The readings of one pass of the split and of ``controls`` (a
    precision, or ``last_step``) on the same sample, without a
    window."""
    nn, probe, corpus, cfg = _setup(ctx)
    N, K = ctx.mix["beam"]
    probe.window = True
    nn.decode_beam_set(SPLIT, N, K, batch_size=ctx.mix["batch"])
    probe.close()
    answers = _answers(probe)
    del nn, probe
    return _check(ctx, corpus, cfg, answers, controls)


def run(ctx):
    nn, probe, corpus, cfg = _setup(ctx)
    deadline = probe.deadline
    mix = ctx.mix
    V, mcfg = corpus.vocab_size, cfg["model_cfg"]
    N, K = mix["beam"]
    with first_of_each_bucket(nn):
        nn.decode_beam_set(SPLIT, N, K, batch_size=mix["batch"])
    ctx.sync()
    rec = {"kind": "decode", "setup_s": time.perf_counter() - ctx.t_start}

    kernels = timed_kernels(ctx.metrics)
    timers = KernelTimers(kernels) if kernels else None
    with ctx.window(timers) as win:
        probe.window = True
        t0 = time.perf_counter()
        deadline.at = t0 + ctx.seconds
        try:
            while True:
                nn.decode_beam_set(SPLIT, N, K, batch_size=mix["batch"])
        except StopWindow:
            pass
        rec["window_s"] = deadline.t_end - t0
    rec.update(win.result())
    probe.close()
    answers = _answers(probe)
    utts = sum(len(a[0]) for a in answers)
    rec.update(attempted=utts, failed=0, utts=utts,
               memory_peak_bytes=ctx.memory_peak())
    dtype = cfg["train_cfg"]["extras"].get("compute_dtype", "float32")
    rec["peak_flops"] = ctx.peak_flops(dtype)
    rec["model_flops"] = sum(
        beam_flops(mcfg, V, hyps.shape[0], T, N, int(lengths.max()) - 1)
        for _, T, hyps, _, lengths in answers)
    if timers is not None:
        rec["kernels"] = timers.results()
    del nn, probe
    rec.update(_check(ctx, corpus, cfg, answers))
    return rec
