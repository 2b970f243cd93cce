"""The data-parallel training driver: the program's trainer on ``ranks``
processes, one a device, each ``NN.train_epoch`` over its rows of a
global batch of ``ranks x rows_per_rank``, epoch after epoch, for the
window.

The run's own process is rank 0; it starts ranks 1 .. ranks - 1 as
processes of this file (``--rank``), which join one process group
(NCCL on CUDA devices, ``cuda:<rank>``; gloo on the CPU, for the tests)
at a free ``localhost`` port, as ``torchrun`` would start the program
(``cli/train.py``).  The configuration's ``train_cfg`` takes the global
batch size and ``parallel.data_axis: ranks``; each rank puts the same
weights of ``--seed`` into its trainer.  Set-up and warm-up are
``train.py``'s on every rank.  The window ends on every rank at the same
step: before every ``AgreedDeadline.EVERY``-th step the ranks agree,
over a gloo group on the host, whether rank 0's clock has passed the
window's end.  Rank 0 counts the steps and the utterances of the global
batches (``utts`` and ``n_real`` are the global batch's on every rank)
and the model FLOPs of its own rows, and in a traced run traces its own
device under ``torch.profiler`` (the busy time, the time in NCCL's
all-reduce kernels, the program's spans and counters) with its kernel
wrappers timed (``core.probes.KernelTimers``), as ``train.py`` does.

``correct``: the first three steps, each rank's share of the loss summed
over the ranks, the gradient of step 1 and the parameters after three
steps (rank 0's: the all-reduce leaves every rank the same), against
``train_check``'s reference over the global batch of ``ranks x
rows_per_rank`` rows.

A rank that fails ends the run: rank 0 watches the others and exits
with their error, and every collective has a time limit.
"""

import argparse
import contextlib
import copy
import datetime
import gc
import os
import socket
import subprocess
import sys
import threading
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from benchmark.core.corpus import SPLIT, Corpus, write_experiment  # noqa
from benchmark.core.probes import (  # noqa: E402
    Deadline, KernelTimers, StopWindow, timed_kernels)
from benchmark.core.weights import load_into, make_weights  # noqa: E402
from benchmark.reference import train_check  # noqa: E402
from benchmark.traffic.train import StepProbe, warm_steps  # noqa: E402
from benchmark.yardstick.model_flops import train_step_flops  # noqa: E402

# a collective or a rank's start that takes longer has failed
TIMEOUT_S = 600


def dp_config(config, mix):
    """The configuration at the mix's global batch over its ranks."""
    cfg = copy.deepcopy(config)
    ranks = int(mix["ranks"])
    cfg["train_cfg"]["batch_size"] = ranks * int(mix["rows_per_rank"])
    cfg["train_cfg"]["parallel"] = {"data_axis": ranks, "model_axis": 1}
    return cfg


class AgreedDeadline(Deadline):
    """A window's end that every rank meets at the same step: rank 0's
    clock decides, a gloo all-reduce on the host tells every rank, at
    every ``EVERY``-th step of the window (the window then ends up to
    ``EVERY - 1`` steps past its time, and its time is read there)."""

    EVERY = 8

    def __init__(self, device, group):
        super().__init__(device)
        self.group = group
        self.n = 0

    def check(self):
        if self.at is None:
            return
        self.n += 1
        if self.n % self.EVERY:
            return
        import torch.distributed as dist
        past = torch.tensor([int(dist.get_rank() == 0
                                 and time.perf_counter() >= self.at)])
        dist.all_reduce(past, op=dist.ReduceOp.MAX, group=self.group)
        if int(past):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.t_end = time.perf_counter()
            raise StopWindow()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join(rank, world, port, device):
    """Join the process group; returns the gloo group on the host."""
    import torch.distributed as dist
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dist.new_group(backend="gloo")


@contextlib.contextmanager
def _traced(on, rec):
    """The window, under torch.profiler's CUDA activity when ``on``:
    ``rec`` gets the busy seconds, the breakdown and the seconds of the
    all-reduce kernels."""
    if not on:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from benchmark.yardstick.trace import (
        breakdown, device_busy_ms, device_spans)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
    busy_ms, _ = device_busy_ms(prof)
    spans = device_spans(prof)
    rec["busy_s"] = busy_ms / 1e3
    rec["allreduce_s"] = sum(b - a for a, b, name in spans
                             if "AllReduce" in name) / 1e9
    rec["breakdown"] = breakdown(spans)


def rank_run(ctx, rank, world, port, t_start):
    """One rank's run; rank 0's record (other ranks: None)."""
    import torch.distributed as dist
    from ast_tpu_torch.train.trainer import NN

    device = (torch.device(f"cuda:{rank}") if ctx.device.type == "cuda"
              else ctx.device)
    group = _join(rank, world, port, device)
    cfg = dp_config(ctx.config, ctx.mix)
    spec = dict(ctx.mix["corpus"], vocab_words=cfg["vocab_size"] - 4)
    if rank == 0:
        corpus = Corpus(ctx.cache, spec)
    dist.barrier(group=group)
    if rank:
        corpus = Corpus(ctx.cache, spec)
    exp = write_experiment(
        os.path.join(ctx.cache, "exp", ctx.name, f"rank{rank}"), cfg, corpus,
        ctx.seed)
    nn = NN(exp, str(device))
    load_into(nn.params, make_weights(cfg["model_cfg"], corpus.vocab_size,
                                      ctx.seed, device))
    probe = StepProbe(nn, AgreedDeadline(device, group),
                      train_check.N_STEPS)
    with warm_steps(nn, train_check.N_STEPS):
        nn.train_epoch(SPLIT, epoch=1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    losses = torch.tensor([float(v) for v in probe.losses],
                          dtype=torch.float64)
    dist.all_reduce(losses, group=group)
    dist.barrier(group=group)
    rec = {"kind": "train", "setup_s": time.perf_counter() - t_start}

    deadline = probe.deadline
    traced = ctx.trace and rank == 0 and device.type == "cuda"
    kernels = timed_kernels(ctx.metrics) if traced else []
    timers = KernelTimers(kernels) if kernels else None
    with timers or contextlib.nullcontext(), _traced(traced, rec):
        probe.window = True
        t0 = time.perf_counter()
        deadline.at = t0 + ctx.seconds
        epoch = 2
        try:
            while True:
                nn.train_epoch(SPLIT, epoch=epoch)
                epoch += 1
        except StopWindow:
            pass
        rec["window_s"] = deadline.t_end - t0
    rec.update(attempted=probe.steps, failed=0, utts=probe.utts,
               memory_peak_bytes=(int(torch.cuda.max_memory_allocated(
                   device)) if device.type == "cuda" else 0))
    dtype = cfg["train_cfg"]["extras"].get("compute_dtype", "float32")
    rec["peak_flops"] = ctx.peak_flops(dtype)
    rec["model_flops"] = sum(
        train_step_flops(cfg["model_cfg"], corpus.vocab_size, B, T, U)
        for B, T, U in probe.shapes)
    if timers is not None:
        rec["kernels"] = timers.results()
    dist.barrier(group=group)
    dist.destroy_process_group()
    if rank:
        return None
    prog = {"utts": probe.utt_lists, "losses": losses.tolist(),
            "g1": probe.g1, "p": probe.p}
    probe.nn.train_step = probe.step
    probe.nn = nn = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    weights = make_weights(cfg["model_cfg"], corpus.vocab_size, ctx.seed,
                           device)
    data = corpus.as_dict(cfg["train_cfg"]["data"]["max_pred"])
    ref = train_check.reference_run(cfg, data, corpus.feats, weights,
                                    ctx.seed, device)
    rec["readings"] = train_check.compare(prog, ref)
    return rec


def _watch(procs):
    """End this process with a rank's error as soon as one fails."""
    def watch():
        while True:
            for p in procs:
                rc = p.poll()
                if rc not in (None, 0):
                    print(f"no result: rank {procs.index(p) + 1} exited "
                          f"with {rc}", file=sys.stderr, flush=True)
                    os._exit(1)
            if all(p.poll() == 0 for p in procs):
                return
            time.sleep(0.5)
    threading.Thread(target=watch, daemon=True).start()


def run(ctx):
    world = int(ctx.mix["ranks"])
    if ctx.device.type == "cuda":
        # one build of the kernels, before the other ranks load it
        from ast_tpu_torch.kernels import build
        build.library()
    port = _free_port()
    args = ["--root", ctx.root, "--workload", ctx.name, "--seed",
            str(ctx.seed), "--seconds", str(ctx.seconds), "--port",
            str(port), "--world", str(world), "--device",
            ctx.device.type]
    # the ranks import what this process imports
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in sys.path if p and os.path.isdir(p)))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--rank", str(r)] + args, env=env)
             for r in range(1, world)]
    _watch(procs)
    try:
        rec = rank_run(ctx, 0, world, port, ctx.t_start)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    for p in procs:
        try:
            p.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
    return rec


def _child_main():
    from benchmark.core.cli import Context
    ap = argparse.ArgumentParser()
    for name in ("--root", "--workload", "--device"):
        ap.add_argument(name, required=True)
    for name in ("--seed", "--port", "--world", "--rank"):
        ap.add_argument(name, type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args()
    t_start = time.perf_counter()
    os.environ["TRITON_CACHE_DIR"] = os.path.join(a.root, ".cache", "triton")
    import json

    def load(*parts):
        with open(os.path.join(a.root, *parts)) as f:
            return json.load(f)
    cell = load("workloads", f"{a.workload}.json")
    ctx = Context(a.root, a.workload, cell,
                  load("configs", f"{cell['config']}.json"),
                  load("traffic", f"{cell['traffic']}.json"),
                  argparse.Namespace(seed=a.seed, seconds=a.seconds,
                                     trace=0),
                  torch.device(a.device), t_start)
    rank_run(ctx, a.rank, a.world, a.port, t_start)


if __name__ == "__main__":
    _child_main()
