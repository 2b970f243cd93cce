"""Train an experiment on a GPU.

``python -m ast_tpu_torch.cli.train -m <exp_dir> -e <epochs>
[--profile LOGDIR] [--device cuda|cpu] [--dist-backend nccl|gloo]``

``torchrun --nproc-per-node N -m ast_tpu_torch.cli.train -m <exp_dir>
-e <epochs>`` trains over N processes, one a card, laid as the
experiment's (data, model) mesh (``train_cfg["parallel"]``: a data
axis, and with ``model_axis`` M > 1 the vocabulary split over M ranks;
``ast_tpu_torch.parallel``; several hosts: ``torchrun``'s ``--nnodes``
and rendezvous flags).  The CLI reads
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; ``--device cuda`` is then ``cuda:LOCAL_RANK``, while an
explicit ``--device cuda:0`` is taken as given (two ranks may share one
card over gloo: ``--device cuda:0 --dist-backend gloo``).  The backend
is NCCL for CUDA ranks and gloo for CPU ones unless ``--dist-backend``
says which.  Every rank decodes its rows of the dev split and scores
BLEU on the gathered whole; only rank 0 writes ``train.log``,
``dev.log`` and checkpoints.

The counterpart of ``ast_tpu/cli/train.py``, with the same epoch cycle:
train one epoch, append ``epoch, loss`` to ``train.log``, greedy-decode
the dev split, detokenise, score BLEU with ``ast_tpu_torch.eval.bleu.Eval``,
append ``epoch, bleu`` to ``dev.log``, and save
``seq2seq_<epoch>.model.npz`` every ``iters_save`` epochs and at the
last one.  It resumes from the latest checkpoint (``max_epoch + 1``) or,
after a run that SIGTERM stopped, in the middle of that run's epoch: the
signal makes the epoch write ``seq2seq_inflight.npz`` at the next batch
boundary and the run exit cleanly.  ``--profile`` writes a
``torch.profiler`` Chrome trace of the first training epoch into LOGDIR,
with the epoch's spans (``train.*``, ``feed.*``) beside the kernels,
and ``idle_by_span_<time>.json``: the device's idle time put down to the
span the host was in (``utils.profiling.idle_by_span``).
On ``--device cuda`` every kernel of the path is a hand-written CUDA
kernel; ``--device cpu`` runs their plain versions.  With
``extras.compute_dtype: "bfloat16"`` in ``train_cfg.json`` the steps, the
dev loss and the dev decode run at bf16 (the kernels' bf16 modes).
"""

import argparse
import contextlib
import os
import signal

import torch

from ast_tpu_torch.eval.bleu import Eval
from ast_tpu_torch.parallel import default_backend, init_distributed
from ast_tpu_torch.train.trainer import NN, PreemptedError


def _install_preempt_handler(nn):
    """SIGTERM => snapshot at the next batch boundary and exit cleanly;
    the next run resumes mid-epoch."""
    def handler(signum, frame):
        print("SIGTERM received: snapshotting at next batch boundary",
              flush=True)
        nn.request_preempt()

    try:
        signal.signal(signal.SIGTERM, handler)
    except ValueError:
        pass  # not the main thread (e.g. under a test runner)


def launch(device, backend=None, env=None):
    """Join the process group that ``torchrun`` (or another launcher)
    describes in ``env`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``) and return this rank's device: a
    bare ``cuda`` becomes ``cuda:LOCAL_RANK`` under a launcher.  One
    process joins nothing."""
    env = os.environ if env is None else env
    world = int(env.get("WORLD_SIZE", 1))
    if device == "cuda" and "LOCAL_RANK" in env:
        device = f"cuda:{int(env['LOCAL_RANK'])}"
    if world > 1:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        init_distributed(
            f"{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}",
            world, int(env["RANK"]), backend or default_backend(device))
    return device


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train and evaluate model")
    parser.add_argument("-m", "--cfg_path", required=True,
                        help="experiment directory")
    parser.add_argument("-e", "--epochs", required=True, type=int,
                        help="number of epochs")
    parser.add_argument("--profile", default=None, metavar="LOGDIR",
                        help="write a torch.profiler trace of the first "
                             "training epoch and its idle time by span "
                             "into LOGDIR")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda, under torchrun "
                             "cuda:LOCAL_RANK; cpu runs the plain PyTorch "
                             "versions of the kernels)")
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"),
                        default=None,
                        help="torch.distributed backend of a multi-process "
                             "run (default nccl on CUDA, gloo on the CPU)")
    args = parser.parse_args(argv)
    print(f"number of epochs={args.epochs:d}")
    device = launch(args.device, args.dist_backend)
    try:
        run(args, NN(args.cfg_path, device))
        if torch.distributed.is_initialized():
            torch.distributed.barrier()     # no rank leaves mid-exchange
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run(args, nn):
    """The epochs of ``args`` (``main``'s) on the built ``nn``."""
    _install_preempt_handler(nn)
    tcfg = nn.cfg.train
    train_key, dev_key = tcfg["train_set"], tcfg["dev_set"]
    metrics = Eval(os.path.join(tcfg["data"]["refs_path"], dev_key),
                   tcfg["data"]["n_evals"])

    start_epoch = nn.max_epoch + 1
    max_epoch = start_epoch + args.epochs
    for epoch in range(start_epoch, max_epoch):
        print("-" * 80)
        print(f"Experiment: {args.cfg_path:s} epoch: {epoch:d}")
        print("-" * 80)
        trace = contextlib.nullcontext()
        if args.profile and epoch == start_epoch:
            from ast_tpu_torch.utils.profiling import profile_trace
            trace = profile_trace(args.profile)
        try:
            with trace:
                loss = nn.train_epoch(train_key, epoch=epoch)
        except PreemptedError as e:
            print(str(e))
            print("exiting cleanly; rerun to resume mid-epoch")
            return
        if nn.primary:
            with open(nn.train_log, mode="a") as f:
                f.write(f"{epoch:d}, {loss:.4f}\n")

        # a SIGTERM between the batch loop and the dev decode: keep the
        # finished epoch (nothing else holds it when no in-epoch
        # snapshots are written and no periodic save is due)
        if nn.preempt_pending():
            print("preempted after training phase; saving epoch "
                  "checkpoint and exiting cleanly")
            nn.save(epoch)
            return

        hyps = nn.data_loader.get_hyps(nn.predict(dev_key))
        bleu = metrics.calc_bleu(hyps) * 100
        if nn.primary:
            with open(nn.dev_log, mode="a") as f:
                f.write(f"{epoch:d}, {bleu:.2f}\n")
        print(f"BLEU = {bleu:.2f}")
        print(f"train throughput = {nn.timer.items_per_sec:.1f} utts/sec")
        nn.timer.reset()
        print("-" * 80)
        saved = epoch % tcfg["iters_save"] == 0 or epoch == max_epoch - 1
        if saved:
            print("Saving model")
            nn.save(epoch)
            print("Finished saving model")

        if nn.preempt_pending():
            if not saved:
                nn.save(epoch)      # keep the epoch just trained
            print("preempted after eval phase; exiting cleanly")
            return


if __name__ == "__main__":
    main()
