"""Rank bodies of tests/test_torch_parallel.py's multi-process checks.

:func:`run_jobs` runs in each of the processes that
``torch.multiprocessing`` starts: it joins one gloo group on the CPU,
runs every job of the list in turn (a job: the name of a function below
and its arguments) and pickles each job's record to
``<out>.<job>.<rank>``.  One group serves every job, so the test module
pays a process start-up once.  This module imports ``ast_tpu_torch``
only (no JAX, no ``ast_tpu``): the JAX side of a comparison runs in the
test process.
"""

import hashlib
import pickle

import numpy as np
import torch
import torch.distributed as dist

from ast_tpu_torch import parallel
from ast_tpu_torch.checkpoint import flatten
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.params import from_jax_numpy
from ast_tpu_torch.train import trainer
from ast_tpu_torch.train.optimizer import tree_leaves, tree_unflatten


def run_jobs(rank, world, port, jobs, out):
    """Join a gloo group of ``world`` ranks and run ``jobs``, a list of
    (name, args), pickling job i's record to ``<out>.<i>.<rank>``."""
    torch.set_num_threads(1)
    parallel.init_distributed(f"localhost:{port}", world, rank, "gloo")
    try:
        for i, (name, args) in enumerate(jobs):
            rec = JOBS[name](rank, *args)
            with open(f"{out}.{i}.{rank}", "wb") as f:
                pickle.dump(rec, f)
    finally:
        dist.destroy_process_group()


def digest(params):
    """sha256 of every parameter leaf's bytes, in tree order."""
    h = hashlib.sha256()
    for t in tree_leaves(params):
        h.update(t.detach().numpy().tobytes())
    return h.hexdigest()


def collectives(rank):
    """The data-parallel collectives on rank-dependent values: the
    gradient sum, the eval gather, ``any_rank`` and ``replicate`` of a
    tree of mixed dtypes and odd sizes."""
    world = dist.get_world_size()
    mesh = parallel.make_mesh({}, batch_size=world)
    grads = parallel.all_reduce_grads(
        [torch.full((3, 5), float(rank + 1)), torch.arange(7.0) * rank],
        mesh)
    rows = parallel.gather_rows(
        [torch.full((2, 3), rank, dtype=torch.int32)], mesh)[0]
    tree = {"w": torch.full((3,), rank + 0.5, dtype=torch.bfloat16),
            "b": [torch.full((5,), rank - 1.0)],
            "n": torch.tensor(rank, dtype=torch.int32)}
    parallel.replicate([tree], mesh)
    return {"grads": [g.numpy() for g in grads], "rows": rows.numpy(),
            "any": [parallel.any_rank(rank == 1, mesh),
                    parallel.any_rank(False, mesh)],
            "tree": [tree["w"].float().numpy(), tree["b"][0].numpy(),
                     int(tree["n"])]}


def forward_loss(rank, inputs):
    """This rank's rows of ``inputs``' batch through ``forward_loss``
    with the shared draws, the gradients summed over the ranks."""
    with open(inputs, "rb") as f:
        a = pickle.load(f)
    B = a["X"].shape[0]
    mesh = parallel.make_mesh({}, batch_size=B)
    off, n = mesh.rows(B)
    mine = slice(off, off + n)
    params, state = from_jax_numpy(a["params"], a["state"])
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    draws = seq2seq.Draws(
        torch.from_numpy(a["noise"][mine]), a["enc_seed"], a["dec_seed"],
        torch.from_numpy(a["coins"]), row_offset=off, global_rows=B)
    loss, new_state = seq2seq.forward_loss(
        params, state, a["mcfg"], torch.from_numpy(a["X"][mine]),
        torch.from_numpy(a["y"][mine]).long(), a["n_real"], draws,
        mesh=mesh)
    grads = parallel.all_reduce_grads(torch.autograd.grad(loss, leaves),
                                      mesh)
    loss = parallel.all_reduce_sum(loss.detach(), mesh)
    return {"loss": float(loss),
            "grads": flatten(tree_unflatten(params, [g.numpy()
                                                     for g in grads])),
            "state": flatten(trainer.to_numpy(new_state))}


def train(rank, exp, preempt_rank=-1):
    """:func:`record` of ``exp`` on this rank; rank ``preempt_rank`` (-1:
    none) asks to stop before the epoch."""
    return record(exp, rank == preempt_rank)


def record(exp, preempt=False):
    """``NN.train_epoch`` (epoch 1) of ``exp``'s train split, then
    ``eval_loss``, ``predict`` and ``decode_beam_set`` (N = K = 2) of its
    dev split, in this process (one process: no group, no mesh).  With
    ``preempt`` the epoch is asked to stop before it starts."""
    nn = trainer.NN(exp, "cpu")
    rec = {"mesh": nn.mesh, "tail_shrink": nn.tail_shrink}
    if preempt:
        nn.request_preempt()
    try:
        rec["loss"] = nn.train_epoch("tiny_train", epoch=1)
    except trainer.PreemptedError as e:
        rec["preempted"] = str(e)
    rec.update(steps=nn.timer.n_steps, digest=digest(nn.params),
               params=flatten(trainer.to_numpy(nn.params)),
               state=flatten(trainer.to_numpy(nn.state)),
               opt=flatten(trainer.to_numpy(nn.opt_state)))
    if "preempted" not in rec:
        rec.update(eval_loss=nn.eval_loss("tiny_dev"),
                   preds=nn.predict("tiny_dev"),
                   beams=nn.decode_beam_set("tiny_dev", 2, 2))
    return rec


JOBS = {"collectives": collectives, "forward_loss": forward_loss,
        "train": train}


def arrays(flat):
    """The numpy leaves of a flattened tree."""
    return {k: v for k, v in flat.items() if isinstance(v, np.ndarray)}
