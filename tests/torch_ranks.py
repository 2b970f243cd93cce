"""Rank bodies of the multi-process checks of tests/test_torch_parallel.py
and tests/test_torch_model_axis.py.

:func:`run_jobs` runs in each of the processes that
``torch.multiprocessing`` starts: it joins one gloo group on the CPU,
runs every job of the list in turn (a job: the name of a function below
and its arguments) and pickles each job's record to
``<out>.<job>.<rank>``.  One group serves every job, so the test module
pays a process start-up once; :func:`run_groups` starts several groups
of different sizes in one spawn.  This module imports ``ast_tpu_torch``
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
        dist.barrier()          # no rank leaves mid-exchange
    finally:
        dist.destroy_process_group()


def run_groups(i, groups, out):
    """Process ``i`` of one spawn over several gloo groups: ``groups`` a
    list of (world, port, jobs), filled in order by the processes; runs
    its group's :func:`run_jobs` with the records at ``<out>.g<group>``."""
    for g, (world, port, jobs) in enumerate(groups):
        if i < world:
            return run_jobs(i, world, port, jobs, f"{out}.g{g}")
        i -= world


def digest(params, replicated_only=False):
    """sha256 of every parameter leaf's bytes, in tree order (with
    ``replicated_only``, of the leaves no model axis shards)."""
    h = hashlib.sha256()
    for k, t in flatten(params, leaf=lambda t: t).items():
        if torch.is_tensor(t) and not (replicated_only
                                       and parallel.leaf_spec(k)):
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


def train(rank, exp, preempt_rank=-1, then_save=False):
    """:func:`record` of ``exp`` on this rank; rank ``preempt_rank`` (-1:
    none) asks to stop before the epoch; ``then_save``: see
    :func:`record`."""
    return record(exp, rank == preempt_rank, then_save)


def resume(rank, exp, epoch):
    """``NN(exp)`` (the latest checkpoint, or a newer in-flight
    snapshot) trains ``epoch``: its loss, steps and whole state."""
    nn = trainer.NN(exp, "cpu")
    rec = {"mesh": nn.mesh, "max_epoch": nn.max_epoch,
           "inflight": nn.inflight_resume,
           "loss": nn.train_epoch("tiny_train", epoch=epoch),
           "steps": nn.timer.n_steps}
    rec.update(whole(nn))
    return rec


def whole(nn):
    """``nn``'s parameters, BN state and optimizer state, each vocab
    shard gathered whole, as flat numpy dicts (copies: training on
    moves the CPU tensors in place); the digests of every leaf this rank
    holds and of the replicated leaves."""
    return {"digest": digest(nn.params),
            "replicated": digest(nn.params, replicated_only=True),
            "params": flatten(trainer.to_numpy(nn.whole_params()),
                              leaf=np.array),
            "state": flatten(trainer.to_numpy(nn.state), leaf=np.array),
            "opt": flatten(trainer.to_numpy(parallel.gather_params(
                nn.opt_state, nn.mesh)), leaf=np.array)}


def first_step(nn):
    """Wrap ``nn``'s optimizer update and train step so that the dict
    returned gets the first step's gradients (summed over the data
    group, each vocab shard gathered whole) under ``"grads"`` and the BN
    state after it under ``"state"``, as flat numpy dicts; later steps
    run as they are."""
    got = {}
    update, step = nn.opt.update, nn.train_step

    def update_first(grads, *args):
        if "grads" not in got:
            got["grads"] = flatten(trainer.to_numpy(parallel.gather_params(
                grads, nn.mesh)), leaf=np.array)
        return update(grads, *args)

    def step_first(*args):
        loss = step(*args)
        if "state" not in got:
            got["state"] = flatten(trainer.to_numpy(nn.state), leaf=np.array)
        return loss
    nn.opt.update, nn.train_step = update_first, step_first
    return got


def record(exp, preempt=False, then_save=False):
    """``NN.train_epoch`` (epoch 1) of ``exp``'s train split, then
    ``eval_loss``, ``predict`` and ``decode_beam_set`` (N = K = 2) of its
    dev split, in this process (one process: no group, no mesh); the
    epoch's first step under ``"first"`` (:func:`first_step`).  With
    ``preempt`` the epoch is asked to stop before it starts.  With
    ``then_save``, after them ``save(1)`` and epoch 2: its loss and
    whole state under ``"next"``."""
    nn = trainer.NN(exp, "cpu")
    rec = {"mesh": nn.mesh, "tail_shrink": nn.tail_shrink,
           "first": first_step(nn)}
    if preempt:
        nn.request_preempt()
    try:
        rec["loss"] = nn.train_epoch("tiny_train", epoch=1)
    except trainer.PreemptedError as e:
        rec["preempted"] = str(e)
    rec.update(steps=nn.timer.n_steps, **whole(nn))
    if "preempted" not in rec:
        rec.update(eval_loss=nn.eval_loss("tiny_dev"),
                   preds=nn.predict("tiny_dev"),
                   beams=nn.decode_beam_set("tiny_dev", 2, 2))
    if then_save:
        nn.save(1)
        rec["next"] = dict(loss=nn.train_epoch("tiny_train", epoch=2),
                           **whole(nn))
    return rec


def tp_forward_loss(rank, inputs):
    """``forward_loss`` on a (data, model) mesh of the world: this rank's
    rows of ``inputs``' batch, its vocab shards of the parameters, the
    shared draws; the loss and the gradients summed over the data group,
    the gradients' shards gathered whole."""
    with open(inputs, "rb") as f:
        a = pickle.load(f)
    B = a["X"].shape[0]
    mesh = parallel.make_mesh(a["parallel"], batch_size=B,
                              vocab=a["mcfg"]["rnn_config"]["dec_vocab_size"])
    off, n = mesh.rows(B)
    mine = slice(off, off + n)
    params, state = from_jax_numpy(a["params"], a["state"])
    params = parallel.shard_params(params, mesh)
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
    grads = parallel.gather_params(tree_unflatten(params, grads), mesh)
    return {"mesh": mesh, "loss": float(loss),
            "spec": parallel.param_spec(params, mesh)["dec"],
            "shapes": {k: tuple(v.shape) for k, v in params["dec"].items()
                       if torch.is_tensor(v)},
            "grads": flatten(trainer.to_numpy(grads)),
            "state": flatten(trainer.to_numpy(new_state))}


JOBS = {"collectives": collectives, "forward_loss": forward_loss,
        "train": train, "resume": resume,
        "tp_forward_loss": tp_forward_loss}


def arrays(flat):
    """The numpy leaves of a flattened tree."""
    return {k: v for k, v in flat.items() if isinstance(v, np.ndarray)}
