"""The collectives of a data-parallel step: the counterpart of
``ast_tpu/parallel/dp.py``.

``ast_tpu`` lets XLA's SPMD partitioner insert the gradient all-reduce
and the eval step's all-gather from its sharding annotations; here they
are explicit ``torch.distributed`` calls between the backward and the
optimizer, and after a decode.  The gradient sum goes through one flat
buffer in one ``all_reduce``, so its order is fixed and a run repeats
under ``torch.use_deterministic_algorithms(True)``.  Each function
takes the mesh (``parallel.mesh.make_mesh``) and with None issues
nothing.  Sums and gathers run over the rank's data group (the ranks
of its model index): the ranks of a model group hold the same rows, so
over the world each row would count once a model rank.  The tensors
stay on the caller's device: NCCL takes CUDA tensors, gloo CPU ones and
(where its build has CUDA) CUDA ones.
"""

import torch
import torch.distributed as dist


def all_reduce_grads(grads, mesh):
    """The sum over the data group of each gradient of ``grads`` (a sequence of
    tensors of one dtype and device), through one flat buffer.  Each
    rank's loss is its rows' share of the global batch's (divided by the
    global ``n_real``), so the sum is the single-process gradient.  A
    vocab shard's gradient is summed with those of the same shard."""
    if mesh is None:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.data_group)
    return [v.view_as(g) for v, g in zip(flat.split([g.numel()
                                                     for g in grads]),
                                         grads)]


def all_reduce_sum(t, mesh):
    """``t`` summed over the data group (a new tensor; ``t`` without a
    mesh)."""
    if mesh is None:
        return t
    t = t.clone()
    dist.all_reduce(t, group=mesh.data_group)
    return t


def any_rank(flag, mesh, device="cpu"):
    """Whether ``flag`` holds on any rank of the world (all ranks must
    call it at the same point of the program)."""
    if mesh is None:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def gather_rows(tensors, mesh):
    """Every data rank's rows of each tensor of ``tensors`` (equal shapes
    on every rank), concatenated along axis 0 in data order: the full
    batch's outputs on every rank (``ast_tpu``'s replicated eval
    outputs)."""
    if mesh is None:
        return list(tensors)
    out = []
    for t in tensors:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.data)]
        dist.all_gather(parts, t, group=mesh.data_group)
        out.append(torch.cat(parts))
    return out
