"""The data axis and batch sharding: the counterpart of
``ast_tpu/parallel/mesh.py`` over ``torch.distributed``.

``ast_tpu`` lays a ``(data, model)`` mesh over the devices one process
drives; the port runs one process a card, so its data axis is the
process group: rank r holds rows ``[r B / n, (r + 1) B / n)`` of every
global batch of B rows.  ``make_mesh`` keeps ``ast_tpu``'s arithmetic
(``data_axis: 0`` takes the largest count of processes that divides the
batch size, an explicit axis past the processes raises) and refuses what
one process a card cannot run: a data axis that leaves ranks idle or
splits the batch unevenly, and the vocab-sharded ``model_axis``, which is
not ported.  Parameters are replicated (:func:`replicate`); a batch's
arrays are sliced (:func:`shard_batch`).
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ast_tpu_torch.parallel.multihost import host_info
from ast_tpu_torch.train.optimizer import tree_leaves


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis: ``data`` processes (the world), this one ``rank``."""
    data: int
    rank: int

    @property
    def shape(self):
        """The axes' sizes, as ``jax.sharding.Mesh.shape``."""
        return {"data": self.data, "model": 1}

    def rows(self, B):
        """(first global row, rows) of this rank's shard of a B-row
        batch."""
        if B % self.data:
            raise ValueError(f"a batch of {B} rows does not split over "
                             f"{self.data} data shards")
        n = B // self.data
        return self.rank * n, n


def make_mesh(parallel_cfg=None, world=None, batch_size=None, rank=None):
    """The data axis over ``world`` processes (default: the process
    group's), or None when it is 1 (one process: no collective, no
    slicing).  ``batch_size``: the rows of every batch (the gcd of
    per-bucket sizes), which ``data_axis: 0`` divides.  Raises
    ValueError for a ``model_axis`` above 1, an axis larger than the
    world (as ``ast_tpu``'s), one smaller (idle ranks) and one that
    does not divide ``batch_size``."""
    parallel_cfg = parallel_cfg or {}
    r0, w0 = host_info()
    world = w0 if world is None else int(world)
    rank = r0 if rank is None else int(rank)
    model_axis = int(parallel_cfg.get("model_axis", 1) or 1)
    if model_axis > 1:
        raise ValueError(
            f"parallel.model_axis={model_axis}: vocab tensor parallelism "
            "(dec/out_w, dec/out_b and dec/embed sharded over the vocab) "
            "is not ported; see ROADMAP.md")
    data_axis = int(parallel_cfg.get("data_axis", 0) or 0)
    if data_axis <= 0:
        data_axis = max(1, world)
        if batch_size is not None:
            while data_axis > 1 and batch_size % data_axis != 0:
                data_axis -= 1
    if data_axis > world:
        raise ValueError(f"mesh {data_axis}x{model_axis} needs more than "
                         f"{world} devices")
    if data_axis < world:
        raise ValueError(
            f"a data axis of {data_axis} leaves {world - data_axis} of "
            f"{world} processes idle (batch size {batch_size}); make the "
            f"batch size a multiple of {world} or run {data_axis} "
            "processes")
    if batch_size is not None and batch_size % data_axis:
        raise ValueError(f"batch size {batch_size} does not split over "
                         f"{data_axis} processes")
    if data_axis == 1:
        return None
    return Mesh(data_axis, rank)


def batch_spec(mesh, x, axis=0):
    """The slice of ``x`` this rank keeps: its rows along ``axis``, or the
    whole of ``x`` when it has no such axis (a scalar, the per-step
    scalars of a stacked run) or there is no mesh."""
    nd = np.ndim(x)
    if mesh is None or nd <= axis:
        return (slice(None),)
    start, n = mesh.rows(np.shape(x)[axis])
    return (slice(None),) * axis + (slice(start, start + n),)


def shard_batch(batch, mesh, axis=0):
    """This rank's rows of each array or tensor of ``batch`` (a dict):
    axis 0 for a plain batch, 1 for a stacked (G, B, ...) run of
    ``steps_per_dispatch`` steps; other values pass as they are.  A new
    dict, of the same values without a mesh."""
    if mesh is None:
        return dict(batch)

    def take(x):
        if isinstance(x, (np.ndarray, torch.Tensor)):
            return x[batch_spec(mesh, x, axis)]
        return x
    return {k: take(v) for k, v in batch.items()}


def replicate(trees, mesh):
    """Make each tensor leaf of ``trees`` (e.g. params, state, optimizer
    state) rank 0's, in place: their bytes in one buffer, one broadcast.
    Nothing is sent without a mesh."""
    if mesh is None:
        return
    leaves = [t for tree in trees for t in tree_leaves(tree)
              if torch.is_tensor(t)]
    if not leaves:
        return
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in leaves])
    dist.broadcast(flat, src=0)
    off = 0
    with torch.no_grad():
        for t in leaves:
            n = t.numel() * t.element_size()
            # a copy of the bytes, aligned for any dtype
            t.copy_(flat[off:off + n].clone().view(t.dtype).view(t.shape))
            off += n
