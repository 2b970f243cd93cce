"""The (data, model) mesh and the sharding of batches and parameters: the
counterpart of ``ast_tpu/parallel/mesh.py`` over ``torch.distributed``.

``ast_tpu`` lays a ``(data, model)`` mesh over the devices one process
drives; the port runs one process a card, so the mesh is the process
group: rank r sits at data index ``r // model`` and model index
``r % model`` (``ast_tpu``'s row-major ``devices.reshape(data, model)``).
The ranks of one data index form a *model group*: they hold the same
batch rows, and each holds 1/model of the vocabulary (:func:`param_spec`).
The ranks of one model index form a *data group*: rank r holds rows
``[d B / data, (d + 1) B / data)`` of every global batch of B rows, d
its data index, and gradients, losses and eval outputs are summed or
gathered over it.  ``make_mesh`` keeps ``ast_tpu``'s arithmetic
(``data_axis: 0`` takes ``world // model_axis``, reduced until it
divides the batch size; a mesh past the processes raises) and refuses
what one process a card cannot run: a mesh that leaves ranks idle or
splits the batch unevenly.  Parameters are broadcast whole
(:func:`replicate`), then sliced (:func:`shard_params`); a batch's
arrays are sliced by rows (:func:`shard_batch`).
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ast_tpu_torch.parallel.multihost import host_info
from ast_tpu_torch.params import tree_map

# (data, model) -> (the default group they were made in, data groups by
# model index, model groups by data index)
_GROUPS = {}


def _make_groups(data, model):
    """The mesh's process groups, made on every rank in one fixed order
    (``dist.new_group`` is collective over the world); kept for the
    default group they were made in."""
    world = dist.group.WORLD
    got = _GROUPS.get((data, model))
    if got is None or got[0] is not world:
        data_groups = [dist.new_group([d * model + m for d in range(data)])
                       for m in range(model)]
        model_groups = [dist.new_group([d * model + m for m in range(model)])
                        for d in range(data)]
        got = _GROUPS[(data, model)] = (world, data_groups, model_groups)
    return got


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` x ``model`` processes (the world), this one ``rank``."""
    data: int
    rank: int
    model: int = 1

    @property
    def shape(self):
        """The axes' sizes, as ``jax.sharding.Mesh.shape``."""
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self):
        """This rank's place on the data axis (its rows)."""
        return self.rank // self.model

    @property
    def model_index(self):
        """This rank's place on the model axis (its vocabulary shard)."""
        return self.rank % self.model

    def _groups(self):
        got = _GROUPS.get((self.data, self.model))
        if got is None or got[0] is not dist.group.WORLD:
            raise RuntimeError(f"no process groups for the {self.data}x"
                               f"{self.model} mesh: make it with make_mesh "
                               "inside the process group")
        return got

    @property
    def data_group(self):
        """The ranks of this rank's model index (the world without a
        model axis)."""
        if self.model == 1:
            return dist.group.WORLD
        return self._groups()[1][self.model_index]

    @property
    def model_group(self):
        """The ranks of this rank's data index."""
        return self._groups()[2][self.data_index]

    def rows(self, B):
        """(first global row, rows) of this rank's shard of a B-row
        batch."""
        if B % self.data:
            raise ValueError(f"a batch of {B} rows does not split over "
                             f"{self.data} data shards")
        n = B // self.data
        return self.data_index * n, n

    def shard(self, t, spec):
        """This rank's slice of the whole tensor ``t`` laid out by
        ``spec`` (:func:`leaf_spec`): its vocabulary shard along the
        ``"model"`` axis, a contiguous copy; ``t`` itself when
        replicated."""
        if "model" not in spec or self.model == 1:
            return t
        axis = spec.index("model")
        n = t.shape[axis] // self.model
        return t.narrow(axis, self.model_index * n, n).contiguous()

    def full_shape(self, shape, spec):
        """The whole tensor's shape of a shard of ``shape``."""
        shape = list(shape)
        if "model" in spec:
            shape[spec.index("model")] *= self.model
        return tuple(shape)


def make_mesh(parallel_cfg=None, world=None, batch_size=None, rank=None,
              vocab=None):
    """The (data, model) mesh over ``world`` processes (default: the
    process group's), or None for a 1x1 mesh in a world of one process
    (no collective, no slicing).  ``batch_size``: the rows of every batch
    (the gcd of per-bucket sizes), which ``data_axis: 0`` divides;
    ``vocab``: the decoder's vocabulary, which the model axis shards.
    Inside a process group of ``world`` ranks a model axis above 1 makes
    the mesh's groups (every rank calls this at the same point).
    Raises ValueError for a mesh larger than the world (as
    ``ast_tpu``'s), one smaller (idle ranks), a data axis that does not
    divide ``batch_size`` and a model axis that does not divide
    ``vocab`` (``ast_tpu``'s placement of the vocab shards raises)."""
    parallel_cfg = parallel_cfg or {}
    r0, w0 = host_info()
    world = w0 if world is None else int(world)
    rank = r0 if rank is None else int(rank)
    model_axis = int(parallel_cfg.get("model_axis", 1) or 1)
    data_axis = int(parallel_cfg.get("data_axis", 0) or 0)
    if data_axis <= 0:
        data_axis = max(1, world // model_axis)
        if batch_size is not None:
            while data_axis > 1 and batch_size % data_axis != 0:
                data_axis -= 1
    n = data_axis * model_axis
    if n > world:
        raise ValueError(f"mesh {data_axis}x{model_axis} needs more than "
                         f"{world} devices")
    if n < world:
        raise ValueError(
            f"a {data_axis}x{model_axis} mesh leaves {world - n} of "
            f"{world} processes idle (batch size {batch_size}); make the "
            f"batch size a multiple of {world // model_axis} or run {n} "
            "processes")
    if n == 1:
        return None
    if batch_size is not None and batch_size % data_axis:
        raise ValueError(f"batch size {batch_size} does not split over "
                         f"{data_axis} processes")
    if vocab is not None and vocab % model_axis:
        raise ValueError(f"a vocab of {vocab} does not split over "
                         f"model_axis={model_axis} shards")
    if model_axis > 1 and dist.is_initialized() and w0 == world:
        _make_groups(data_axis, model_axis)
    return Mesh(data_axis, rank, model_axis)


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


def leaf_spec(path):
    """The layout of the leaf at ``path`` ('a/b/c') under a model axis,
    as ``ast_tpu``'s ``_param_pspec`` (a tuple of axis names,
    ``PartitionSpec``'s): ``dec/out_w`` (A, V) by columns, ``dec/out_b``
    (V,) and ``dec/embed`` (V, E) by rows, anything else replicated
    ``()``.  It matches by suffix, so the optimizer state's moments of
    those leaves shard too."""
    if path.endswith("dec/out_w"):
        return (None, "model")
    if path.endswith("dec/out_b"):
        return ("model",)
    if path.endswith("dec/embed"):
        return ("model", None)
    return ()


def _map_with_path(fn, tree, path=""):
    """``fn(path, leaf)`` over a nested dict / list tree."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(path, tree)


def _model_parallel(mesh):
    return mesh is not None and mesh.model > 1


def param_spec(tree, mesh):
    """The tree (same structure) of each leaf's layout
    (:func:`leaf_spec`) on ``mesh``: every leaf ``()`` without a model
    axis."""
    on = _model_parallel(mesh)
    return _map_with_path(lambda p, t: leaf_spec(p) if on else (), tree)


def spec_leaves(tree, mesh):
    """The layouts of :func:`param_spec`, a list in the tree's leaf
    order."""
    out = []
    on = _model_parallel(mesh)
    _map_with_path(lambda p, t: out.append(leaf_spec(p) if on else ()), tree)
    return out


def shard_params(tree, mesh):
    """A tree of whole leaves (params or optimizer state) -> this rank's:
    each vocab-laid leaf sliced to its shard, the rest as they are (the
    tree itself without a model axis)."""
    if not _model_parallel(mesh):
        return tree
    return _map_with_path(
        lambda p, t: mesh.shard(t, leaf_spec(p)) if torch.is_tensor(t)
        else t, tree)


def all_gather_axis(t, axis, group, n):
    """The ``n`` ranks' tensors of ``group`` concatenated along ``axis``
    in rank order; any dtype (through its bytes, which gloo takes for
    every dtype)."""
    t = t.detach().contiguous()
    flat = t.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(parts, flat, group=group)
    return torch.cat([p.view(t.dtype).view(t.shape) for p in parts],
                     dim=axis)


def gather_params(tree, mesh):
    """The whole leaves of a sharded tree (:func:`shard_params`'s
    inverse, no autograd), on every rank of the model group: a new tree
    (the tree itself without a model axis).  Every rank calls it at the
    same point."""
    if not _model_parallel(mesh):
        return tree

    def whole(p, t):
        spec = leaf_spec(p)
        if not torch.is_tensor(t) or "model" not in spec:
            return t
        return all_gather_axis(t, spec.index("model"), mesh.model_group,
                               mesh.model)
    return _map_with_path(whole, tree)


def replicate(trees, mesh):
    """Make each tensor leaf of ``trees`` (e.g. params, state, optimizer
    state, all at their whole size) rank 0's, in place: their bytes in
    one buffer, one broadcast over the world.  Nothing is sent without a
    mesh."""
    if mesh is None:
        return
    leaves = []
    for tree in trees:
        tree_map(lambda t: leaves.append(t) if torch.is_tensor(t) else None,
                 tree)
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
