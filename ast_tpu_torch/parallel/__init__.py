"""Data and vocab tensor parallelism over ``torch.distributed``: the
counterpart of ``ast_tpu/parallel``.

One process drives one card (a rank); several processes, on one host or
many, form a ``(data, model)`` mesh.  Every rank builds the identical
global batch stream and keeps its data index's rows
(:func:`shard_batch`); the gradients are summed over the data group
(:func:`all_reduce_grads`), so parameters, optimizer state and BN
statistics stay bit-identical on the ranks that hold them; evaluation
gathers every data rank's rows (:func:`gather_rows`); only rank 0
writes.  A model axis shards the vocabulary of ``dec/out_w``,
``dec/out_b`` and ``dec/embed`` over the ranks of a model group
(:func:`shard_params`, :func:`gather_params`; the step's collectives in
``parallel.tp``).  With one process nothing here issues a collective.
"""

from ast_tpu_torch.parallel.dp import (
    all_reduce_grads, all_reduce_sum, any_rank, gather_rows)
from ast_tpu_torch.parallel.mesh import (
    Mesh, batch_spec, gather_params, leaf_spec, make_mesh, param_spec,
    replicate, shard_batch, shard_params)
from ast_tpu_torch.parallel.multihost import (
    default_backend, host_info, init_distributed, is_primary)

__all__ = [
    "Mesh", "make_mesh", "batch_spec", "shard_batch", "replicate",
    "leaf_spec", "param_spec", "shard_params", "gather_params",
    "all_reduce_grads", "all_reduce_sum", "any_rank", "gather_rows",
    "init_distributed", "host_info", "is_primary", "default_backend",
]
