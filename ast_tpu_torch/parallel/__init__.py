"""Data parallelism over ``torch.distributed``: the counterpart of
``ast_tpu/parallel``.

One process drives one card (a rank); several processes, on one host or
many, form the data axis.  Every rank builds the identical global batch
stream and keeps its own rows (:func:`shard_batch`); the gradients are
summed over the ranks (:func:`all_reduce_grads`), so parameters,
optimizer state and BN statistics stay bit-identical on every rank;
evaluation gathers every rank's rows (:func:`gather_rows`); only rank 0
writes.  With one process nothing here issues a collective.
"""

from ast_tpu_torch.parallel.dp import (
    all_reduce_grads, all_reduce_sum, any_rank, gather_rows)
from ast_tpu_torch.parallel.mesh import (
    Mesh, batch_spec, make_mesh, replicate, shard_batch)
from ast_tpu_torch.parallel.multihost import (
    default_backend, host_info, init_distributed, is_primary)

__all__ = [
    "Mesh", "make_mesh", "batch_spec", "shard_batch", "replicate",
    "all_reduce_grads", "all_reduce_sum", "any_rank", "gather_rows",
    "init_distributed", "host_info", "is_primary", "default_backend",
]
