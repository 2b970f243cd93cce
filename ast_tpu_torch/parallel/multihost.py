"""Process-group set-up: the counterpart of
``ast_tpu/parallel/multihost.py`` on ``torch.distributed``.

Every process runs the same program over the same global batch stream
(the loader derives its shuffles from ``(seed, set_key, epoch)``, and the
seeds are sha256-stable across processes); each keeps its rows of every
batch (``parallel.mesh.shard_batch``).  Logs and checkpoints belong to
rank 0 (the trainer's and the train CLI's guards).  Nothing on a machine
names a cluster: the caller gives the coordinator's address, the number
of processes and this process's index (the train CLI reads them from
``torchrun``'s environment).
"""

import torch
import torch.distributed as dist


def default_backend(device):
    """``nccl`` for ranks on CUDA devices, ``gloo`` for CPU ranks."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None):
    """Join the default process group when more than one process runs:
    ``coordinator_address`` ``host:port`` (or a ``tcp://`` URL) of rank
    0, ``num_processes`` the world size, ``process_id`` this rank,
    ``backend`` as the caller states it (``nccl`` or ``gloo``, e.g.
    :func:`default_backend` of the rank's device; nothing else is tried
    after a failure).  A no-op returning False for one process."""
    if num_processes is None or num_processes <= 1:
        return False
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: state nccl or gloo")
    url = coordinator_address
    if "://" not in url:
        url = f"tcp://{url}"
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def host_info():
    """(rank, world size) of this process: (0, 1) outside a process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary():
    """True on the process that owns log and checkpoint writes."""
    return host_info()[0] == 0
