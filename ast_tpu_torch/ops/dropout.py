"""Counter-hash dropout masks, bit-exact with ``ast_tpu``'s
``ops/fused_lstm._drop_mask``.

A murmur-style avalanche over (flat element index + seed * 2654435761)
in uint32 arithmetic; an element is kept when its hash is at least
``int(rate * 2**32)``.  The fused kernels regenerate the same masks from
the same seeds (``kernels/csrc/common.cuh`` ``drop_hash``), so forward
and backward agree without storing masks.  torch lacks most uint32 ops,
so the words are held in int64 and cut to 32 bits after every step.
"""

import torch

_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2**32 for x < 2**32 in int64 and a 32-bit constant c,
    in two 16-bit halves so no product passes 2**63."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def drop_hash(flat, seed):
    """The 32-bit hash of flat indices (int64 tensor) under ``seed`` (an
    int or an int64 tensor broadcastable to ``flat``), as int64."""
    if isinstance(seed, int):
        seed = seed & _M32
    else:
        seed = seed.to(torch.int64) & _M32
    x = (flat + _mul32(torch.as_tensor(seed, device=flat.device),
                       2654435761)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def drop_threshold(rate):
    """The uint32 keep threshold of a dropout ``rate``."""
    return int(rate * (2 ** 32))


def drop_mask(shape, rate, seed, row_axis=None, row_offset=0,
              global_rows=None, device="cpu"):
    """Keep-mask (bool tensor of ``shape``) for dropout at ``rate``.

    ``seed``: an int (taken modulo 2**32, as the uint32 cast of an int32
    sum wraps), or an int64 tensor broadcastable to ``shape`` for a stack
    of masks with one seed each.  ``row_axis`` / ``row_offset`` /
    ``global_rows``: the local block covers rows [row_offset, row_offset
    + shape[row_axis]) of a batch of ``global_rows`` rows, and the hash
    runs over global row indices."""
    flat = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for axis in reversed(range(len(shape))):
        view = [1] * len(shape)
        view[axis] = shape[axis]
        ids = torch.arange(shape[axis], dtype=torch.int64,
                           device=device).view(view)
        if row_axis is not None and axis == row_axis:
            ids = ids + row_offset
            dim = global_rows if global_rows is not None else shape[axis]
        else:
            dim = shape[axis]
        flat = (flat + ids * stride) & _M32
        stride *= dim
    return drop_hash(flat.expand(shape), seed) >= drop_threshold(rate)
