"""The random numbers of a training step, worked out again from the
step's seed as the configuration's training recipe defines them.

- The step seed of the k-th batch (0-based) of epoch ``e`` is
  ``stable_seed(f"{run}|{e}|{k}")``, ``run`` being ``stable_seed`` of
  the experiment's seed string (31 bits).
- Speech noise: ``speech_noise * N(0, 1)`` over the batch's feature
  block, from a ``torch.Generator`` on the batch's device seeded with
  the step seed; the features are multiplied by ``1 + noise``.
- From a host generator seeded with the step seed: the encoder's and
  the decoder's dropout seeds (two ints in [0, 2**31 - 1)), then the
  coins of the U - 1 decoder steps (teacher-forced where
  ``uniform < teach_ratio``, and always at the first and last step).
- Dropout keeps an element when a murmur-style hash of its flat index
  plus ``seed * 2654435761`` (uint32 arithmetic) is at least
  ``rate * 2**32``.

``stable_seed``, ``drop_hash`` and ``drop_keep`` are frozen copies of
``ast_tpu_torch/utils/seeding.py``'s ``stable_seed`` and
``ast_tpu_torch/ops/dropout.py``'s ``drop_hash`` / ``drop_mask`` at
commit 22fa93ac41eb92290dc27e5d3bbe6819cd4b1719 (the data-parallel
row offset left out).
"""

import dataclasses
import hashlib
from typing import Optional

import torch

_M32 = 0xFFFFFFFF


def stable_seed(seed, bits=31):
    """Deterministically map any seed (int or str) to a non-negative int
    with ``bits`` bits, identically in every process."""
    if isinstance(seed, int):
        return seed % (2 ** bits)
    digest = hashlib.sha256(str(seed).encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") % (2 ** bits)


def _mul32(x, c):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def drop_hash(flat, seed):
    """The 32-bit hash of flat indices (int64 tensor) under ``seed``."""
    seed = seed & _M32
    x = (flat + _mul32(torch.as_tensor(seed, device=flat.device),
                       2654435761)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def drop_keep(shape, rate, seed, row_axis=None, device="cpu"):
    """The keep-mask (bool, ``shape``) of dropout at ``rate``."""
    flat = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for axis in reversed(range(len(shape))):
        view = [1] * len(shape)
        view[axis] = shape[axis]
        ids = torch.arange(shape[axis], dtype=torch.int64,
                           device=device).view(view)
        flat = (flat + ids * stride) & _M32
        stride *= shape[axis]
    return drop_hash(flat.expand(shape), seed) >= int(rate * (2 ** 32))


@dataclasses.dataclass
class Draws:
    noise: Optional[torch.Tensor]
    enc_seed: int
    dec_seed: int
    coins: list


def step_seed(run_seed_str, epoch, k):
    """The seed of the k-th batch of ``epoch``."""
    return stable_seed(f"{stable_seed(run_seed_str)}|{epoch}|{k}")


def make_draws(seed, X, steps, teach_ratio, speech_noise):
    """The draws of one step from its seed, X (B, T, D) on its device."""
    host = torch.Generator().manual_seed(seed)
    noise = None
    if speech_noise > 0:
        dev = torch.Generator(device=X.device).manual_seed(seed)
        noise = speech_noise * torch.randn(X.shape, generator=dev,
                                           device=X.device)
    enc_seed, dec_seed = torch.randint(0, 2 ** 31 - 1, (2,),
                                       generator=host).tolist()
    idx = torch.arange(steps)
    coins = ((idx == 0) | (idx >= steps - 1)
             | (torch.rand(steps, generator=host) < teach_ratio))
    return Draws(noise, enc_seed, dec_seed, [bool(v) for v in coins])
