"""Process-stable seed derivation (``ast_tpu/utils/seeding.py``, which
cannot be imported here: ``ast_tpu.utils`` pulls in JAX).

Deriving ints from strings with ``hash()`` would change with
PYTHONHASHSEED, so every derivation goes through a sha256 digest.
"""

import hashlib


def stable_seed(seed, bits=31):
    """Deterministically map any seed (int or str) to a non-negative int
    with ``bits`` bits, identically in every process."""
    if isinstance(seed, int):
        return seed % (2 ** bits)
    digest = hashlib.sha256(str(seed).encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") % (2 ** bits)
