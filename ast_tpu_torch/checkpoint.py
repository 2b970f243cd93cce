"""Flat-key NPZ checkpoints, numpy only.

The same on-disk format as ``ast_tpu.train.checkpoint``: nested dicts
and lists flatten to ``a/b/0/c`` keys, a list leaves ``__len__``, an
empty dict ``__emptydict__`` and ``None`` ``__none__``.  Files are
``seq2seq_<epoch>.model.npz`` in the experiment directory.  A snapshot
holds ``params``, BN ``state``, and from training the optimizer state
``opt`` under the keys ``ast_tpu`` writes for it (see
``train/optimizer.py``), so either package resumes the other's runs.
A mid-epoch snapshot, ``seq2seq_inflight.npz``, also holds ``extra``:
``{epoch, step, g}`` (int64), "epoch ``epoch`` has consumed ``step``
batches at ``g`` steps per dispatch".
"""

import os
import re

import numpy as np


def flatten(tree, prefix="", leaf=np.asarray):
    """Nested dict/list tree of arrays -> {flat key: ``leaf(array)``}."""
    flat = {}
    if isinstance(tree, dict):
        if not tree:
            flat[f"{prefix}__emptydict__"] = np.asarray(0)
        for k, v in tree.items():
            flat.update(flatten(v, f"{prefix}{k}/", leaf))
    elif isinstance(tree, (list, tuple)):
        flat[f"{prefix}__len__"] = np.asarray(len(tree))
        for i, v in enumerate(tree):
            flat.update(flatten(v, f"{prefix}{i}/", leaf))
    elif tree is None:
        flat[f"{prefix}__none__"] = np.asarray(0)
    else:
        flat[prefix[:-1]] = leaf(tree)
    return flat


def unflatten(flat):
    """Inverse of :func:`flatten`."""
    root = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def materialize(node):
        if not isinstance(node, dict):
            return node
        if "__none__" in node:
            return None
        if "__emptydict__" in node:
            return {}
        if "__len__" in node:
            return [materialize(node[str(i)])
                    for i in range(int(node["__len__"]))]
        return {k: materialize(v) for k, v in node.items()}

    return materialize(root)


def save_checkpoint(path, params, state, opt_state=None, extra=None):
    """Write numpy ``params``, BN ``state`` and, when given, the
    optimizer state and an ``extra`` subtree to ``path`` atomically."""
    tree = {"params": params, "state": state}
    if opt_state is not None:
        tree["opt"] = opt_state
    if extra is not None:
        tree["extra"] = extra
    if not path.endswith(".npz"):
        path = path + ".npz"
    tmp = path[:-len(".npz")] + ".tmp.npz"
    np.savez(tmp, **flatten(tree))
    os.replace(tmp, path)


def load_checkpoint(path):
    """Read a snapshot -> dict with ``params`` and optional ``state``,
    ``opt`` and any other top-level key ``ast_tpu`` wrote, such as
    ``extra`` (numpy leaves)."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as f:
        flat = {k: f[k] for k in f.files}
    if not any(k.startswith("params/") for k in flat):
        raise ValueError(
            f"{path}: not a flat-NPZ ast_tpu checkpoint (Chainer-format "
            "reference checkpoints load through ast_tpu's copy_params "
            "first)")
    return unflatten(flat)


def checkpoint_path(model_dir, epoch):
    return os.path.join(model_dir, f"seq2seq_{epoch}.model.npz")


_CKPT_RE = re.compile(r"seq2seq_(\d+)\.model(\.npz)?$")


def latest_checkpoint(model_dir):
    """(path, epoch) of the max-epoch checkpoint, or (None, 0).  At equal
    epoch a ``.model.npz`` outranks a reference ``.model``."""
    found = {}
    if os.path.isdir(model_dir):
        for f in os.listdir(model_dir):
            m = _CKPT_RE.search(f)
            if not m:
                continue
            epoch, ours = int(m.group(1)), m.group(2) is not None
            if epoch not in found or (ours and not found[epoch][1]):
                found[epoch] = (os.path.join(model_dir, f), ours)
    if not found:
        return None, 0
    epoch = max(found)
    return found[epoch][0], epoch
