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

A reference (Chainer) checkpoint, ``seq2seq_<epoch>.model``, loads too:
``load_checkpoint`` converts it (``train/chainer_import.py``).
``average_checkpoints`` and ``transfer_params`` are the checkpoint tools
of ``cli/copy_params.py``, bit-equal to ``ast_tpu``'s.
"""

import os
import re

import numpy as np

from ast_tpu_torch.train import chainer_import


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
    ``extra`` (numpy leaves).  A reference (Chainer) archive, found by
    its keys, is converted: params and BN state, no optimizer state (the
    reference saves none)."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as f:
        flat = {k: f[k] for k in f.files}
    if chainer_import.is_chainer_checkpoint(flat):
        return chainer_import.chainer_to_ast(flat)
    return unflatten(flat)


def checkpoint_path(model_dir, epoch):
    return os.path.join(model_dir, f"seq2seq_{epoch}.model.npz")


# ours are ``seq2seq_<e>.model.npz``, the reference's ``seq2seq_<e>.model``
_CKPT_RE = re.compile(r"seq2seq_(\d+)\.model(\.npz)?$")


def list_checkpoints(model_dir):
    """Sorted ``[(epoch, path)]`` of every epoch checkpoint in the dir.
    At equal epoch a ``.model.npz`` outranks a reference ``.model`` (it
    carries the optimizer state and the resume extras)."""
    found = {}
    if os.path.isdir(model_dir):
        for f in os.listdir(model_dir):
            m = _CKPT_RE.search(f)
            if not m:
                continue
            epoch, ours = int(m.group(1)), m.group(2) is not None
            if epoch not in found or (ours and not found[epoch][1]):
                found[epoch] = (os.path.join(model_dir, f), ours)
    return [(e, found[e][0]) for e in sorted(found)]


def latest_checkpoint(model_dir):
    """(path, epoch) of the max-epoch checkpoint, or (None, 0)."""
    ckpts = list_checkpoints(model_dir)
    if not ckpts:
        return None, 0
    epoch, path = ckpts[-1]
    return path, epoch


def _map(fn, *trees, where="tree"):
    """``fn`` over the leaves of equally nested dict / list trees (the
    structure of the first); ValueError naming ``where`` if the others
    are nested otherwise."""
    first = trees[0]
    if isinstance(first, dict):
        if any(not isinstance(t, dict) or t.keys() != first.keys()
               for t in trees[1:]):
            raise ValueError(f"tree structure differs at '{where}'")
        return {k: _map(fn, *(t[k] for t in trees), where=f"{where}/{k}")
                for k in first}
    if isinstance(first, (list, tuple)):
        if any(not isinstance(t, (list, tuple)) or len(t) != len(first)
               for t in trees[1:]):
            raise ValueError(f"tree structure differs at '{where}'")
        return [_map(fn, *leaves, where=f"{where}/{i}")
                for i, leaves in enumerate(zip(*trees))]
    return fn(*trees)


def average_checkpoints(paths):
    """Elementwise mean of params and BN running stats over several epoch
    checkpoints (a decode-time model): float64 sums in the order of
    ``paths``, divided by their count, cast to float32.  Returns
    ``(params, state)``; optimizer state and resume extras are dropped,
    since the result is for decoding and export, not for resuming."""
    if not paths:
        raise ValueError("no checkpoints to average")
    acc = None
    for path in paths:
        snap = load_checkpoint(path)
        cur = (snap["params"], snap.get("state") or {})
        if acc is None:
            acc = _map(lambda a: np.asarray(a, np.float64), cur)
        else:
            acc = _map(lambda a, b: a + np.asarray(b, np.float64), acc, cur)
    n = len(paths)
    params, state = _map(lambda a: (a / n).astype(np.float32), acc)
    return params, state


# param groups of the reference's copy_params.py
TRANSFER_GROUPS = {
    "enc": ["cnn", "enc"],
    "attn": ["attn"],
    "dec": ["dec"],
}


def transfer_params(src_params, dst_params, groups=("enc",),
                    src_state=None, dst_state=None):
    """Copy whole param groups (``TRANSFER_GROUPS``) from a donor model
    into a target model; the encoder's BN running stats come with
    ``enc``.  Shapes must match within the copied groups (ValueError
    naming the group).  Returns (new_params, new_state)."""
    new_params = dict(dst_params)
    for g in groups:
        for key in TRANSFER_GROUPS[g]:
            def check(a, b):
                if np.shape(a) != np.shape(b):
                    raise ValueError(
                        f"shape mismatch transferring '{key}': "
                        f"{np.shape(b)} -> {np.shape(a)}")
                return b
            new_params[key] = _map(check, dst_params[key], src_params[key],
                                   where=key)
    new_state = dst_state
    if "enc" in groups and src_state is not None and dst_state is not None:
        new_state = dict(dst_state)
        new_state["cnn_bn"] = src_state["cnn_bn"]
        new_state["enc_proj_bn"] = src_state["enc_proj_bn"]
    return new_params, new_state
