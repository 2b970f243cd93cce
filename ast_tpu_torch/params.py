"""The weight bridge between ast_tpu's parameter trees and the port's.

Both packages use the same nested layout (``models/seq2seq.init_model``
in each): ``cnn`` conv weights in OIHW, direction-stacked encoder LSTMs
``wx (D2, in, 4H)`` / ``wh (D2, H, 4H)`` / ``b (D2, 4H)`` with gate order
[i, f, g, o], ``attn.wa[0].w/b``, ``attn.context.w/b``, and the decoder
``embed (V, E)``, ``lstm[l].wx/wh/b`` and ``out_w (A, V)`` / ``out_b``.
Here the leaves are float32 torch tensors on one device.
"""

import numpy as np
import torch

from ast_tpu_torch.checkpoint import flatten, unflatten


def torch_device(name):
    """``torch.device(name)``; a CUDA device must exist (no silent CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but no CUDA device is "
                           "available (pass --device cpu for the plain "
                           "PyTorch path)")
    return dev


def tree_map(fn, tree, is_leaf=None):
    """Apply ``fn`` to every leaf of a nested dict/list tree; a node for
    which ``is_leaf`` holds is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, is_leaf) for v in tree]
    if tree is None:
        return None
    return fn(tree)


def from_jax_numpy(params, state, device="cpu"):
    """ast_tpu params/state (numpy or array-like leaves) -> torch trees."""
    def conv(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    return tree_map(conv, params), tree_map(conv, state)


def to_flat(params, state):
    """Torch trees -> the flat-NPZ dict ``ast_tpu.train.checkpoint``
    writes for ``{"params": ..., "state": ...}``."""
    def conv(t):
        return t.detach().cpu().numpy()
    return flatten({"params": tree_map(conv, params),
                    "state": tree_map(conv, state)})


def from_flat(flat, device="cpu"):
    """Flat-NPZ dict -> (params, state) torch trees."""
    tree = unflatten(flat)
    return from_jax_numpy(tree["params"], tree.get("state") or {}, device)
