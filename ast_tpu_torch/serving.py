"""The port's serving artifact: one model's weights and the decode shapes
a server runs over them.

The contract of ``ast_tpu/serving.py``: a serving directory is the whole
deployment unit -- a server runs it without the experiment directory,
its config, its pickles or a checkpoint.  ``ast_tpu`` bakes the weights
into one ``jax.export`` StableHLO program per decode shape; PyTorch has
no such format, so here the directory holds the model once:

- ``weights.npz``: ``{"params", "state"}`` in the flat-NPZ layout of the
  checkpoints (``checkpoint.flatten``), read with
  ``np.load(allow_pickle=False)``.  A quantized leaf ``<key>`` is stored
  as ``<key>/__q8__`` (int8) and ``<key>/scale`` (float32).
- ``model_cfg.json``: the model config.
- ``vocab.json`` and ``manifest.json``, with ``ast_tpu``'s keys.

An entry is a (kind, batch, frames[, N, K]) shape over that one model,
a record of the manifest with no file of its own: its ``file`` is a
name in ``ast_tpu``'s artifact pattern (``greedy_B{B}_T{T}{_q8}``,
``beam_N{N}_K{K}_B{B}_T{T}{_q8}``), so a reply's ``artifact`` reads the
same in both packages.  A server loads the weights once per device and
decodes every entry with them, at the manifest's ``compute_dtype``:
at ``"bfloat16"`` the float32 weights (an int8 leaf dequantized to
float32 first, as ``ast_tpu``'s artifact does) are rounded to bf16 once
when the decode pack is made (``models.seq2seq.decode_weights``).
"""

import json
import os

import numpy as np
import torch

from ast_tpu_torch.checkpoint import flatten, unflatten
from ast_tpu_torch.params import tree_map

WEIGHTS = "weights.npz"
MODEL = "model_cfg.json"
FORMAT = ("ast_tpu_torch serving dir: one flat-NPZ weights file "
          f"{WEIGHTS} (int8 leaves as <key>/__q8__ + <key>/scale) and "
          f"{MODEL}; each entry is a decode shape over that model")
# marker key for a quantized leaf inside a params tree
_Q8_KEY = "__q8__"


def _is_q8(x):
    return isinstance(x, dict) and _Q8_KEY in x


def quantize_params(params, min_size=4096):
    """Weight-only symmetric int8 quantization of a NumPy params tree
    (``ast_tpu.serving.quantize_params``, the same int8 and scales).

    Every floating leaf with ``ndim >= 2`` and at least ``min_size``
    elements becomes ``{"__q8__": int8, "scale": f32}`` with one scale per
    output channel (axis 0 of an OIHW conv kernel, else the last axis),
    ``q = round(w / scale)`` clipped to ±127.  Biases, BN scales and the
    rest stay float."""
    def quant(w):
        a = np.asarray(w)
        if a.ndim < 2 or a.size < min_size or \
                not np.issubdtype(a.dtype, np.floating):
            return w
        a32 = a.astype(np.float32)
        out_axis = 0 if a.ndim == 4 else a.ndim - 1
        red = tuple(i for i in range(a.ndim) if i != out_axis)
        amax = np.max(np.abs(a32), axis=red, keepdims=True)
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.rint(a32 / scale), -127, 127).astype(np.int8)
        return {_Q8_KEY: q, "scale": scale}

    return tree_map(quant, params)


def dequantize_params(qparams, device="cpu"):
    """A params tree (NumPy leaves, some quantized) -> float32 tensors on
    ``device``; a quantized leaf becomes ``q.float() * scale`` there, once
    at load (``ast_tpu`` multiplies inside its artifact, which XLA hoists
    out of the decode loop: the same float32 products)."""
    def deq(x):
        if _is_q8(x):
            q = torch.from_numpy(np.asarray(x[_Q8_KEY])).to(device)
            s = torch.from_numpy(np.asarray(x["scale"], np.float32))
            return q.float() * s.to(device)
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return tree_map(deq, qparams, _is_q8)


def save_model(out_dir, mcfg, params, state):
    """Write ``weights.npz`` (NumPy trees; ``params`` may be quantized)
    and ``model_cfg.json`` atomically; returns the weights' bytes."""
    path = os.path.join(out_dir, WEIGHTS)
    tmp = path[:-len(".npz")] + ".tmp.npz"
    np.savez(tmp, **flatten({"params": params, "state": state}))
    os.replace(tmp, path)
    with open(os.path.join(out_dir, MODEL), "w") as f:
        json.dump(mcfg, f, indent=1)
    return os.path.getsize(path)


def load_model(serving_dir, device="cpu"):
    """(mcfg, params, state) of a serving directory, the weights float32
    tensors on ``device`` (the compute dtype's rounding comes with the
    decode pack)."""
    with open(os.path.join(serving_dir, MODEL)) as f:
        mcfg = json.load(f)
    with np.load(os.path.join(serving_dir, WEIGHTS),
                 allow_pickle=False) as z:
        tree = unflatten({k: z[k] for k in z.files})
    return (mcfg, dequantize_params(tree["params"], device),
            dequantize_params(tree.get("state") or {}, device))


def make_entry(out_dir, kind, batch, frames, N=None, K=None,
               quantized=False):
    """One entry's manifest record, named by ``ast_tpu``'s artifact
    pattern (``bytes``: the weights file the entry runs over)."""
    beam = f"_N{N}_K{K}" if kind == "beam" else ""
    q8 = "_q8" if quantized else ""
    entry = {"file": f"{kind}{beam}_B{batch}_T{frames}{q8}",
             "kind": kind, "batch": batch, "frames": frames}
    if kind == "beam":
        entry.update(N=N, K=K)
    entry["bytes"] = os.path.getsize(os.path.join(out_dir, WEIGHTS))
    return entry


def write_manifest(out_dir, entries, mcfg, stop_limit, compute_dtype,
                   i2w=None, dec_key="bpe_w", quantization=None):
    """Write ``manifest.json`` (+ optional ``vocab.json``, byte for byte
    ``ast_tpu``'s) describing the entries, so a server needs no pickles
    to decode ids into tokens.  ``dec_key`` records the target unit so
    detokenization joins correctly."""
    manifest = {
        "format": FORMAT,
        "input": "float32 (batch, frames, 13) CMVN'd MFCC features",
        "symbols": {"PAD": 0, "GO": 1, "EOS": 2, "UNK": 3},
        "dec_vocab_size": mcfg["rnn_config"]["dec_vocab_size"],
        "dec_key": dec_key,
        "stop_limit": stop_limit,
        "compute_dtype": compute_dtype,
        "entries": entries,
    }
    if quantization:
        manifest["quantization"] = (
            f"{quantization} weight-only, symmetric per-output-channel, "
            "dequantized to float32 once at load")
    if i2w is not None:
        vpath = os.path.join(out_dir, "vocab.json")
        with open(vpath, "w") as f:
            json.dump({int(i): (w.decode() if isinstance(w, bytes) else w)
                       for i, w in i2w.items()}, f, indent=0)
        manifest["vocab"] = "vocab.json"
    mpath = os.path.join(out_dir, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=2)
    return mpath
