"""Kaldi archive (.ark) readers — text and binary — plus the
per-conversation repacking the reference pipeline performs: the port's
copy of ``ast_tpu/data/kaldi_ark.py``.

Replaces the reference's text-ark parser (reference:
linking_files/kaldi_io.py:12-53) and the Kaldi C++ ``copy-feats`` /
``extract-segments`` binaries it depended on.  Text arks go through the
port's native C++ parser (:mod:`ast_tpu_torch.native`, built by ``g++``
at first use); ``_read_text_ark_py`` is its reference, and the path a
ragged ark (or a machine without ``g++``) takes.

Formats:
- text ark:   ``utt_id  [\n v v v ...\n ... v v v ]\n``
- binary ark: ``utt_id \0B FM \4 <rows> \4 <cols> <f32 data>`` ("FM"
  float matrix; also reads "DM" double matrices)
"""

import os
import pickle
import struct

import numpy as np


def read_text_ark(path):
    """Yield (utt_id, (T, D) float32 array) from a text-format ark."""
    from ast_tpu_torch import native
    try:
        # eager parse+validate: raises before yielding anything
        items = native.text_ark(path)
    except ValueError:
        # ragged/mixed-dims ark the flat C++ layout can't represent
        items = None
    if items is not None:
        yield from items
        return
    yield from _read_text_ark_py(path)


def _read_text_ark_py(path):
    utt = None
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[-1] == "[":
                if utt is not None and rows:
                    yield utt, np.asarray(rows, dtype=np.float32)
                utt = parts[0]
                rows = []
            else:
                if parts[-1] == "]":
                    parts = parts[:-1]
                    if parts:      # ']' may sit on its own line —
                        # Kaldi's reader is whitespace-insensitive
                        rows.append([float(v) for v in parts])
                    yield utt, np.asarray(rows, dtype=np.float32)
                    utt, rows = None, []
                else:
                    rows.append([float(v) for v in parts])
    if utt is not None and rows:
        yield utt, np.asarray(rows, dtype=np.float32)


def read_binary_ark(path):
    """Yield (utt_id, matrix) from a Kaldi binary ark of float matrices."""
    with open(path, "rb") as f:
        while True:
            utt = _read_token(f)
            if utt is None:
                return
            marker = f.read(2)
            if marker != b"\0B":
                raise ValueError(f"not a binary ark entry at utt {utt!r}")
            mtype = _read_token_bytes(f)
            if mtype not in (b"FM", b"DM"):
                raise ValueError(f"unsupported matrix type {mtype!r}")
            rows = _read_basic_int(f)
            cols = _read_basic_int(f)
            dtype = np.float32 if mtype == b"FM" else np.float64
            data = np.frombuffer(
                f.read(rows * cols * dtype().itemsize), dtype=dtype
            ).reshape(rows, cols)
            yield utt, data.astype(np.float32)


def _read_token(f):
    chars = []
    while True:
        c = f.read(1)
        if not c:
            return None
        if c == b" ":
            break
        chars.append(c)
    return b"".join(chars).decode()


def _read_token_bytes(f):
    tok = []
    while True:
        c = f.read(1)
        if c == b" " or not c:
            break
        tok.append(c)
    return b"".join(tok)


def _read_basic_int(f):
    size = struct.unpack("B", f.read(1))[0]
    return int.from_bytes(f.read(size), "little")


def write_binary_ark(path, items):
    """Write (utt_id, (T,D) float32) pairs as a Kaldi binary ark."""
    with open(path, "wb") as f:
        for utt, mat in items:
            mat = np.ascontiguousarray(mat, dtype=np.float32)
            f.write(utt.encode() + b" \0B")
            f.write(b"FM ")
            for dim in mat.shape:
                f.write(struct.pack("B", 4))
                f.write(struct.pack("<i", dim))
            f.write(mat.tobytes())


def ark_to_conversation_pickles(ark_path, out_dir):
    """Group segment matrices per conversation and pickle each as
    ``<conv>.np`` — the reference's repacking step (reference:
    linking_files/kaldi_io.py:12-53; conv = utt.rsplit('-', 2)[0])."""
    os.makedirs(out_dir, exist_ok=True)
    current_conv = None
    seg_data = {}
    flushed = set()
    for utt, mat in read_text_ark(ark_path):
        conv = utt.rsplit("-", 2)[0]
        if current_conv is not None and conv != current_conv:
            _dump_conv(out_dir, current_conv, seg_data, flushed)
            seg_data = {}
        current_conv = conv
        seg_data[utt] = mat
    if seg_data:
        _dump_conv(out_dir, current_conv, seg_data, flushed)
    return len(flushed)


def _dump_conv(out_dir, conv, seg_data, flushed):
    path = os.path.join(out_dir, conv + ".np")
    if conv in flushed:
        # non-contiguous ark (merged or unsorted copy): merge with the
        # earlier flush instead of silently overwriting its segments
        with open(path, "rb") as f:
            prev = pickle.load(f)
        prev.update(seg_data)
        seg_data = prev
    with open(path, "wb") as f:
        pickle.dump(seg_data, f)
    flushed.add(conv)


def merge_segments(seg_arrays):
    """Concatenate per-segment feature matrices into one utterance array
    (reference: linking_files/fisher/prep_speech_segments.py:23-70)."""
    return np.concatenate([np.asarray(a, np.float32) for a in seg_arrays],
                          axis=0)
