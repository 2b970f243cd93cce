"""Packed feature store: one mmap-able file per split -- the port's copy
of ``ast_tpu/data/feature_pack.py`` (the same ``ASTPACK1`` files).

The reference stores one ``.npy`` per utterance (17k files for the
fisher 20h train split, reference: prep_speech_segments.py:56-66,
dataloader.py:95-108), so a cold first epoch pays one open+read per
utterance per epoch on whatever filesystem hosts the corpus.  A pack
concatenates every utterance's feature matrix into a single file with a
trailing index; the reader memory-maps it once and serves zero-copy
slices, letting the OS page cache do the caching — no per-utterance
syscalls, no Python-side cache growth.

Layout:
    bytes 0..7     magic ``ASTPACK1``
    bytes 8..15    little-endian u64: index offset
    bytes 16..     concatenated row-major feature matrices
    index          pickled {utt: (byte_offset, T, D, dtype_str)}

Float16 storage halves the file; the reader casts slices to float32
(the loader contract).  Write via :func:`pack_features` or the
``prep_data pack-features`` subcommand; the Fisher dataloader picks up
``<speech_path>/<set_key>.pack`` automatically.
"""

import os
import pickle
import struct

import numpy as np

MAGIC = b"ASTPACK1"


def write_pack(out_path, items, dtype=None):
    """Write ``items`` — an iterable of (utt, (T, D) array) — to a pack.

    ``dtype``: optional storage dtype override (e.g. np.float16 to halve
    the file); default keeps each array's own dtype."""
    index = {}
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", 0))  # index offset patched below
        for utt, mat in items:
            mat = np.ascontiguousarray(mat)
            if dtype is not None:
                mat = mat.astype(dtype)
            if mat.ndim != 2:
                raise ValueError(f"{utt}: expected (T, D), got {mat.shape}")
            if utt in index:
                # last-wins would leave orphaned bytes and silently
                # serve the wrong features for a mis-laid-out corpus
                raise ValueError(
                    f"duplicate utterance key {utt!r} in pack input "
                    f"(same stem in two subdirectories?)")
            index[utt] = (f.tell(), mat.shape[0], mat.shape[1],
                          mat.dtype.str)
            f.write(mat.tobytes())
        idx_off = f.tell()
        pickle.dump(index, f, protocol=2)
        f.seek(len(MAGIC))
        f.write(struct.pack("<Q", idx_off))
    os.replace(tmp, out_path)
    return len(index)


def pack_features(src_dir, out_path, dtype=None):
    """Pack every ``*.npy`` under ``src_dir`` (including one level of
    subdirectories — the reference's train-split date-subdir layout,
    reference: prep_speech_segments.py:56-66) into ``out_path``."""
    def walk():
        for root, _, files in sorted(os.walk(src_dir)):
            for fname in sorted(files):
                if fname.endswith(".npy"):
                    yield (fname[:-4],
                           np.load(os.path.join(root, fname)))

    return write_pack(out_path, walk(), dtype=dtype)


class FeaturePack:
    """Memory-mapped reader over a pack file."""

    def __init__(self, path):
        self.path = path
        with open(path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError(f"{path}: not a feature pack")
            (idx_off,) = struct.unpack("<Q", f.read(8))
            f.seek(idx_off)
            self.index = pickle.load(f)
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")

    def __contains__(self, utt):
        return utt in self.index

    def __len__(self):
        return len(self.index)

    def get(self, utt, max_rows=None):
        """(T, D) float32 array (a copy — safe to mutate/augment)."""
        off, T, D, dtype_str = self.index[utt]
        dt = np.dtype(dtype_str)
        if max_rows is not None:
            T = min(T, int(max_rows))
        raw = self._mm[off:off + T * D * dt.itemsize]
        return np.frombuffer(raw, dtype=dt).reshape(T, D).astype(
            np.float32)
