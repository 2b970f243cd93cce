"""The port's native (C++) readers, loaded through ctypes: the Kaldi
text-ark parser and the shorten v2 decoder, copies of
``ast_tpu/native/{ark_parser,shorten_dec}.cc``.

``library()`` builds them at first use with ``g++ -O3 -shared -fPIC``
into ``build/`` at the root of the checkout, named by a hash of the
sources and flags as ``kernels/build.py`` names the CUDA library, so an
edited source rebuilds and an unchanged one loads at once.  ``g++``
writes to a name of its own process and ``os.replace`` moves the result
into place, under an exclusive ``fcntl.flock`` on a lock file beside it
and a ``threading.Lock``: processes and threads whose first calls come
at once build the library once, and none loads a half-written file.
Nothing is built on import.  A failed build raises with the compiler's
stderr; only a machine with no ``g++`` at all takes the Python readers,
and says so in one line on stderr.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

SRCS = [Path(__file__).resolve().parent / n
        for n in ("ark_parser.cc", "shorten_dec.cc")]
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_no_compiler = False
_lock = threading.Lock()


class _ArkResult(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_float)),
        ("n_floats", ctypes.c_longlong),
        ("rows", ctypes.POINTER(ctypes.c_longlong)),
        ("n_utts", ctypes.c_longlong),
        ("cols", ctypes.c_int),
        ("names", ctypes.c_char_p),
        ("names_len", ctypes.c_longlong),
    ]


class _ShnResult(ctypes.Structure):
    _fields_ = [
        ("samples", ctypes.POINTER(ctypes.c_int32)),
        ("n", ctypes.c_longlong),
        ("nchan", ctypes.c_int),
        ("ftype", ctypes.c_int),
        ("verbatim", ctypes.POINTER(ctypes.c_uint8)),
        ("verbatim_len", ctypes.c_longlong),
        ("error", ctypes.c_char_p),
    ]


def library_path():
    """Path of the library for the current sources, built if missing;
    None when there is no ``g++``."""
    build_dir = Path(BUILD_DIR)
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in SRCS:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    so = build_dir / f"ast_tpu_torch_native_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(so.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():        # another process may have built it
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            res = subprocess.run([gxx, *FLAGS, *map(str, SRCS), "-o",
                                  str(tmp)], capture_output=True, text=True)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed to build {so.name}:\n"
                                   + res.stderr[-4000:])
            os.replace(tmp, so)
    return so


def library():
    """The loaded native library, or None (after one line on stderr)
    when the machine has no ``g++``."""
    global _lib, _no_compiler
    if _lib is not None or _no_compiler:
        return _lib
    with _lock:
        if _lib is None and not _no_compiler:
            path = library_path()
            if path is None:
                _no_compiler = True
                print("ast_tpu_torch.native: no g++ on PATH; the Kaldi ark "
                      "and shorten readers run in Python", file=sys.stderr)
                return None
            lib = ctypes.CDLL(str(path))
            lib.ark_parse_text.restype = ctypes.POINTER(_ArkResult)
            lib.ark_parse_text.argtypes = [ctypes.c_char_p]
            lib.ark_free.argtypes = [ctypes.POINTER(_ArkResult)]
            lib.shn_decode.restype = ctypes.POINTER(_ShnResult)
            lib.shn_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                       ctypes.c_longlong]
            lib.shn_free.argtypes = [ctypes.POINTER(_ShnResult)]
            _lib = lib
    return _lib


def shn_decode(data, max_samples=None):
    """Shorten v2 stream -> (ftype, (n, nchan) int32, verbatim bytes)
    through the C++ decoder; ValueError with the decoder's message on a
    malformed stream; None when there is no library."""
    lib = library()
    if lib is None:
        return None
    res = lib.shn_decode(bytes(data), len(data),
                         -1 if max_samples is None else int(max_samples))
    if not res:
        raise MemoryError("shn_decode allocation failed")
    try:
        r = res.contents
        if r.error:
            raise ValueError(r.error.decode())
        n, nchan = int(r.n), int(r.nchan)
        if n:
            samples = np.ctypeslib.as_array(
                r.samples, shape=(n * nchan,)).copy().reshape(n, nchan)
        else:
            samples = np.zeros((0, max(nchan, 1)), dtype=np.int32)
        verb = b""
        if r.verbatim_len:
            verb = bytes(np.ctypeslib.as_array(
                r.verbatim, shape=(int(r.verbatim_len),)))
        return int(r.ftype), samples, verb
    finally:
        lib.shn_free(res)


def text_ark(path):
    """[(utt_id, (T, D) float32)] of a text ark through the C++ parser,
    or None when there is no library.

    Parses and validates eagerly: the C++ pass assumes one column count
    for the whole file, so a ragged, truncated or mixed-dims ark shows as
    a float-count mismatch and raises ValueError -- the caller then takes
    the per-matrix Python parser instead of slicing misaligned views out
    of the flat buffer."""
    lib = library()
    if lib is None:
        return None
    res = lib.ark_parse_text(str(path).encode())
    if not res:
        raise IOError(f"failed to parse ark: {path}")
    try:
        r = res.contents
        n = int(r.n_utts)
        if n == 0:
            return []
        cols = int(r.cols)
        rows = np.ctypeslib.as_array(r.rows, shape=(n,)).copy()
        total = int(rows.sum())
        names = (r.names or b"").decode().split("\n")
        if (cols <= 0 or (rows < 0).any() or len(names) != n
                or total * cols != int(r.n_floats)):
            raise ValueError(
                f"ark {path} is not representable by the fast parser "
                f"(ragged dims or malformed matrix markers)")
        flat = np.ctypeslib.as_array(r.data, shape=(total * cols,)).copy()
    finally:
        lib.ark_free(res)
    items, offset = [], 0
    for i in range(n):
        t = int(rows[i])
        items.append(
            (names[i], flat[offset: offset + t * cols].reshape(t, cols)))
        offset += t * cols
    return items
