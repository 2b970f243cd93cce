"""Build the hand-written CUDA kernels at first use and load them.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared
library with a plain C interface, loaded through ``ctypes``.  The
library lives in ``build/`` at the root of the checkout, named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing is built on import.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of each exported entry point (pointers and the stream as
# c_void_p, so 64-bit addresses are never cut to an int)
_SIGNATURES = {
    "k1_encoder_forward": [_P] * 7 + [_I] * 5 + [_P],
    "k5_greedy_decode": [_P] * 22 + [_I] * 8 + [_P],
    "k6_beam_decode": [_P] * 28 + [_I] * 10 + [_P],
}

_lib = None
# set by the first build in this process: seconds, library path, log
last_build = {}


def _nvcc():
    for c in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin)")


def library_path():
    """Path of the library for the current sources (built if missing)."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    so = BUILD_DIR / f"ast_tpu_torch_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = so.with_suffix(".log")
    log.write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {res.returncode}), see "
                           f"{log}:\n{res.stderr[-4000:]}")
    os.replace(tmp, so)
    last_build.update(seconds=seconds, path=str(so), log=str(log))
    return so


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(library_path()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_tensor(t, name, shape=None):
    """Raise unless ``t`` is a contiguous float32 CUDA tensor of
    ``shape`` (when given)."""
    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous float32 CUDA "
                         f"tensors (got {t.dtype} on {t.device}, "
                         f"contiguous={t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def check_launch(name, code):
    """Raise if an entry point reported a refused launch."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")
