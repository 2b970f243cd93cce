"""Build the hand-written CUDA kernels at first use and load them.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` -- one process per
source, all started together -- and links the objects into one shared
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
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
# argtypes of each exported entry point (pointers and the stream as
# c_void_p, so 64-bit addresses are never cut to an int)
_SIGNATURES = {
    "k1_encoder_forward": [_P] * 8 + [_I] * 5 + [_P],
    "k1_encoder_forward_bf16": [_P] * 8 + [_I] * 5 + [_P],
    "k1_encoder_forward_train": [_P] * 11 + [_I] * 7 + [_U, _U, _F, _P],
    "k1_encoder_forward_train_bf16": [_P] * 13 + [_I] * 7
    + [_U, _U, _F, _P],
    "k2_encoder_backward": [_P] * 9 + [_I] * 7 + [_U, _U, _F, _P],
    "k2_encoder_backward_bf16": [_P] * 10 + [_I] * 7 + [_U, _U, _F, _P],
    "k3_decoder_forward": [_P] * 26 + [_I] * 9
    + [_U, _U, _F, _U, _F, _I, _P],
    "k3_decoder_forward_bf16": [_P] * 30 + [_I] * 9
    + [_U, _U, _F, _U, _F, _I, _P],
    "k4_decoder_backward": [_P] * 18 + [_I] * 8
    + [_U, _U, _F, _U, _F, _I, _P],
    "k4_decoder_backward_bf16": [_P] * 22 + [_I] * 8
    + [_U, _U, _F, _U, _F, _I, _P],
    "k5_greedy_decode": [_P] * 20 + [_I] * 9 + [_P],
    "k5_greedy_decode_bf16": [_P] * 20 + [_I] * 9 + [_P],
    "k6_beam_decode": [_P] * 25 + [_I] * 11 + [_P],
    "k6_beam_decode_bf16": [_P] * 25 + [_I] * 11 + [_P],
    # the optimizer: launch 1 (squares, counts), launch 2 (the update)
    "opt_amsgrad_norm": [_P, _I, _F, _I] + [_P] * 4,
    "opt_amsgrad_update": [_P, _I, _P, _F, _I] + [_P] * 5,
    # not launches: fills records, returns their number (cluster_choices);
    # the rows of k2_encoder_backward_bf16's scratch; the optimizer's
    # partial sums a row for a tree of n leaves
    "ast_cluster_choices": [_P, _I],
    "k2_work_rows": [],
    "opt_partials": [_I],
}

_lib = None
# held while the library is built and loaded: the server's warm-up and
# request threads may make their first kernel call at once, and two
# builds in one process would share the object directory and .tmp.so
_lib_lock = threading.Lock()
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
    obj_dir = BUILD_DIR / f"{so.stem}.{os.getpid()}.obj"
    obj_dir.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o",
               str(obj_dir / f"{src.stem}.o"), str(src)]
        jobs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    link = [nvcc, *ARCH, "-shared", "-o", str(tmp),
            *[str(obj_dir / f"{Path(c[-1]).stem}.o") for c, _ in jobs]]
    logs, failed = [], []
    for cmd, proc in jobs:
        out = proc.communicate()[0]
        logs.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    if not failed:
        res = subprocess.run(link, capture_output=True, text=True)
        logs.append(" ".join(link) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.stderr)
    seconds = time.perf_counter() - t0
    log = so.with_suffix(".log")
    log.write_text("\n".join(logs))
    shutil.rmtree(obj_dir, ignore_errors=True)
    if failed:
        raise RuntimeError(f"nvcc failed, see {log}:\n"
                           + "\n".join(f[-4000:] for f in failed))
    os.replace(tmp, so)
    last_build.update(seconds=seconds, path=str(so), log=str(log))
    return so


def library():
    """The loaded kernel library (built on first call; one build per
    process, however many threads ask for it at once)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(library_path()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


_CLUSTER_KINDS = ("linear product", "cell product", "train cell product",
                  "backward product", "attention", "train attention",
                  "attention backward", "encoder cell wave",
                  "encoder train cell wave", "encoder backward wave")


def cluster_choices():
    """The thread-block cluster sizes the kernels' launches have
    taken so far in this process (decode_step.cu chooses one per launch
    shape with cudaOccupancyMaxActiveClusters): a list of dicts with kind,
    rows (of a product's block; 0 for attention), clusters (column slices
    or utterances), tiles (32-row input tiles, or T' for attention),
    smem_kb, cluster and sms (clusters * cluster)."""
    cap = 1024
    buf = (ctypes.c_int * (7 * cap))()
    n = min(library().ast_cluster_choices(buf, cap), cap)
    keys = ("kind", "rows", "clusters", "tiles", "smem_kb", "cluster", "sms")
    out = []
    for i in range(n):
        rec = dict(zip(keys, buf[7 * i:7 * i + 7]))
        rec["kind"] = _CLUSTER_KINDS[rec["kind"]]
        out.append(rec)
    return out


def check_tensor(t, name, shape=None, dtype=torch.float32):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` (when given)."""
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous {dtype} CUDA "
                         f"tensors (got {t.dtype} on {t.device}, "
                         f"contiguous={t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def check_launch(name, code):
    """Raise if an entry point reported a refused launch."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")
