#!/usr/bin/env python3
"""Run one cell of the benchmark of ast_tpu_torch on this machine's
CUDA devices and print its result line.

    python3 benchmark/run.py --workload es_en_20h.train_fisher20h \
        --seed 7 --seconds 30 --trace 0

See ``benchmark/README.md``.  It exits with a code other than 0, and
prints no result, when the cell's devices are not there.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(ROOT))
# the program's kernel caches stay in the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".cache", "triton")

from benchmark.core.cli import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(sys.argv[1:], T_START, root=ROOT))
