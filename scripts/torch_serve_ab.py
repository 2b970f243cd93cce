#!/usr/bin/env python3
"""Phase 9 of ``chip_smoke.py`` (serving: export es_en_20h, serve it over
HTTP, greedy and beam 5,5 requests at one and at eight clients) in two
checkouts of the port, in turns, on one NVIDIA GPU.

    python3 scripts/torch_serve_ab.py OTHER_DIR [THIS_DIR]

Runs each checkout's own ``chip_smoke.run_serving`` as a fresh process,
in the order OTHER_DIR, this checkout (THIS_DIR, default the one holding
this script), this checkout, OTHER_DIR; each builds its kernels into its
own build/ and prints its phase-9 lines (requests/s and latency at each
client count, tagged with the checkout).  Needs a CUDA device; exits 2
without one, and 1 if a run fails.
"""

import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(tree, tag):
    """One checkout's phase 9, in this process."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import chip_smoke as cs
    import torch

    from ast_tpu_torch.kernels import build

    tf32_default = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    build.library()
    print(f"[{tag}] {tree}: build {time.perf_counter() - t0:.1f} s",
          flush=True)
    with tempfile.TemporaryDirectory() as root:
        exp, _, paths = cs.make_experiment(root)
        t0 = time.perf_counter()
        cs.run_serving(exp, paths, root, smi, tf32_default)
        print(f"[{tag}] phase 9 {time.perf_counter() - t0:.1f} s",
              flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1] == "--run":
        run(os.path.abspath(sys.argv[2]), sys.argv[3])
        return 0
    other = os.path.abspath(sys.argv[1])
    this = os.path.abspath(sys.argv[2]) if len(sys.argv) > 2 else HERE
    failed = 0
    for tag, tree in (("other", other), ("this", this), ("this", this),
                      ("other", other)):
        failed |= subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--run", tree, tag]).returncode != 0
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
