#!/usr/bin/env python3
"""Read a cell's correctness numbers over many seeds in one process, for
the program and for its controls, without a measured window: what the
cell's limits are set from (``benchmark/README.md``).

    python3 benchmark/calibrate.py --workload es_en_20h.train_fisher20h \
        --seeds 101,102,103 --controls tf32

One JSON line a seed: ``{"seed", "readings": {...}, "<control>":
{...}}``.  The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(ROOT))

from benchmark.core import cli  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = cli._json(os.path.join(ROOT, "workloads", f"{args.workload}.json"))
    config = cli._json(os.path.join(ROOT, "configs",
                                    f"{cell['config']}.json"))
    mix = cli._json(os.path.join(ROOT, "traffic", f"{cell['traffic']}.json"))
    driver = cli._load(os.path.join(ROOT, "traffic", f"{mix['driver']}.py"),
                       f"benchmark_driver_{mix['driver']}")
    controls = [c for c in args.controls.split(",") if c]
    for seed in (int(s) for s in args.seeds.split(",")):
        ns = argparse.Namespace(seed=seed, seconds=0, trace=0)
        ctx = cli.Context(ROOT, args.workload, cell, config, mix, ns,
                          torch.device("cuda:0"), time.perf_counter())
        t0 = time.perf_counter()
        out = driver.calibrate(ctx, controls)
        out = {"seed": seed, "seconds": time.perf_counter() - t0, **out}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
