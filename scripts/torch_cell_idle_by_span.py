#!/usr/bin/env python3
"""A benchmark cell's traced run with its device idle time put down to
the program's spans.

    python3 scripts/torch_cell_idle_by_span.py \
        --workload es_en_20h.train_fisher20h --seed 7 --seconds 30 \
        [--out DIR]

Runs ``benchmark/run.py``'s cell with ``--trace 1`` in this process,
keeps the window's ``torch.profiler`` profile, and after the run lays
its device spans over the spans the program recorded in the window
(``ast_tpu_torch.utils.profiling.idle_by_span``).  Standard output: the
run's result line, then one JSON line: the window's idle time by the
innermost main-thread span open over it, the idle time during which a
feed worker's span was open, and the spans' and counters' totals.
``--out`` also writes that line to ``DIR/idle_by_span.<cell>.<seed>.json``.
"""

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "benchmark", ".cache",
                                              "triton")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch.profiler

    from ast_tpu_torch.utils import profiling
    from benchmark.core import cli

    profiles = []

    class KeptProfile(torch.profiler.profile):
        """The window's profile, kept, with its bounds on the spans'
        clock."""

        def start(self):
            profiles.append(self)
            super().start()
            self.t0 = time.time_ns()

        def stop(self):
            self.t1 = time.time_ns()
            super().stop()

    torch.profiler.profile = KeptProfile
    profiling.reset()
    rc = cli.run(["--workload", args.workload, "--seed", str(args.seed),
                  "--seconds", str(args.seconds), "--trace", "1"],
                 T_START, root=os.path.join(ROOT, "benchmark"))
    if rc or len(profiles) != 1:
        return rc or 1
    prof = profiles[0]
    out = profiling.idle_by_span(profiling.trace_device_spans(prof),
                                 profiling.RECORDER.spans(),
                                 window=(prof.t0, prof.t1))
    out.update(workload=args.workload, seed=args.seed,
               totals=profiling.totals())
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"idle_by_span.{args.workload}."
                                      f"{args.seed}.json")
        with open(path, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
