"""``python3 benchmark/run.py --workload NAME --seed N --seconds S
--trace 0|1``: one run of one cell, and its result line.

Everything a cell needs is found by name: the cell's file
``workloads/<name>.json`` names its configuration
(``configs/<config>.json``) and its traffic mix
(``traffic/<traffic>.json``), the mix names its driver
(``traffic/<driver>.py``, whose ``run(ctx)`` returns the run's record),
and each metric of ``BENCHMARK.json`` that the cell reports is read from
the record by ``metrics/<metric name>.py``'s ``read(rec)`` (None: not
reported).  A run reports its end-to-end metrics with ``--trace 0`` and
its per-layer metrics with ``--trace 1``; the cell's ``limits`` hold the
numbers that decide ``correct``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each number compared, beside its
limit); the same numbers are the last lines of standard error.
"""

import argparse
import contextlib
import importlib.util
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "ast_tpu")
PEAKS = {"float32": "PEAK_F32_FLOPS", "bfloat16": "PEAK_BF16_FLOPS"}


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(root, name):
    """The ``read(rec)`` of ``metrics/<name>.py``."""
    path = os.path.join(root, "metrics", f"{name}.py")
    return _load(path, "benchmark_metric_" + name.replace(".", "_")).read


def _json(path):
    with open(path) as f:
        return json.load(f)


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is JAX's, jaxlib's, flax's
    or the JAX package's (whole names: ``ast_tpu_torch`` is not
    ``ast_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


class Context:
    """What a driver gets: the cell's files, the run's arguments, the
    device, and the window's tracing."""

    def __init__(self, root, name, cell, config, mix, args, device,
                 t_start, metrics=()):
        self.root, self.name, self.cell = root, name, cell
        # the names of the metrics this run reports
        self.metrics = list(metrics)
        self.config, self.mix = config, mix
        self.seed, self.seconds = int(args.seed), float(args.seconds)
        self.trace = bool(args.trace)
        self.device = device
        self.t_start = t_start
        self.cache = os.path.join(root, ".cache")

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self):
        import torch
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def peak_flops(self, dtype):
        from benchmark.yardstick import kernel_cost
        return getattr(kernel_cost, PEAKS[dtype])

    @contextlib.contextmanager
    def window(self, timers=None):
        """The measured window; traced (``--trace 1``) under
        torch.profiler's CUDA activity with ``timers`` installed.
        ``result()`` of the yielded object: the trace's busy seconds and
        breakdown (empty untraced)."""
        win = _Window()
        if not self.trace or self.device.type != "cuda":
            with timers if timers is not None else contextlib.nullcontext():
                yield win
            return
        from torch.profiler import ProfilerActivity, profile

        from benchmark.yardstick.trace import (
            breakdown, device_busy_ms, device_spans)
        with timers if timers is not None else contextlib.nullcontext():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                yield win
        busy_ms, win.spans = device_busy_ms(prof)
        win.busy_s = busy_ms / 1e3
        win.breakdown = breakdown(device_spans(prof))


class _Window:
    busy_s = None
    spans = 0
    breakdown = None

    def result(self):
        if self.busy_s is None:
            return {}
        return {"busy_s": self.busy_s, "device_spans": self.spans,
                "breakdown": self.breakdown}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(argv, t_start, root=HERE, bench_path=None, device=None,
        out=sys.stdout, err=sys.stderr):
    """One run; returns the exit code.  ``device`` None: the cell's
    CUDA devices, which must be there; a tests' CPU run passes
    ``"cpu"``."""
    args = parse(argv)
    bench_path = bench_path or os.path.join(os.path.dirname(root),
                                            "BENCHMARK.json")
    bench = _json(bench_path)
    cell = _json(os.path.join(root, "workloads", f"{args.workload}.json"))
    config = _json(os.path.join(root, "configs", f"{cell['config']}.json"))
    mix = _json(os.path.join(root, "traffic", f"{cell['traffic']}.json"))

    import torch
    if device is None:
        chips = int(cell.get("chips", 1))
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < chips:
            print(f"no result: {args.workload} needs {chips} CUDA "
                  f"device(s), this machine has {have}", file=err,
                  flush=True)
            return 2
        device = "cuda:0"
    device = torch.device(device)
    driver = _load(os.path.join(root, "traffic", f"{mix['driver']}.py"),
                   f"benchmark_driver_{mix['driver']}")
    kind = "per_layer" if args.trace else "end_to_end"
    wanted = [m for m in bench[kind] if applies(m, args.workload)]
    ctx = Context(root, args.workload, cell, config, mix, args, device,
                  t_start, [m["name"] for m in wanted])
    rec = driver.run(ctx)

    metrics = {}
    for m in wanted:
        value = load_metric(root, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    limits = cell["limits"]
    # a reading that is no number (no answer to read) is the largest
    checks = {k: {"value": min(float(rec["readings"][k]), sys.float_info.max),
                  "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    bad = forbidden_modules()
    if bad:
        print(f"no result: the run loaded {', '.join(bad)}", file=err,
              flush=True)
        return 3
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell.get("chips", 1)),
           "memory_peak_bytes": rec["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": rec["attempted"],
            "failed": rec["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        dev.update(busy_s=rec.get("busy_s"), window_s=rec["window_s"])
        if rec.get("breakdown"):
            line["breakdown"] = rec["breakdown"]
    line["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0
