"""Throughput accounting and trace capture: the counterpart of
``ast_tpu/utils/profiling.py`` on ``torch.profiler``.
"""

import contextlib
import os
import time

import torch


class StepTimer:
    """Wall time, items and steps over externally timed regions (an
    epoch timed up to its last device sync: a clock around one
    asynchronous step would time the enqueue)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time, self.total_items, self.n_steps = 0.0, 0, 0

    def add(self, dt, n_items, n_steps=1):
        self.total_time += dt
        self.total_items += n_items
        self.n_steps += n_steps

    @property
    def items_per_sec(self):
        return self.total_items / self.total_time if self.total_time else 0.0


@contextlib.contextmanager
def profile_trace(logdir):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when there is a card) and write a Chrome trace,
    ``<logdir>/trace_<unix time>.json`` (open in chrome://tracing or
    Perfetto).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()    # the trace holds the queued work
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{int(time.time())}.json"))

