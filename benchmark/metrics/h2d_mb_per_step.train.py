"""Megabytes (1e6 bytes) copied from the host to the device a training
step: the program's ``feed.h2d_bytes`` counter (``NN._put``) over the
window's ``train.step`` spans."""

from benchmark.core.spans import per_step


def read(rec):
    return per_step(rec, lambda got: got["counters"].get(
        "feed.h2d_bytes", 0) / 1e6)
