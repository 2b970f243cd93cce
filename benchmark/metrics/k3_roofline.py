"""k3's share (%) of its roofline over the window: the sum over its
calls of the least time the call's products and bytes allow at its
dtype's peaks (``benchmark/yardstick/kernel_cost.py``), over the
sum of the calls' device times."""

from benchmark.yardstick.roofline import share


def read(rec):
    return share(rec, "k3")
