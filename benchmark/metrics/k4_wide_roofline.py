"""K4's share (%) of its roofline over the window where the encoder
states are wider than the decoder: the sum over its calls of the least
time the call's products and bytes allow at its dtype's peaks, counted
with He apart from H (``benchmark/yardstick/kernel_cost_wide.py``), over
the sum of the calls' device times (``core/wide_probes.py``)."""

from benchmark.yardstick.kernel_cost_wide import share


def read(rec):
    return share(rec, "k4_wide")
