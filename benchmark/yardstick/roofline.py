"""A kernel's share of its roofline over a run's timed calls."""

from benchmark.yardstick.kernel_cost import (
    PEAK_BF16_FLOPS, PEAK_F32_FLOPS, bound, kernel_cost)


def share(rec, kernel):
    """100 x (sum of the calls' bounds) / (sum of their device times) of
    ``kernel``'s calls in ``rec["kernels"]``; None without calls."""
    calls = (rec.get("kernels") or {}).get(kernel) or []
    if not calls:
        return None
    least = sum(bound(*kernel_cost(key, d), peak=(
        PEAK_BF16_FLOPS if d.get("wbytes", 4) == 2 else PEAK_F32_FLOPS))[0]
        for key, d, _ in calls)
    return 100.0 * least / sum(ms for _, _, ms in calls)
