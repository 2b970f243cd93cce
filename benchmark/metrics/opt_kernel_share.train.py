"""The share (%) of the traced window's training steps whose optimizer
update ran through the program's optimizer kernel: the program's
``train.opt_kernel_updates`` counter (``ops/fused_optimizer.py``, one a
step through the kernel) over the window's ``train.step`` spans.  None
where the program recorded no such counter (a program without the
kernel, or one whose steps all took the plain version)."""

from benchmark.core.spans import per_step

COUNTER = "train.opt_kernel_updates"


def read(rec):
    return per_step(rec, lambda got: 100.0 * got["counters"][COUNTER]
                    if COUNTER in got["counters"] else None)
