"""The share (%) of the traced window that the host spent in the
program's ``train.all_reduce`` spans: the gradients' all-reduce over the
data-parallel ranks (``train/trainer.py``, inside ``train.backward``),
rank 0's.  None where the program records no such span."""

from benchmark.core.spans import host_share, totals

SPAN = "train.all_reduce"


def read(rec):
    got = totals(rec) if rec.get("kind") == "train" else None
    if not got or SPAN not in got["spans"]:
        return None
    return host_share(rec, "train", SPAN)
