"""The share (%) of the traced window that the host spent in the
program's ``train.enc_layer`` spans: a jointly stacked listener layer's
input product and recurrence, forward (K1) and backward (K2 and the
gradients' products), launches included (``models/seq2seq.py``
``JointLayer``).  None where the program records no such span."""

from benchmark.core.spans import host_share, totals

SPAN = "train.enc_layer"


def read(rec):
    got = totals(rec) if rec.get("kind") == "train" else None
    if not got or SPAN not in got["spans"]:
        return None
    return host_share(rec, "train", SPAN)
