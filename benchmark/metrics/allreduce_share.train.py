"""The share (%) of rank 0's traced device time spent in NCCL's
all-reduce kernels (the device spans whose name holds ``AllReduce``, the
gradients' all-reduce and the losses' sum) over the union of its device
spans (``traffic/train_dp4.py``)."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("busy_s"):
        return None
    if rec.get("allreduce_s") is None:
        return None
    return 100.0 * rec["allreduce_s"] / rec["busy_s"]
