"""The share (%) of the traced window in which no operation ran on the
device: 1 - the union of the trace's device spans over the window."""


def read(rec):
    if rec.get("kind") != "decode" or not rec.get("busy_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
