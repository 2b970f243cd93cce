"""Utterances of the training steps completed in the window, over the
window's whole time (from its start to the step boundary that ends it,
the device drained)."""


def read(rec):
    if "utts" not in rec or rec.get("kind") != "train":
        return None
    return rec["utts"] / rec["window_s"]
