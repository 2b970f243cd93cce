"""The share (%) of the training batches' padded frames (rows x T) that
hold an utterance's frames: the program's ``train.frames_real`` over
``train.frames_padded`` counters in the window."""

from benchmark.core.spans import frame_use


def read(rec):
    return frame_use(rec, "train")
