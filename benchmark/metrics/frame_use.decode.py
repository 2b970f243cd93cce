"""The share (%) of the decoded batches' padded frames (rows x T) that
hold an utterance's frames: the program's ``decode.frames_real`` over
``decode.frames_padded`` counters in the window."""

from benchmark.core.spans import frame_use


def read(rec):
    return frame_use(rec, "decode")
