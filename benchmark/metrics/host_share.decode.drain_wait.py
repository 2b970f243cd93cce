"""The share (%) of the traced window that the host spent in the decode
pipeline's ``decode.drain_wait`` spans: the copy of the oldest batch's
answers to the host, which waits for the device (the program's spans,
``NN.decode_beam_set``)."""

from benchmark.core.spans import host_share


def read(rec):
    return host_share(rec, "decode", "decode.drain_wait")
