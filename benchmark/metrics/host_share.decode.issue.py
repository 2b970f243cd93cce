"""The share (%) of the traced window that the host spent in the decode
pipeline's ``decode.issue`` spans: a batch's features and decode
launched (the program's spans, ``NN.decode_beam_set``)."""

from benchmark.core.spans import host_share


def read(rec):
    return host_share(rec, "decode", "decode.issue")
