"""The share (%) of the traced window that the host spent in the decode
pipeline's ``decode.collect`` spans: the answers listed by utterance
on the host (the program's spans, ``NN.decode_beam_set``)."""

from benchmark.core.spans import host_share


def read(rec):
    return host_share(rec, "decode", "decode.collect")
