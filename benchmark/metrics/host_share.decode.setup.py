"""The share (%) of the traced window that the host spent in the decode
pipeline's ``decode.setup`` spans: a pass's set-up, the weights
gathered and packed for the decoders (``decode_weights``) and the beam
builder (the program's spans, ``NN.decode_beam_set``)."""

from benchmark.core.spans import host_share


def read(rec):
    return host_share(rec, "decode", "decode.setup")
