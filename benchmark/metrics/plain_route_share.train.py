"""The share (%) of the traced window's training-step stages that took
their plain route instead of their kernels, two stages a step (the
encoder: the scan instead of K1 / K2; the decoder: the scan loss instead
of K3 / K4): the program's ``train.plain_stages`` counter
(``models/seq2seq.py`` ``forward_loss``) over twice the window's
``train.step`` spans.  None where the program records no such
counter."""

from benchmark.core.spans import per_step

COUNTER = "train.plain_stages"
# the stages of a step that have a kernel route: encoder, decoder
STAGES = 2


def read(rec):
    return per_step(rec, lambda got: 100.0 * got["counters"][COUNTER]
                    / STAGES if COUNTER in got["counters"] else None)
