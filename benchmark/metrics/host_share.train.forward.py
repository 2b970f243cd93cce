"""The share (%) of the traced window that the host spent in the training
step's ``train.forward`` spans: its forward and loss
(``seq2seq.forward_loss``), launches included (the program's spans,
``NN.train_step``)."""

from benchmark.core.spans import host_share


def read(rec):
    return host_share(rec, "train", "train.forward")
