"""The share (%) of the traced window that the host spent in the training
step's ``train.optimizer`` spans: its optimizer update and the in-
place add to the parameters, launches included (the program's spans,
``NN.train_step``)."""

from benchmark.core.spans import host_share


def read(rec):
    return host_share(rec, "train", "train.optimizer")
