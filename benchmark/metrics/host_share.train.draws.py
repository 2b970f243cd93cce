"""The share (%) of the traced window that the host spent in the training
step's ``train.draws`` spans: its random draws and features
(``make_draws``, ``NN.features``), launches included (the program's
spans, ``NN.train_step``)."""

from benchmark.core.spans import host_share


def read(rec):
    return host_share(rec, "train", "train.draws")
