"""The share (%) of the traced window that the host spent in the training
step's ``train.backward`` spans: its backward
(``torch.autograd.grad``) and the gradients' all-reduce, launches
included (the program's spans, ``NN.train_step``)."""

from benchmark.core.spans import host_share


def read(rec):
    return host_share(rec, "train", "train.backward")
