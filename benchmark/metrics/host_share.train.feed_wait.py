"""The share (%) of the traced window in which the training loop waited
for its next batch from the feed (the program's ``feed.wait`` spans
inside ``train.epoch``: ``Prefetcher.__iter__``)."""

from benchmark.core.spans import host_share


def read(rec):
    return host_share(rec, "train", "feed.wait", under="train.epoch")
