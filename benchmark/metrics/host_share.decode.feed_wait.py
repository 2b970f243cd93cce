"""The share (%) of the traced window in which the decode loop waited for
its next batch from the feed (the program's ``feed.wait`` spans inside
``decode.pass``: ``Prefetcher.__iter__``)."""

from benchmark.core.spans import host_share


def read(rec):
    return host_share(rec, "decode", "feed.wait", under="decode.pass")
