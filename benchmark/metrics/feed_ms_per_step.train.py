"""Milliseconds of the feed workers' work a training step: the summed
``feed.assemble`` (a batch assembled on the host) and ``feed.stage``
(its copy to the device staged) spans over the window's ``train.step``
spans."""

from benchmark.core.spans import per_step


def _feed_ms(got):
    spans = got["spans"]
    return 1e3 * sum(spans[k]["s"] for k in ("feed.assemble", "feed.stage")
                     if k in spans)


def read(rec):
    return per_step(rec, _feed_ms)
