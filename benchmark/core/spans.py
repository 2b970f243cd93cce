"""The program's own spans and counters in a traced run.

The program (``ast_tpu_torch.utils.profiling``) records its spans and
counters only while a ``torch.profiler`` profile runs, and a run's only
profile is the traced window (``--trace 1``): what the recorder holds
once the window is over is the window's.  A program without the
recorder, an untraced record and an empty record read as None.
"""


def totals(rec, under=None):
    """The recorder's ``totals(under)`` after a traced window: ``{"spans":
    {name: {"s", "n"}}, "counters": {name: sum}}``; None when ``rec`` has
    no ``window_s`` or ``busy_s``, the program has no recorder, or it
    recorded nothing."""
    if not rec.get("window_s") or rec.get("busy_s") is None:
        return None
    try:
        from ast_tpu_torch.utils.profiling import totals as recorded
    except ImportError:
        return None
    out = recorded(under=under)
    if not out["spans"] and not out["counters"]:
        return None
    return out


def host_share(rec, kind, name, under=None):
    """100 x the summed seconds of the program's ``name`` spans (those
    inside an ``under`` span) over the window, in a ``kind`` run: 0 when
    the window recorded other spans but none of these; None when it
    recorded nothing."""
    if rec.get("kind") != kind or totals(rec) is None:
        return None
    got = totals(rec, under)
    secs = got["spans"].get(name, {}).get("s", 0.0) if got else 0.0
    return 100.0 * secs / rec["window_s"]


def per_step(rec, value):
    """``value(totals)`` over the window's ``train.step`` spans, in a
    training run; None when not recorded."""
    if rec.get("kind") != "train":
        return None
    got = totals(rec)
    steps = got and got["spans"].get("train.step", {}).get("n")
    if not steps:
        return None
    v = value(got)
    return None if v is None else v / steps


def frame_use(rec, kind):
    """100 x the real frames of the window's batches over their padded
    frames (``<kind>.frames_real`` / ``<kind>.frames_padded``)."""
    if rec.get("kind") != kind:
        return None
    got = totals(rec)
    padded = got and got["counters"].get(f"{kind}.frames_padded")
    if not padded:
        return None
    return 100.0 * got["counters"].get(f"{kind}.frames_real", 0) / padded
