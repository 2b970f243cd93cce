"""The device's busy time from a ``torch.profiler`` trace, and the
trace's breakdown.

``device_busy_ms`` is a frozen copy of the function of that name in
``scripts/torch_trainer_epoch_bench.py`` at commit
22fa93ac41eb92290dc27e5d3bbe6819cd4b1719, unchanged: the union of the
trace's device spans.  ``device_spans`` and ``breakdown`` are the
benchmark's own, over the same raw events.
"""


def device_busy_ms(prof):
    """The union of a torch.profiler trace's device spans, in ms, and
    their count.  It reads the trace's raw events: an epoch's million
    spans would take minutes through ``prof.events()``."""
    from torch.autograd import DeviceType

    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy, end = 0, -1
    for a, b in spans:
        busy += max(0, b - max(a, end))
        end = max(end, b)
    return busy / 1e6, len(spans)


def device_spans(prof):
    """The trace's device spans as sorted (start_ns, end_ns, name)."""
    from torch.autograd import DeviceType

    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA)


def breakdown(spans, top=10):
    """``{"device_ops": [[name, seconds], ...], "idle_gaps": [[name,
    seconds], ...]}`` of sorted device spans: the ``top`` operations by
    their summed time, and the ``top`` longest gaps in which the device
    ran nothing, each named by the operation that ended before it and
    the one that started after it (the host was issuing the second)."""
    by_name = {}
    gaps = []
    end, last = None, None
    for a, b, name in spans:
        by_name[name] = by_name.get(name, 0) + (b - a)
        if end is not None and a > end:
            gaps.append((a - end, f"{_short(last)} -> {_short(name)}"))
        if end is None or b > end:
            end, last = b, name
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps.sort(key=lambda g: -g[0])
    return {"device_ops": [[_short(n), ns / 1e9] for n, ns in ops],
            "idle_gaps": [[name, ns / 1e9] for ns, name in gaps[:top]]}


def _short(name, n=80):
    """A kernel's name cut to its first ``n`` characters (template
    arguments make some names thousands long)."""
    return name if len(name) <= n else name[:n]
