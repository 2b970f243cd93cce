"""Throughput accounting, trace capture and the program's spans: the
counterpart of ``ast_tpu/utils/profiling.py`` on ``torch.profiler``.

- :class:`StepTimer`: wall time and items over externally timed regions.
- :func:`profile_trace`: a ``torch.profiler`` profile around a block,
  written out as a Chrome trace and as the block's idle device time put
  down to the program's spans (:func:`idle_by_span`).
- :func:`span` and :func:`count`: the program's spans and counters
  (:class:`Recorder`).  They are armed only while a ``torch.profiler``
  profile runs (``profile_trace``, the benchmark's traced window, an
  operator's own profiler); outside one a span costs one flag read and
  records nothing.  An armed span records its name, start and end on
  ``time.time_ns()`` (the clock of the profiler's events, so a span can
  be laid over the device trace), its thread, its parent (the span open
  on the same thread, or the span a feed worker's ``Prefetcher`` was
  started under) and its attributes, and it enters
  ``torch.profiler.record_function(name)`` so that it shows in the
  Chrome trace beside the kernels.  A span that an exception leaves is
  closed and kept.  ``reset()`` drops what was recorded; ``totals()``
  sums it by name.
"""

import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler


class StepTimer:
    """Wall time, items and steps over externally timed regions (an
    epoch timed up to its last device sync: a clock around one
    asynchronous step would time the enqueue)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time, self.total_items, self.n_steps = 0.0, 0, 0

    def add(self, dt, n_items, n_steps=1):
        self.total_time += dt
        self.total_items += n_items
        self.n_steps += n_steps

    @property
    def items_per_sec(self):
        return self.total_items / self.total_time if self.total_time else 0.0


def armed():
    """Whether a ``torch.profiler`` profile runs, so spans and counters
    record (torch sets the flag while any profile runs, whatever its
    activities)."""
    return _autograd_profiler._is_profiler_enabled


@dataclasses.dataclass(slots=True)
class SpanRecord:
    """One span: times in ``time.time_ns()`` ns; ``thread`` the OS thread
    id (the Chrome trace's ``tid``); ``parent`` the id of the enclosing
    span or None; ``end_ns`` None while it is open."""
    id: int
    name: str
    start_ns: int
    end_ns: int | None
    thread: int
    parent: int | None
    attrs: dict


class _Buffer:
    """One thread's spans, open spans and counters."""

    def __init__(self):
        self.owner = threading.current_thread()
        self.thread = threading.get_native_id()
        self.root = None        # the parent of this thread's outer spans
        self.stack = []
        self.spans = []
        self.counters = {}


class _Span:
    __slots__ = ("_recorder", "_name", "_attrs", "_rf", "_rec", "_buf")

    def __init__(self, recorder, name, attrs):
        self._recorder, self._name, self._attrs = recorder, name, attrs

    def __enter__(self):
        self._rf = _autograd_profiler.record_function(self._name)
        self._rf.__enter__()
        buf = self._buf = self._recorder._buffer()
        parent = buf.stack[-1].id if buf.stack else buf.root
        rec = self._rec = SpanRecord(next(self._recorder._ids), self._name,
                                     0, None, buf.thread, parent,
                                     self._attrs)
        buf.stack.append(rec)
        rec.start_ns = time.time_ns()

    def __exit__(self, *exc):
        rec = self._rec
        rec.end_ns = time.time_ns()
        stack = self._buf.stack
        if stack and stack[-1] is rec:
            stack.pop()
        else:
            stack.remove(rec)
        self._buf.spans.append(rec)
        self._rf.__exit__(*exc)
        return False


_NULL = contextlib.nullcontext()


class Recorder:
    """The program's spans and counters, kept in per-thread buffers
    until :meth:`reset`; armed only while a ``torch.profiler`` profile
    runs."""

    def __init__(self):
        self._local = threading.local()
        self._lock = threading.Lock()
        self._buffers = []
        self._ids = itertools.count(1)

    def _buffer(self):
        buf = getattr(self._local, "buf", None)
        if buf is None:
            buf = self._local.buf = _Buffer()
            with self._lock:
                self._buffers.append(buf)
        return buf

    def span(self, name, **attrs):
        """A context manager: one span named ``name`` over its block."""
        if not _autograd_profiler._is_profiler_enabled:
            return _NULL
        return _Span(self, name, attrs)

    def count(self, name, n=1):
        """Add ``n`` to the counter ``name``."""
        if not _autograd_profiler._is_profiler_enabled:
            return
        counters = self._buffer().counters
        counters[name] = counters.get(name, 0) + n

    def current(self):
        """The id of the innermost span open on this thread (or the span
        the thread was started under), None disarmed or outside any."""
        if not _autograd_profiler._is_profiler_enabled:
            return None
        buf = self._buffer()
        return buf.stack[-1].id if buf.stack else buf.root

    def adopt(self, parent):
        """Make ``parent`` (a :meth:`current` id) the parent of this
        thread's outer spans: a worker started on another's behalf."""
        if parent is not None:
            self._buffer().root = parent

    def reset(self):
        """Drop every span and counter recorded (open spans stay open and
        are kept when they close)."""
        with self._lock:
            for buf in self._buffers:
                buf.spans = []
                buf.counters = {}
            self._buffers = [b for b in self._buffers
                             if b.owner.is_alive()]

    def spans(self):
        """Every closed span, all threads, by start."""
        with self._lock:
            bufs = list(self._buffers)
        return sorted((r for b in bufs for r in list(b.spans)),
                      key=lambda r: r.start_ns)

    def counters(self):
        """Every counter, summed over the threads."""
        with self._lock:
            bufs = list(self._buffers)
        out = {}
        for b in bufs:
            for k, v in dict(b.counters).items():
                out[k] = out.get(k, 0) + v
        return out

    def totals(self, under=None):
        """``{"spans": {name: {"s": summed seconds, "n": count}},
        "counters": {name: sum}}`` of the closed spans (with ``under``,
        of those inside a span of that name) and of the counters."""
        recs = self.spans()
        if under is not None:
            with self._lock:
                bufs = list(self._buffers)
            by_id = {r.id: r for r in recs}
            by_id.update((r.id, r) for b in bufs for r in list(b.stack))
            recs = [r for r in recs if _inside(r, under, by_id)]
        out = {}
        for r in recs:
            t = out.setdefault(r.name, {"s": 0.0, "n": 0})
            t["s"] += (r.end_ns - r.start_ns) / 1e9
            t["n"] += 1
        return {"spans": out, "counters": self.counters()}


def _inside(rec, name, by_id):
    parent = by_id.get(rec.parent)
    while parent is not None:
        if parent.name == name:
            return True
        parent = by_id.get(parent.parent)
    return False


# the program's recorder
RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
current_span = RECORDER.current
adopt_span = RECORDER.adopt
reset = RECORDER.reset
totals = RECORDER.totals


def _union(intervals):
    """Sorted, merged (start, end) of ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _innermost(spans, t0, t1):
    """(start, end, name) pieces of [t0, t1]: the innermost of
    ``spans`` open over each, ``(none)`` where none is."""
    spans = [r for r in spans if r.end_ns > r.start_ns]
    events = sorted([(r.start_ns, 1, r.id, r) for r in spans]
                    + [(r.end_ns, 0, r.id, r) for r in spans],
                    key=lambda e: e[:3])
    pieces, open_, at = [], [], t0
    for t, kind, _, r in events + [(t1, 0, 0, None)]:
        t = min(max(t, t0), t1)
        if t > at:
            name = (max(open_, key=lambda s: (s.start_ns, s.id)).name
                    if open_ else "(none)")
            pieces.append((at, t, name))
            at = t
        if r is None:
            break
        if kind:
            open_.append(r)
        else:
            open_.remove(r)
    return pieces


def _overlap(xs, ys):
    """For each interval of the sorted lists ``ys``, the length of its
    overlap with the union ``xs``: [(overlap ns, y)]."""
    out, i = [], 0
    for y in ys:
        a, b = y[0], y[1]
        while i < len(xs) and xs[i][1] <= a:
            i += 1
        j, got = i, 0
        while j < len(xs) and xs[j][0] < b:
            got += min(b, xs[j][1]) - max(a, xs[j][0])
            j += 1
        out.append((got, y))
    return out


def idle_by_span(device_spans, spans, window=None):
    """The idle device time of ``window`` (ns pair; default the extent of
    the spans, else of the device spans) put down to the program's spans.

    ``device_spans``: (start_ns, end_ns, ...) of the device's work on the
    profiler's clock; ``spans``: :class:`SpanRecord`.  The main threads
    are those that hold an outer span (parent None); the other threads'
    spans are workers'.  Every interval in which no device span runs goes
    to the innermost main-thread span open over it, ``(none)`` where none
    is; ``idle_feed_worker_s`` is the idle time during which a worker's
    ``feed.*`` span was open."""
    spans = [r for r in spans if r.end_ns is not None]
    main = {r.thread for r in spans if r.parent is None}
    if window is None:
        ext = ([(r.start_ns, r.end_ns) for r in spans if r.thread in main]
               or [tuple(d[:2]) for d in device_spans])
        window = (min(a for a, _ in ext), max(b for _, b in ext)) \
            if ext else (0, 0)
    t0, t1 = window
    busy = [[max(a, t0), min(b, t1)] for a, b in
            _union(tuple(d[:2]) for d in device_spans) if b > t0 and a < t1]
    idle, at = [], t0
    for a, b in busy + [[t1, t1]]:
        if a > at:
            idle.append((at, a))
        at = max(at, b)
    by_span = {}
    pieces = _innermost([r for r in spans if r.thread in main], t0, t1)
    for got, (a, b, name) in _overlap(idle, pieces):
        if got:
            by_span[name] = by_span.get(name, 0) + got
    feed = _union((r.start_ns, r.end_ns) for r in spans
                  if r.thread not in main and r.name.startswith("feed."))
    idle_s = sum(b - a for a, b in idle) / 1e9
    feed_s = sum(got for got, _ in _overlap(feed, idle)) / 1e9
    return {"window_s": (t1 - t0) / 1e9,
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "idle_s": idle_s,
            "idle_by_span": {k: v / 1e9 for k, v in sorted(
                by_span.items(), key=lambda kv: -kv[1])},
            "idle_feed_worker_s": feed_s,
            "idle_feed_worker_share": feed_s / idle_s if idle_s else 0.0}


def trace_device_spans(prof):
    """A stopped ``torch.profiler`` profile's device spans, (start_ns,
    end_ns, name) sorted, from its raw events."""
    from torch.autograd import DeviceType

    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA)


def _add_thread_spans(path, spans, skip_thread):
    """Append to the Chrome trace at ``path`` the spans of the threads
    other than ``skip_thread``: the profiler records ``record_function``
    only on the thread that started it, so the feed workers' spans are
    written here, on the trace's clock."""
    spans = [r for r in spans if r.thread != skip_thread]
    if not spans:
        return
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": r.name, "pid": pid,
         "tid": r.thread, "ts": (r.start_ns - base) / 1e3,
         "dur": (r.end_ns - r.start_ns) / 1e3,
         "args": {"parent": r.parent, **r.attrs}} for r in spans)
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def profile_trace(logdir):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when there is a card) and write a Chrome trace,
    ``<logdir>/trace_<unix time>.json`` (open in chrome://tracing or
    Perfetto), with the program's spans in it (the feed workers' too),
    and beside it
    ``idle_by_span_<unix time>.json``: :func:`idle_by_span` over the
    block, and the spans' and counters' :func:`totals`.  Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    RECORDER.reset()
    prof.start()
    t0 = time.time_ns()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()    # the trace holds the queued work
        t1 = time.time_ns()
        prof.stop()
        stamp = int(time.time())
        path = os.path.join(logdir, f"trace_{stamp}.json")
        prof.export_chrome_trace(path)
        spans = RECORDER.spans()
        _add_thread_spans(path, spans, threading.get_native_id())
        out = idle_by_span(trace_device_spans(prof), spans, window=(t0, t1))
        out["totals"] = RECORDER.totals()
        with open(os.path.join(logdir, f"idle_by_span_{stamp}.json"),
                  "w") as f:
            json.dump(out, f, indent=1)
