"""What the benchmark wraps around the program's calls, from outside.

- :class:`KernelTimers`: in a traced run, each kernel wrapper of the
  program (the Python function that issues one K1-K6 call) is replaced
  by one that records a CUDA event before and after it, and the call's
  shapes; the device time of a call is the span between its events,
  from the call's first launch to its last (its per-call weight packing
  included).
- :class:`Deadline`: ends a window at a call boundary: once the host
  clock passes the deadline, the next call synchronises the device,
  notes the time and raises :class:`StopWindow`.
"""

import contextlib
import functools
import time

import torch


class StopWindow(Exception):
    """The measured window is over."""


class Deadline:
    def __init__(self, device):
        self.device = device
        self.at = None
        self.t_end = None

    def check(self):
        """Raise StopWindow, with the device drained, once past ``at``."""
        if self.at is not None and time.perf_counter() >= self.at:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.t_end = time.perf_counter()
            raise StopWindow()


@contextlib.contextmanager
def instance_attr(obj, attr, value):
    """``obj.attr`` is ``value`` on the instance while installed, then
    the class's again."""
    setattr(obj, attr, value)
    try:
        yield
    finally:
        delattr(obj, attr)


# (module, attribute, kernel key) of each kernel wrapper the benchmark
# times; a module that another imported the function into by name is
# patched there too
KERNEL_WRAPPERS = {
    "k1_train": [("ast_tpu_torch.ops.fused_lstm", "fused_stacked_lstm_train")],
    "k2": [("ast_tpu_torch.ops.fused_lstm", "encoder_backward")],
    "k3": [("ast_tpu_torch.ops.fused_decoder", "decoder_forward")],
    "k4": [("ast_tpu_torch.ops.fused_decoder", "decoder_backward")],
    "k1_eval": [("ast_tpu_torch.ops.fused_lstm", "fused_stacked_lstm"),
                ("ast_tpu_torch.models.seq2seq", "fused_stacked_lstm")],
    "k5": [("ast_tpu_torch.ops.fused_infer", "greedy_decode_fused"),
           ("ast_tpu_torch.models.seq2seq", "greedy_decode_fused")],
    "k6": [("ast_tpu_torch.ops.fused_infer", "beam_search_streams")],
}


def _dims(kernel, args, out):
    """(kernel_cost key, its dims, a device tensor to read once the
    window is over or None) of one call."""
    bf16 = torch.bfloat16
    if kernel in ("k1_train", "k1_eval"):
        x0, wh = args[0], args[2]
        T, D2, B, H4 = x0.shape
        d = dict(B=B, H=H4 // 4, L=wh.shape[0], T=T, D2=D2,
                 wbytes=2 if wh.dtype == bf16 else 4)
        return ("k1t" if kernel == "k1_train" else "k1"), d, None
    if kernel == "k2":
        acts, wh = args[0], args[3]
        T, L, D2, B, H4 = acts.shape
        return "k2", dict(B=B, H=H4 // 4, L=L, T=T, D2=D2,
                          wbytes=2 if wh.dtype == bf16 else 4), None
    if kernel in ("k3", "k4", "k5", "k6"):
        if kernel == "k4":
            ht, enc, c0, w = args[1], args[2], args[3], args[4]
            U, L = ht.shape[0], c0.shape[0]
        else:
            enc, h0, w = args[0], args[1], args[3]
            L = h0.shape[0]
        B, T, H = enc.shape
        d = dict(B=B, T=T, H=H, L=L, E=w["embed"].shape[1],
                 A=w["ctx_w"].shape[1], V=w["embed"].shape[0],
                 wbytes=2 if w["wh"].dtype == bf16 else 4)
        if kernel == "k3":
            d["U"] = args[4].shape[0]
            return "k3", d, (args[5] == 0).sum()
        if kernel == "k4":
            d["U"] = U
            return "k4", d, None
        if kernel == "k5":
            stop = args[4]
            d["stop"] = stop
            eos = out == 2
            rows = torch.where(eos.any(dim=1), eos.int().argmax(dim=1) + 1,
                               stop)
            return "k5", d, rows.max()
        d.update(N=args[4], stop=args[6])
        valid = out[2]
        return "k6", d, (valid.reshape(valid.shape[0], -1).amax(1)
                         > 0).sum()
    raise KeyError(kernel)


def timed_kernels(metric_names):
    """The kernels whose ``<kernel>_roofline`` metric a run reports."""
    return [m[:-len("_roofline")] for m in metric_names
            if m.endswith("_roofline") and m[:-len("_roofline")]
            in KERNEL_WRAPPERS]


class KernelTimers:
    """Time the named kernels' calls while installed (a context)."""

    def __init__(self, kernels):
        self.kernels = list(kernels)
        self.calls = {k: [] for k in self.kernels}
        self._saved = []

    def _wrap(self, kernel, fn):
        @functools.wraps(fn)
        def timed(*args, **kw):
            first = next(a for a in args if torch.is_tensor(a))
            if not first.is_cuda:
                return fn(*args, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            key, dims, later = _dims(kernel, args, out)
            self.calls[kernel].append((key, dims, later, start, end))
            return out
        return timed

    def __enter__(self):
        import importlib
        for kernel in self.kernels:
            for mod_name, attr in KERNEL_WRAPPERS[kernel]:
                mod = importlib.import_module(mod_name)
                fn = getattr(mod, attr)
                self._saved.append((mod, attr, fn))
                setattr(mod, attr, self._wrap(kernel, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved = []
        return False

    def results(self):
        """{kernel: [(kernel_cost key, dims, device ms)]} of the calls,
        the dims completed with what the device held (K3's sampled steps,
        K6's steps run); call once the device is drained."""
        out = {}
        for kernel, calls in self.calls.items():
            rows = []
            for key, dims, later, start, end in calls:
                dims = dict(dims)
                if key == "k3":
                    dims["n_logits"] = int(later)
                elif key in ("k5", "k6"):
                    dims["n"] = int(later)
                rows.append((key, dims, start.elapsed_time(end)))
            out[kernel] = rows
        return out
