"""Timers of the training decoder's kernels at encoder states wider than
the decoder (``k3_wide``, ``k4_wide``).

``probes.KernelTimers`` reads a K3 / K4 call's H from the encoder
states, which is the decoder's only where He == H.  These timers wrap
the same wrappers (``ops.fused_decoder.decoder_forward`` and
``decoder_backward``) the same way -- a CUDA event before and after the
call, the call's device time the span between them -- and read He from
the encoder states and H from the decoder's state, for
``yardstick.kernel_cost_wide``.
"""

import functools
import importlib

import torch

WIDE_WRAPPERS = {
    "k3_wide": ("ast_tpu_torch.ops.fused_decoder", "decoder_forward"),
    "k4_wide": ("ast_tpu_torch.ops.fused_decoder", "decoder_backward"),
}


def _dims(kernel, args):
    """(kernel_cost_wide key, its dims, K3's coins or None) of a call."""
    w = args[4] if kernel == "k4_wide" else args[3]
    if kernel == "k4_wide":
        ht, enc, c0 = args[1], args[2], args[3]
        U, (L, _, H) = ht.shape[0], c0.shape
    else:
        enc, h0, U = args[0], args[1], args[4].shape[0]
        L, _, H = h0.shape
    B, T, He = enc.shape
    d = dict(B=B, T=T, H=H, He=He, L=L, E=w["embed"].shape[1],
             A=w["ctx_w"].shape[1], V=w["embed"].shape[0], U=U,
             wbytes=2 if w["wh"].dtype == torch.bfloat16 else 4)
    if kernel == "k3_wide":
        return "k3", d, (args[5] == 0).sum()
    return "k4", d, None


def timed_wide(metric_names):
    """The kernels of WIDE_WRAPPERS whose ``<kernel>_roofline`` metric a
    run reports."""
    return [m[:-len("_roofline")] for m in metric_names
            if m[:-len("_roofline")] in WIDE_WRAPPERS]


class WideTimers:
    """Time the named kernels' calls while installed (a context)."""

    def __init__(self, kernels):
        self.calls = {k: [] for k in kernels}
        self._saved = []

    def _wrap(self, kernel, fn):
        @functools.wraps(fn)
        def timed(*args, **kw):
            enc = args[2] if kernel == "k4_wide" else args[0]
            if not enc.is_cuda:
                return fn(*args, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.calls[kernel].append(_dims(kernel, args) + (start, end))
            return out
        return timed

    def __enter__(self):
        for kernel in self.calls:
            mod_name, attr = WIDE_WRAPPERS[kernel]
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
        """{kernel: [(key, dims, device ms)]}, K3's dims completed with
        its sampled steps; call once the device is drained."""
        out = {}
        for kernel, calls in self.calls.items():
            rows = []
            for key, dims, coins, start, end in calls:
                dims = dict(dims)
                if coins is not None:
                    dims["n_logits"] = int(coins)
                rows.append((key, dims, start.elapsed_time(end)))
            out[kernel] = rows
        return out
