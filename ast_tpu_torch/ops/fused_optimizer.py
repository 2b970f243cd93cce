"""The training step's optimizer on the card, in two launches of one
hand-written CUDA pass (``kernels/csrc/opt_amsgrad.cu``).

:class:`AmsgradKernel` holds the leaf table of one optimizer's trainable
leaves -- the pointers of p, mu, nu and nu_max, which stay put because
the kernel updates them in place, and each leaf's size -- and its device
buffers: the partial sums of squares, one a block and class (replicated
leaves, vocab shards), and the norm the update used.  A call fills in the
step's gradient (and noise) pointers and launches:

1. ``opt_amsgrad_norm``: the squares of g + l2 p by block, and the
   AMSGrad and noise counts advanced in place;
2. ``opt_amsgrad_update``: the global norm from the partials in a fixed
   order (or from ``combine``, the host's sum over a model group), then
   clip, noise, AMSGrad (or SGD) and the parameter update, every state
   tensor written in place.

Under ``train/optimizer.py``'s chain, given the same norm, each element
comes out bit for bit as the foreach chain's.  The kernel walks each
leaf's storage, and the norm's sum follows that order, so every operand
is contiguous: the same order whatever layout a run's tensors came in
with (``init_model``'s recurrent weights are transposed views, a loaded
checkpoint's are not, and a resumed run must sum as the whole run did).
When the table is built, a parameter or state tensor laid out otherwise
is made contiguous in place (the same tensor object, its values
unchanged); a step's gradient or noise leaf laid out otherwise is copied
contiguous first.  It takes float32 CUDA parameters and gradients,
float32 ``nu`` and ``nu_max`` and ``mu`` in float32 or bfloat16; anything
else raises.
"""

import ctypes

import torch

from ast_tpu_torch.kernels import build
from ast_tpu_torch.utils import profiling

# opt_amsgrad.cu's flags
F_L2, F_CLIP, F_NOISE = 1, 2, 4
MODE_SHIFT = 3
SGD, ADAM, ADAM_MU_BF16 = 0, 1, 2


class OptLeafArgs(ctypes.Structure):
    """One trainable leaf (``opt_amsgrad.cu``'s ``OptLeafArgs``)."""
    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("mu", ctypes.c_void_p), ("nu", ctypes.c_void_p),
                ("nu_max", ctypes.c_void_p), ("noise", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("sharded", ctypes.c_int),
                ("pad_", ctypes.c_int)]


class OptConsts(ctypes.Structure):
    """The chain's float32 constants (``opt_amsgrad.cu``'s ``OptConsts``);
    ctypes rounds each double to float32 as torch rounds a Python scalar
    for a float32 operation."""
    _fields_ = [(k, ctypes.c_float) for k in (
        "l2", "clip", "b1", "one_minus_b1", "b1_mu", "b2", "one_minus_b2",
        "eps", "neg_lr")]


def _check(t, name, dtypes=(torch.float32,)):
    """Raise unless ``t`` is a CUDA tensor of one of ``dtypes``."""
    if not t.is_cuda or t.dtype not in dtypes:
        raise ValueError(f"{name}: the optimizer kernel takes "
                         f"{' or '.join(map(str, dtypes))} CUDA tensors "
                         f"(got {t.dtype} on {t.device})")


class AmsgradKernel:
    """The kernel over one set of trainable leaves ``p`` and their state:
    ``moments`` (mu, nu, nu_max leaf lists, None under SGD) and the int32
    ``count`` / ``noise_count`` scalars it advances (either may be None);
    ``sharded`` a bool a leaf (a vocab shard); ``consts`` the chain's
    constants (a dict of OptConsts' fields); ``l2``, ``clip`` and
    ``noise`` the links the chain has."""

    def __init__(self, p, moments, count, noise_count, sharded, consts,
                 l2, clip, noise):
        for i, x in enumerate(p):
            _check(x, f"param {i}")
        mode = SGD
        if moments is not None:
            mu, nu, nu_max = moments
            for i, (m, v, w, x) in enumerate(zip(mu, nu, nu_max, p)):
                _check(m, f"mu {i}", (torch.float32, torch.bfloat16))
                _check(v, f"nu {i}")
                _check(w, f"nu_max {i}")
                if not m.shape == v.shape == w.shape == x.shape:
                    raise ValueError(f"moments {i}: the shape of param {i} "
                                     f"{tuple(x.shape)}")
            mode = ADAM_MU_BF16 if mu[0].dtype == torch.bfloat16 else ADAM
            if any(m.dtype != mu[0].dtype for m in mu):
                raise ValueError("mu: one dtype for every leaf")
        for name, c in (("count", count), ("noise count", noise_count)):
            if c is not None and (not c.is_cuda or c.dtype != torch.int32):
                raise ValueError(f"{name}: an int32 CUDA scalar")
        state = [] if moments is None else [t for ts in moments for t in ts]
        for t in list(p) + state:
            if not t.is_contiguous():
                t.data = t.data.contiguous()
        self.p = list(p)
        self.tensors = self.p + state + [c for c in (count, noise_count)
                                         if c is not None]
        self.ptrs = [t.data_ptr() for t in self.tensors]
        self.device = p[0].device
        self.flags = ((F_L2 if l2 else 0) | (F_CLIP if clip else 0)
                      | (F_NOISE if noise else 0) | (mode << MODE_SHIFT))
        n = len(p)
        self.table = (OptLeafArgs * n)()
        for i, x in enumerate(p):
            rec = self.table[i]
            rec.p, rec.n, rec.sharded = x.data_ptr(), x.numel(), sharded[i]
            if moments is not None:
                rec.mu, rec.nu, rec.nu_max = (
                    t[i].data_ptr() for t in moments)
        self.consts = OptConsts(**consts)
        self.l2 = float(consts["l2"])
        self.count = count
        self.noise_count = noise_count
        lib = build.library()
        blocks = lib.opt_partials(n)
        # launch groups (the leaves one launch's parameters hold)
        self.groups = blocks // lib.opt_partials(1)
        self.partials = torch.zeros((2, blocks), device=self.device)
        # the norm launch 2 used (with a clip link)
        self.norm = torch.zeros((), device=self.device)

    def stale(self, p):
        """Whether ``p`` or the state are not the tensors the table was
        built over (other tensors, or storage moved)."""
        return ([x.data_ptr() for x in p]
                + [t.data_ptr() for t in self.tensors[len(self.p):]]
                != self.ptrs)

    def __call__(self, g, noise=None, sigma=0.0, combine=None):
        """One step from the trainable leaves' gradients ``g`` (and with
        a noise link the step's ``noise`` leaves and ``sigma``).
        ``combine(partials) -> norm`` (a device scalar), where given,
        makes the global norm from launch 1's partials (a model axis);
        else launch 2 reduces them itself.  Counts its CUDA launches in
        ``AmsgradKernel.launches``, its steps in ``.updates`` and its
        copies of a step's leaf into a contiguous one in ``.relayouts``,
        and while
        spans are armed the counter ``train.opt_kernel_updates``."""
        table = self.table
        if len(g) != len(table):
            raise ValueError(f"{len(g)} gradients for {len(table)} leaves")
        g = self._operands(g, "grad")
        for rec, x in zip(table, g):
            rec.g = x.data_ptr()
        if self.flags & F_NOISE:
            noise = self._operands(noise, "noise")
            for rec, z in zip(table, noise):
                rec.noise = z.data_ptr()
        lib = build.library()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        partials = self.partials.data_ptr()
        cnt = None if self.count is None else self.count.data_ptr()
        AmsgradKernel.launches += self.groups if self.flags & F_CLIP else 1
        build.check_launch("opt_amsgrad_norm", lib.opt_amsgrad_norm(
            table, len(table), self.l2, self.flags, partials, cnt,
            None if self.noise_count is None
            else self.noise_count.data_ptr(), stream))
        norm = None
        if combine is not None and self.flags & F_CLIP:
            norm = combine(self.partials)
        AmsgradKernel.launches += self.groups
        AmsgradKernel.updates += 1
        build.check_launch("opt_amsgrad_update", lib.opt_amsgrad_update(
            table, len(table), ctypes.byref(self.consts), sigma, self.flags,
            partials, None if norm is None else norm.data_ptr(),
            self.norm.data_ptr(), cnt, stream))
        profiling.count("train.opt_kernel_updates", 1)

    def _operands(self, xs, name):
        """A step's leaves (gradients, noise) checked, and contiguous."""
        out = []
        for i, (x, p) in enumerate(zip(xs, self.p)):
            if (not x.is_cuda or x.dtype != torch.float32
                    or x.shape != p.shape):
                raise ValueError(f"{name} {i}: the optimizer kernel takes "
                                 f"a float32 CUDA tensor of shape "
                                 f"{tuple(p.shape)} (got {x.dtype}, "
                                 f"{tuple(x.shape)} on {x.device})")
            if not x.is_contiguous():
                AmsgradKernel.relayouts += 1
                x = x.contiguous()
            out.append(x)
        return out


AmsgradKernel.launches = 0
AmsgradKernel.updates = 0
# step leaves (gradients, noise) copied contiguous
AmsgradKernel.relayouts = 0


def chain_consts(l2, clip, lr, b1, b2, eps, mu_bf16):
    """The kernel's constants from the chain's Python numbers, as its
    foreach ops take them: ``1 - b1``, ``1 - b2`` and ``-lr`` in double
    first; at bf16 moments the decay of mu rounded to bf16."""
    b1_mu = float(torch.tensor(b1).bfloat16()) if mu_bf16 else b1
    return {"l2": l2, "clip": clip, "b1": b1, "one_minus_b1": 1 - b1,
            "b1_mu": b1_mu, "b2": b2, "one_minus_b2": 1 - b2, "eps": eps,
            "neg_lr": -lr}
