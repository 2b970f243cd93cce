"""The precision a reference product runs at.

Every matrix product of the plain reference goes through :func:`mm`,
which rounds both operands to the mode's format and then
multiplies in float32 (TF32 off), so that the reference can stand in for
the program at a lower precision than the configuration states (the
benchmark's control):

- ``"f32"``: the operands as they are;
- ``"tf32"``: rounded to TF32's 10 mantissa bits (nearest, ties to
  even), as the tensor cores read float32 operands with TF32 on;
- ``"bf16"``: rounded to bfloat16;
- ``"fp8"``: the FP8 training recipe (Micikevicius et al., "FP8 Formats
  for Deep Learning", arXiv:2209.05433): each operand scaled per tensor
  so that its largest magnitude is e4m3's 448, rounded to float8 e4m3 and
  scaled back; in the backward the incoming gradient likewise in e5m2
  (largest 57344).

The rounding is done bit by bit here, so a control reads the same on
the CPU as on the card.
"""

import torch

MODES = ("f32", "tf32", "bf16", "fp8")
# (format, largest finite value) of the FP8 operands and gradients
FP8 = {"fwd": (torch.float8_e4m3fn, 448.0), "grad": (torch.float8_e5m2,
                                                     57344.0)}


def _round_mantissa(x, bits):
    """``x`` (float32) rounded to ``bits`` mantissa bits, ties to even."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    lsb = (i >> drop) & 1
    i = (i + ((1 << (drop - 1)) - 1) + lsb) & ~((1 << drop) - 1)
    return i.view(torch.float32)


def _fp8(x, which):
    fmt, top = FP8[which]
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(fmt).float() * scale


def rnd(x, mode, grad=False):
    """``x`` rounded to ``mode``'s format, back in float32; ``grad``: a
    gradient in the backward (fp8: e5m2)."""
    if mode == "f32":
        return x
    if mode == "tf32":
        return _round_mantissa(x, 10)
    if mode == "bf16":
        return x.to(torch.bfloat16).float()
    if mode == "fp8":
        return _fp8(x, "grad" if grad else "fwd")
    raise ValueError(f"precision mode {mode!r}: one of {MODES}")


class _Rounded(torch.autograd.Function):
    """``torch.matmul`` of rounded operands whose backward products also
    read the incoming gradient rounded: a whole step at ``mode``."""

    @staticmethod
    def forward(ctx, a, b, mode):
        ra, rb = rnd(a, mode), rnd(b, mode)
        ctx.save_for_backward(ra, rb)
        ctx.mode = mode
        return torch.matmul(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        g = rnd(g.contiguous(), ctx.mode, grad=True)
        return (torch.matmul(g, rb.transpose(-1, -2)),
                torch.matmul(ra.transpose(-1, -2), g), None)


def mm(a, b, mode="f32"):
    """``a @ b`` at ``mode``: ``a`` (M, K) or (n, M, K), ``b`` of the
    same rank."""
    if mode == "f32":
        return torch.matmul(a, b)
    return _Rounded.apply(a, b, mode)


class exact_float32:
    """Context in which float32 products on the card run in float32
    (TF32 off for cuBLAS and cuDNN), restored on exit."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False
