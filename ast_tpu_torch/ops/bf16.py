"""bfloat16 compute (``extras.compute_dtype: "bfloat16"``): ``ast_tpu``'s
rounding points, as the plain versions and the GEMMs outside the kernels
run them.

``ast_tpu`` multiplies in the weight's dtype and accumulates in f32: its
``_dot`` casts the left operand to the weight's dtype, then
``preferred_element_type=float32``.  A ``torch.matmul`` of two bf16
tensors returns a bf16 result, which is not that function; here both
operands are rounded to bf16 and multiplied in f32 (a product of two
bf16 values is exact in f32, so only the order of the sum differs).
Under autograd :func:`rounded` also rounds the gradient that reaches
its input to bf16 (the cast's backward), as XLA's transpose of a bf16
product converts each operand's cotangent to the operand's dtype.

Two sets of rounding points, as in ``ast_tpu``: the kernel path's
(K1-K6's bf16 modes and their plain versions, where the weights are
cast once and :func:`dot` rounds the left operand) and the scan path's
(``models.seq2seq``'s plain stages: the scan encoder, ``linear_proj``,
``decode_step``, attention), where the weights stay f32 and each bf16
product rounds both of its operands where it reads them
(:func:`scan_dot`) -- and ``h @ wh`` is not rounded at all.  Every model
variant decodes and trains at bf16, each stage at its route's points.
"""

import torch

BF16 = torch.bfloat16
_NAMES = {"float32": torch.float32, "bfloat16": BF16}


def parse_dtype(name):
    """``"float32"`` / ``"bfloat16"`` (a config's or a manifest's
    ``compute_dtype``; None is float32) -> the torch dtype."""
    if name is None:
        return torch.float32
    if name not in _NAMES:
        raise ValueError(f"compute_dtype {name!r}: float32 | bfloat16")
    return _NAMES[name]


def rounded(x):
    """``x`` rounded to bf16 (round to nearest even), back in its own
    dtype: f32, or f64 where a float64 run takes the bf16 function's
    sums exactly."""
    return x.to(BF16).to(x.dtype)


def widen(x):
    """A bf16 tensor in f32, any other as it is."""
    return x.float() if x.dtype == BF16 else x


def dot(a, w):
    """``a @ w`` as ``ast_tpu``'s ``_dot``: with ``w`` in bf16, ``a``
    rounded to bf16 and the product taken in f32; else the plain
    product."""
    if w.dtype == BF16:
        return rounded(a) @ w.float()
    return a @ w


def scan_dot(a, w, dtype):
    """``a @ w`` at ``dtype`` on the scan path (``ast_tpu``'s
    ``jnp.dot(a.astype(cd), w.astype(cd), preferred_element_type=f32)``):
    at bf16 both operands rounded and the product taken in their own
    dtype; else the plain product."""
    if dtype == BF16:
        return rounded(a) @ rounded(w)
    return a @ w
