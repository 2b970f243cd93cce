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
Decoding and training run at bf16 for the model the kernels take; a
scan-path variant is refused (``fused_infer.require_bf16_variant``).
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
    """``x`` rounded to bf16 (round to nearest even), back in f32."""
    return x.to(BF16).float()


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
