"""The plain reference's pieces against the program's, on the CPU: the
reference is written from the model's definitions and imports nothing
of the program; these tests hold it to the program where both exist."""

import torch

from benchmark.reference import precision


def test_precision_modes_round_as_stated():
    x = torch.randn(1000) * 10
    assert torch.equal(precision.rnd(x, "f32"), x)
    bf = precision.rnd(x, "bf16")
    assert torch.equal(bf, x.bfloat16().float())
    tf = precision.rnd(x, "tf32")
    # 10 mantissa bits: exact for bf16 values, within 2^-11 relative
    assert torch.equal(precision.rnd(bf, "tf32"), bf)
    assert ((tf - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert ((tf - x).abs() > 0).any()
    f8 = precision.rnd(x, "fp8")
    assert ((f8 - x).abs() <= x.abs().amax() / 448 * 2.0 ** -9 +
            x.abs() * 2.0 ** -4).all()
