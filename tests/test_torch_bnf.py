"""The port's nnet2 bottleneck-feature net (ast_tpu_torch.ops.bnf) against
ast_tpu's, on the CPU: the parser reads the same components, and
``nnet2_forward``, ``add_deltas``, ``splice_frames`` and
``apply_transform`` agree within 1e-5 on tests/test_bnf.py's net, on a
seeded wider one shaped as a Kaldi BNF net (splice +-4, an LDA-like
fixed affine, p-norm hidden layers, a 42-dim bottleneck) and on every
other component the parser takes; ``prep_data bnf`` writes the same
files for each feature type.
"""

import os

import numpy as np
import pytest
import torch

from ast_tpu.cli import prep_data as jax_prep
from ast_tpu.ops import bnf as jax_bnf
from ast_tpu_torch.cli import prep_data
from ast_tpu_torch.ops import bnf
from chip_smoke import nnet2_bnf_text
from tests.test_torch_recipe import run_cli

TOL = 1e-5


def _matrix_text(m):
    return "[\n" + "\n".join(
        "  " + " ".join(f"{v:.9e}" for v in row) for row in m) + " ]"


def _vector_text(v):
    return "[ " + " ".join(f"{x:.9e}" for x in v) + " ]"


def small_net(rng):
    """tests/test_bnf.py's net: Splice -> Affine -> Pnorm -> Normalize ->
    FixedAffine."""
    W1, b1 = rng.randn(8, 9), rng.randn(8)
    W2, b2 = rng.randn(2, 4), rng.randn(2)
    return f"""<Nnet> <NumComponents> 5 <Components>
<SpliceComponent> <InputDim> 3 <Context> [ -1 0 1 ]
<ConstComponentDim> 0 </SpliceComponent>
<AffineComponentPreconditioned> <LearningRate> 0.001 <Alpha> 4.0
<MaxChange> 10 <LinearParams> {_matrix_text(W1)}
<BiasParams> {_vector_text(b1)} </AffineComponentPreconditioned>
<PnormComponent> <InputDim> 8 <OutputDim> 4 <P> 2
</PnormComponent>
<NormalizeComponent> <Dim> 4 <ValueAvg> [ ] <DerivAvg> [ ]
<Count> 0 </NormalizeComponent>
<FixedAffineComponent> <LinearParams> {_matrix_text(W2)}
<BiasParams> {_vector_text(b2)} </FixedAffineComponent>
</Components> </Nnet>""", 3


def bnf_net(rng, **kw):
    """chip_smoke's Kaldi-BNF-shaped net (splice +-4, a fixed affine,
    p-norm layers, a 42-dim bottleneck) at narrower widths."""
    kw.setdefault("hidden", (200, 200))
    return nnet2_bnf_text(np.random.default_rng(rng.randint(1 << 30)),
                          **kw), kw.get("d_in", 13)


def other_components_net(rng):
    return """<Nnet> <NumComponents> 7 <Components>
<SigmoidComponent> <Dim> 6 </SigmoidComponent>
<TanhComponent> <Dim> 6 </TanhComponent>
<FixedScaleComponent> <Scales> [ 2.0 3.0 -1 0.5 1 1 ] </FixedScaleComponent>
<FixedBiasComponent> <Bias> [ -1.0 1.0 0 0 2 -2 ] </FixedBiasComponent>
<RectifiedLinearComponent> <Dim> 6 </RectifiedLinearComponent>
<PnormComponent> <InputDim> 6 <OutputDim> 3 <P> 3 </PnormComponent>
<SoftmaxComponent> <Dim> 3 </SoftmaxComponent>
</Components> </Nnet>""", 6


NETS = {"test_bnf": small_net, "bnf_shaped": bnf_net,
        "other_components": other_components_net}


def _same_components(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k, v in b.items():
            if isinstance(v, np.ndarray):
                assert a[k].dtype == v.dtype
                np.testing.assert_array_equal(a[k], v)
            else:
                assert a[k] == v


@pytest.mark.parametrize("name", sorted(NETS))
def test_nnet2_forward_matches(name):
    rng = np.random.RandomState(0)
    text, d_in = NETS[name](rng)
    comps, ref = bnf.parse_nnet2_text(text), jax_bnf.parse_nnet2_text(text)
    _same_components(comps, ref)
    for T in (1, 5, 37):
        x = rng.randn(T, d_in).astype(np.float32)
        want = np.asarray(jax_bnf.nnet2_forward(ref, x))
        got = bnf.nnet2_forward(comps, x)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
        moved = bnf.nnet2_forward(bnf.net_to(comps, "cpu"),
                                  torch.from_numpy(x))
        np.testing.assert_array_equal(moved.numpy(), got.numpy())


def test_splice_const_component_dim():
    comps = [{"type": "SpliceComponent", "context": [-1, 0],
              "ConstComponentDim": 1}]
    x = np.asarray([[1., 10.], [2., 20.], [3., 30.]], np.float32)
    np.testing.assert_array_equal(
        bnf.nnet2_forward(comps, x).numpy(),
        np.asarray(jax_bnf.nnet2_forward(comps, x)))


@pytest.mark.parametrize("order,window", [(2, 2), (1, 2), (3, 1)])
def test_add_deltas_matches(order, window):
    x = np.random.RandomState(2).randn(12, 13).astype(np.float32)
    np.testing.assert_allclose(
        bnf.add_deltas(x, order, window).numpy(),
        np.asarray(jax_bnf.add_deltas(x, order, window)), rtol=TOL,
        atol=TOL)


def test_splice_and_transform_match():
    rng = np.random.RandomState(3)
    x = rng.randn(9, 13).astype(np.float32)
    for left, right in ((4, 4), (1, 2), (0, 0)):
        sp, ref = (bnf.splice_frames(x, left, right).numpy(),
                   np.asarray(jax_bnf.splice_frames(x, left, right)))
        np.testing.assert_array_equal(sp, ref)
    sp = ref
    for cols in (sp.shape[1], sp.shape[1] + 1):
        mat = rng.randn(40, cols)
        np.testing.assert_allclose(
            bnf.apply_transform(sp, mat).numpy(),
            np.asarray(jax_bnf.apply_transform(sp, mat)), rtol=TOL,
            atol=TOL)


def test_parser_errors_match():
    for text in ("<Nnet> <Components> <AffineComponent> <LinearParams> "
                 "[ 1 2 ] </AffineComponent> </Components> </Nnet>",
                 "<Nnet> <Components> <SpliceComponent>", "<Foo>"):
        with pytest.raises(ValueError) as a:
            jax_bnf.parse_nnet2_text(text)
        with pytest.raises(ValueError) as b:
            bnf.parse_nnet2_text(text)
        assert str(a.value) == str(b.value)
    comps = [{"type": "WeirdComponent"}]
    with pytest.raises(ValueError, match="unsupported nnet2 component"):
        bnf.nnet2_forward(comps, np.zeros((2, 2), np.float32))


@pytest.mark.parametrize("feat_type", ["raw", "delta", "lda"])
def test_prep_data_bnf_cli_matches(tmp_path, feat_type):
    rng = np.random.RandomState(4)
    d_in = {"raw": 13, "delta": 39, "lda": 40}[feat_type]
    text, _ = bnf_net(rng, d_in=d_in, splice=2, hidden=(60,))
    model = tmp_path / "final.txt"
    model.write_text(text)
    feats = tmp_path / "feats"
    feats.mkdir()
    for i in range(3):
        np.save(feats / f"utt{i}.npy", rng.randn(7 + i, 13).astype(
            np.float32))
    extra = []
    if feat_type == "lda":
        np.savetxt(tmp_path / "final.mat", rng.randn(40, 13 * 3 + 1))
        extra = ["--lda-mat", str(tmp_path / "final.mat"), "--splice", "1"]
    outs = []
    for name, main, dev in (("j", jax_prep.main, []),
                            ("p", prep_data.main, ["--device", "cpu"])):
        out = str(tmp_path / name)
        code, msg = run_cli(main, ["bnf", str(feats), out, "--model",
                                   str(model), "--feat-type", feat_type]
                            + extra + dev)
        assert code is None
        outs.append((out, msg.replace(out, "<out>")))
    (a, ma), (b, mb) = outs
    assert ma == mb
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        x, y = np.load(os.path.join(a, f)), np.load(os.path.join(b, f))
        assert x.shape == y.shape == (int(f[3]) + 7, 42)
        assert y.dtype == np.float32
        np.testing.assert_allclose(y, x, rtol=TOL, atol=TOL)
