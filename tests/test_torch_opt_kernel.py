"""``Optimizer.apply_``, the training step's optimizer in place: on CPU
tensors the foreach chain of ``update`` and an in-place add, on CUDA
tensors the hand-written pass of ``kernels/csrc/opt_amsgrad.cu``
(``ops/fused_optimizer.py``) in two launches.

On the CPU: ``apply_`` equals ``update`` followed by the add, bit for
bit, for every link set; the state keeps its tree, its tensors and its
flat-NPZ keys; the noise link's step survives a save and a load while
its ``count`` is updated in place.  On the card (``-m chip``; run there
as ``python -m pytest tests/test_torch_opt_kernel.py -m chip
--noconftest``, this directory's conftest imports JAX): the kernel
against the foreach chain on the same tree -- bit for bit once the chain
is given the kernel's norm, the norm within 1e-5 of the chain's, end to
end the updates within 1e-6 of the largest |update| beside the add's
rounding (a few elements further under noise or bf16 moments, which
amplify the norm's last bit) -- the same steps whatever the parameters'
layout, two runs bit-equal, two launches a step and no foreach op, three
``NN.train_step``s within cell 1's limits of the benchmark, and a model
axis of two ranks sharing the card.
"""

import json
import os
import pickle
import re
import socket

import numpy as np
import pytest
import torch

from ast_tpu_torch.checkpoint import (
    flatten, load_checkpoint, save_checkpoint)
from ast_tpu_torch.ops.fused_optimizer import AmsgradKernel
from ast_tpu_torch.train.optimizer import (
    build_optimizer, tree_leaves, tree_unflatten)
from ast_tpu_torch.train.trainer import merge, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = {"type": 0, "lr": 1e-3, "l2": 1e-4, "grad_clip": 2}
CASES = {
    "amsgrad": BASE,                                    # es_en_20h's
    "freeze": dict(BASE, freeze=["cnn"]),
    "sgd": dict(BASE, type=1, lr=0.1),
    "noise": dict(BASE, grad_noise_eta=0.01),
    "bf16_moments": dict(BASE, moments_dtype="bfloat16"),
    "bare": {"type": 0, "lr": 1e-3},                    # no L2, no clip
    "all": dict(BASE, grad_noise_eta=0.01, moments_dtype="bfloat16",
                freeze=["cnn"]),
}
NOISE_CASES = ["noise", "all", "sgd_noise"]
CASES["sgd_noise"] = dict(BASE, type=1, lr=0.1, grad_noise_eta=0.3)
# gradient scales around the clip norm 2: above, below, above, ...
SCALES = (3.0, 0.05, 1.0, 5.0)
SEED = 2 ** 33 + 17


def _tree(rng, device="cpu", shapes=None):
    """A parameter tree of the model's names at a toy size (odd sizes:
    scalar tails), float32 on ``device``."""
    shapes = shapes or {"cnn": [{"w": (4, 1, 3, 2)}],
                        "enc": {"wx": (2, 7, 12)},
                        "dec": {"embed": (6, 3), "lstm": [{"b": (9,)}],
                                "out_w": (5, 6), "out_b": (6,)}}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        if isinstance(s, list):
            return [make(v) for v in s]
        return torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(device)
    return make(shapes)


def _grads(rng, params, scale):
    return [torch.from_numpy((rng.standard_normal(tuple(p.shape))
                              * scale).astype(np.float32)).to(p.device)
            for p in tree_leaves(params)]


def _clone(tree):
    return tree_unflatten(tree, [t.clone() for t in tree_leaves(tree)])


def _chain_step(opt, g, state, params):
    """The foreach chain's step: ``update``, the add; the new state."""
    updates, state = opt.update(g, state, params)
    torch._foreach_add_(tree_leaves(params), tree_leaves(updates))
    return state


def _assert_trees_equal(a, b, what):
    fa, fb = flatten(to_numpy(a)), flatten(to_numpy(b))
    assert sorted(fa) == sorted(fb), what
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, (what, k)
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# on the CPU: the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_on_cpu_is_update_and_add(case):
    cfg = CASES[case]
    rng = np.random.default_rng(0)
    params = _tree(rng)
    p_chain = _clone(params)
    opt, state = build_optimizer(cfg, params, seed=SEED)
    opt_c, state_c = build_optimizer(cfg, p_chain, seed=SEED)
    before = AmsgradKernel.updates
    for scale in SCALES:
        g = _grads(rng, params, scale)
        opt.apply_(g, state, params)
        state_c = _chain_step(opt_c, g, state_c, p_chain)
        _assert_trees_equal(params, p_chain, f"{case} params")
        _assert_trees_equal(state, state_c, f"{case} state")
    assert AmsgradKernel.updates == before         # no kernel on the CPU


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_keeps_the_state_tree_and_its_tensors(case):
    cfg = CASES[case]
    rng = np.random.default_rng(1)
    params = _tree(rng)
    opt, state = build_optimizer(cfg, params, seed=SEED)
    keys = {k: (v.dtype, v.shape) for k, v in flatten(to_numpy(state)).items()}
    ids = [id(t) for t in tree_leaves(state)]
    p_ids = [id(p) for p in tree_leaves(params)]
    for scale in SCALES[:2]:
        # a tree of gradients as well as their leaves
        g = tree_unflatten(params, _grads(rng, params, scale))
        opt.apply_(g, state, params)
    got = {k: (v.dtype, v.shape) for k, v in flatten(to_numpy(state)).items()}
    assert got == keys
    assert [id(t) for t in tree_leaves(state)] == ids
    assert [id(p) for p in tree_leaves(params)] == p_ids
    counts = [v for v in flatten(to_numpy(state)).values()
              if v.dtype == np.int32 and v.ndim == 0]
    assert len(counts) == (cfg["type"] == 0) + ("grad_noise_eta" in cfg)
    assert all(int(c) == 2 for c in counts)
    if cfg.get("freeze"):
        assert torch.equal(params["cnn"][0]["w"],
                           _tree(np.random.default_rng(1))["cnn"][0]["w"])


@pytest.mark.parametrize("case", NOISE_CASES)
def test_noise_step_survives_save_and_load(case, tmp_path):
    """Two steps, a checkpoint, a third step; and an optimizer built anew
    on the loaded state (``reset``) taking the same third step."""
    cfg = CASES[case]
    rng = np.random.default_rng(2)
    params = _tree(rng)
    opt, state = build_optimizer(cfg, params, seed=SEED)
    gs = [_grads(rng, params, s) for s in SCALES[:3]]
    for g in gs[:2]:
        opt.apply_(g, state, params)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, to_numpy(params), {}, to_numpy(state))
    loaded = load_checkpoint(path)
    opt.apply_(gs[2], state, params)

    params2 = merge(_tree(np.random.default_rng(99)), loaded["params"],
                    "params")
    opt2, state2 = build_optimizer(cfg, params2, seed=SEED)
    state2 = merge(state2, loaded["opt"], "opt")
    opt2.reset(state2)
    opt2.apply_(gs[2], state2, params2)
    _assert_trees_equal(params2, params, case)
    _assert_trees_equal(state2, state, case)
    # without the reset the loaded state would draw step 0's noise
    opt3, state3 = build_optimizer(cfg, params2, seed=SEED)
    assert opt3._noise_step == 0 and opt2._noise_step == 3


def test_kernel_refuses_cpu_tensors():
    params = _tree(np.random.default_rng(3))
    p = tree_leaves(params)
    with pytest.raises(ValueError, match="CUDA"):
        AmsgradKernel(p, None, None, None, [False] * len(p),
                      {"l2": 0, "clip": 0, "b1": 0.9, "one_minus_b1": 0.1,
                       "b1_mu": 0.9, "b2": 0.999, "one_minus_b2": 1e-3,
                       "eps": 1e-8, "neg_lr": -0.1}, False, False, False)


def _exports():
    """(source, entry point, its C parameter count) of every
    ``AST_EXPORT`` entry point of the kernel sources."""
    out = []
    csrc = os.path.join(REPO, "ast_tpu_torch", "kernels", "csrc")
    for name in sorted(os.listdir(csrc)):
        if name.endswith(".cu"):
            with open(os.path.join(csrc, name)) as f:
                src = f.read()
            for m in re.finditer(r"AST_EXPORT\s+int\s+(\w+)\s*\(([^)]*)\)",
                                 src):
                args = m.group(2).strip()
                out.append((name, m.group(1),
                            args.count(",") + 1 if args else 0))
    return out


@pytest.mark.parametrize("source,entry,n_args", _exports(),
                         ids=[e for _, e, _ in _exports()])
def test_every_entry_point_has_its_ctypes_signature(source, entry, n_args):
    from ast_tpu_torch.kernels import build

    assert entry in build._SIGNATURES, (source, entry)
    assert len(build._SIGNATURES[entry]) == n_args, (source, entry)


def test_constants_round_as_torch_rounds_the_chains_scalars():
    """The kernel's float32 constants (ctypes' rounding of the chain's
    Python numbers) against torch's float32 of each, and the structs'
    sizes against ``opt_amsgrad.cu``'s."""
    import ctypes

    from ast_tpu_torch.ops.fused_optimizer import (
        OptConsts, OptLeafArgs, chain_consts)
    from ast_tpu_torch.train.optimizer import B1, B2, EPS

    assert ctypes.sizeof(OptLeafArgs) == 6 * 8 + 8 + 2 * 4
    assert ctypes.sizeof(OptConsts) == 9 * 4
    for mu_bf16 in (False, True):
        k = OptConsts(**chain_consts(1e-4, 2, 1e-3, B1, B2, EPS, mu_bf16))
        f32 = lambda x: float(torch.tensor(x, dtype=torch.float32))
        assert (k.l2, k.clip, k.b1, k.b2, k.eps) == tuple(
            map(f32, (1e-4, 2, B1, B2, EPS)))
        assert k.one_minus_b1 == f32(1 - B1) and k.neg_lr == f32(-1e-3)
        assert k.one_minus_b2 == f32(1 - B2)
        assert k.b1_mu == (float(torch.tensor(B1).bfloat16()) if mu_bf16
                           else f32(B1))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _es_en_20h_tree(device):
    """es_en_20h's parameters (31 leaves, 12.33 M), seeded."""
    from ast_tpu_torch.models import seq2seq

    with open(os.path.join(REPO, "benchmark", "configs",
                           "es_en_20h.json")) as f:
        cfg = json.load(f)
    mcfg = cfg["model_cfg"]
    mcfg["rnn_config"]["dec_vocab_size"] = cfg["vocab_size"]
    params, _ = seq2seq.init_model(mcfg, seed=5, device=device)
    return params


def _many_leaves_tree(device):
    """60 leaves of odd sizes (two launch groups), some of them views at
    a 4-byte offset into one buffer (the kernel's scalar path)."""
    rng = np.random.default_rng(4)
    sizes = [int(s) for s in rng.integers(1, 5000, 60)]
    flat = torch.from_numpy(rng.standard_normal(sum(sizes) + 1).astype(
        np.float32)).to(device)
    out, off = {}, 1
    for i, n in enumerate(sizes):
        if i % 3 == 0:
            out[f"l{i:02d}"] = flat[off:off + n].clone()
        else:
            out[f"l{i:02d}"] = flat[off:off + n]
        off += n
    return {"enc": out, "dec": {"out_b": torch.from_numpy(
        rng.standard_normal(1098).astype(np.float32)).to(device)}}


TREES = {"es_en_20h": _es_en_20h_tree, "many_leaves": _many_leaves_tree}


def _given_norm(opt, kernel_opt):
    """Patch ``opt``'s chain to clip by the kernel's last norm."""
    opt._global_norm = lambda g: kernel_opt._kernel.norm.clone()


def _chain_norm(opt, g, params):
    """The foreach chain's global norm of g + l2 p."""
    on = opt.trainable
    g = [x for x, m in zip(g, on) if m]
    p = [x for x, m in zip(tree_leaves(params), on) if m]
    if opt.l2 > 0:
        g = torch._foreach_add(g, torch._foreach_mul(p, opt.l2))
    return float(opt._global_norm(g))


def _max_update(before, after):
    return max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(after), tree_leaves(before)))


@pytest.mark.chip
@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_chain_on_the_card(case, tree):
    dev = _card()
    cfg = CASES[case]
    rng = np.random.default_rng(5)
    params = TREES[tree](dev)
    # the chain given the kernel's norm; the chain as it is
    p_given, p_chain = _clone(params), _clone(params)
    opt, state = build_optimizer(cfg, params, seed=SEED)
    opt_g, state_g = build_optimizer(cfg, p_given, seed=SEED)
    opt_c, state_c = build_optimizer(cfg, p_chain, seed=SEED)
    _given_norm(opt_g, opt)
    # a gradient's norm about 2 x the scale: around the clip norm 2
    unit = 2.0 / sum(p.numel() for p in tree_leaves(params)) ** 0.5
    for step, scale in enumerate(SCALES):
        g = _grads(rng, params, scale * unit)
        before = _clone(params)
        opt.apply_(g, state, params)
        state_g = _chain_step(opt_g, g, state_g, p_given)
        state_c = _chain_step(opt_c, g, state_c, p_chain)
        _assert_trees_equal(params, p_given, f"{case} {tree} step {step}")
        _assert_trees_equal(state, state_g, f"{case} {tree} step {step}")
        # only the norm's order of summation differs from the chain's
        if cfg.get("grad_clip"):
            ref = _chain_norm(opt_c, g, before)
            assert abs(float(opt._kernel.norm) - ref) <= 1e-5 * ref, (
                case, tree, step, float(opt._kernel.norm), ref)
        # end to end, the updates within 1e-6 of the largest, beside the
        # add's own rounding (a parameter may land one step of its float32
        # spacing away, a step).  With gradient noise or a bf16 first
        # moment a few elements amplify the norm's last bit: where the
        # noise cancels the gradient (the sum's rounding is then a large
        # part of it), and where the f32 moment crosses a bf16 rounding
        # point (a bf16 step, 2^-8, of the moment).  There at most one
        # element in 10^4 may part further, and none by 1 % of the largest
        # update.
        u_max = _max_update(before, params)
        loose = cfg.get("grad_noise_eta") or cfg.get("moments_dtype")
        far = n = 0
        for a, b in zip(tree_leaves(params), tree_leaves(p_chain)):
            ulp = (torch.nextafter(b.abs(), torch.tensor(
                float("inf"), device=dev)) - b.abs())
            gap = (a - b).abs()
            far += int((gap > 1e-6 * u_max + (step + 1) * ulp).sum())
            n += gap.numel()
            assert float(gap.max()) <= 1e-2 * u_max, (case, tree, step)
        assert far <= (1e-4 * n if loose else 0), (case, tree, step, far, n)


@pytest.mark.chip
@pytest.mark.parametrize("case", ["amsgrad", "all"])
def test_layout_leaves_the_steps_unchanged(case):
    """``init_model``'s transposed recurrent weights against the same
    values laid out contiguous (as a loaded checkpoint's are): the same
    steps bit for bit, so a resumed run goes on as the whole run would;
    the parameters and moments contiguous after the first step."""
    dev = _card()
    cfg = CASES[case]
    runs = []
    for contiguous in (False, True):
        rng = np.random.default_rng(6)
        params = _es_en_20h_tree(dev)
        assert not all(p.is_contiguous() for p in tree_leaves(params))
        if contiguous:
            params = tree_unflatten(params, [p.contiguous() for p in
                                             tree_leaves(params)])
        opt, state = build_optimizer(cfg, params, seed=SEED)
        for scale in SCALES[:2]:
            opt.apply_(_grads(rng, params, 1e-3 * scale), state, params)
        assert all(t.is_contiguous() for t in
                   tree_leaves(params) + tree_leaves(state))
        runs.append((params, state))
    _assert_trees_equal(runs[0][0], runs[1][0], case)
    _assert_trees_equal(runs[0][1], runs[1][1], case)


@pytest.mark.chip
@pytest.mark.parametrize("case", ["amsgrad", "all"])
def test_kernel_repeats_bit_for_bit(case):
    dev = _card()
    cfg = CASES[case]
    runs = []
    for _ in range(2):
        rng = np.random.default_rng(6)
        params = _es_en_20h_tree(dev)
        opt, state = build_optimizer(cfg, params, seed=SEED)
        for scale in SCALES:
            opt.apply_(_grads(rng, params, scale), state, params)
        runs.append((params, state))
    _assert_trees_equal(runs[0][0], runs[1][0], case)
    _assert_trees_equal(runs[0][1], runs[1][1], case)


@pytest.mark.chip
@pytest.mark.parametrize("tree,case,launches", [
    ("es_en_20h", "amsgrad", 2), ("es_en_20h", "bare", 2),
    ("many_leaves", "amsgrad", 4), ("many_leaves", "bare", 3)])
def test_two_launches_and_no_foreach_op(tree, case, launches, monkeypatch):
    dev = _card()
    params = TREES[tree](dev)
    opt, state = build_optimizer(CASES[case], params, seed=SEED)
    g = _grads(np.random.default_rng(7), params, 1.0)
    opt.apply_(g, state, params)                # builds the table

    def refused(*a, **k):
        raise AssertionError("a foreach op ran on CUDA tensors")
    for name in dir(torch):
        if name.startswith("_foreach_"):
            monkeypatch.setattr(torch, name, refused)
    n0, u0 = AmsgradKernel.launches, AmsgradKernel.updates
    for _ in range(3):
        opt.apply_(g, state, params)
    assert AmsgradKernel.updates - u0 == 3
    assert AmsgradKernel.launches - n0 == 3 * launches
    with pytest.raises(ValueError):
        opt.apply_([x.double() for x in g], state, params)


def _train_experiment(root):
    import sys
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke.make_train_experiment(str(root))[0]


def _steps(nn, batches, seeds):
    """The benchmark's readings of ``nn``'s steps: utterances, losses,
    step 1's gradient as the first moment received it, the parameters."""
    from benchmark.core.weights import flat_leaves

    rec = {"utts": [], "losses": []}
    rec["p0"] = {k: v.detach().clone() for k, v in
                 flat_leaves(nn.params).items()}
    for i, (b, s) in enumerate(zip(batches, seeds)):
        rec["losses"].append(float(nn.train_step(b, s)))
        rec["utts"].append(list(b["utts"]))
        if i == 0:
            mu = nn.opt_state[-2][1]
            rec["g1"] = {k: v.detach().float() / (1 - 0.9) for k, v in
                         flat_leaves(mu).items()}
    rec["p"] = {k: v.detach().clone() for k, v in
                flat_leaves(nn.params).items()}
    return rec


@pytest.mark.chip
def test_three_train_steps_within_cell_limits(tmp_path):
    """``NN.train_step`` through the kernel against the same NN through
    the foreach chain: three steps, held to cell 1's limits of the
    benchmark by its own comparison."""
    _card()
    from ast_tpu_torch.train.optimizer import Optimizer
    from ast_tpu_torch.train.trainer import NN
    from benchmark.reference.train_check import compare

    exp = _train_experiment(tmp_path)
    batches = []
    with open(os.path.join(REPO, "benchmark", "workloads",
                           "es_en_20h.train_fisher20h.json")) as f:
        limits = json.load(f)["limits"]
    recs = {}
    for side in ("kernel", "chain"):
        nn = NN(exp, "cuda")
        if not batches:
            gen = nn.data_loader.get_batch(
                nn.cfg.train["batch_size"], nn.cfg.train["train_set"],
                train=True, labels=True, epoch=1)
            batches = [next(gen) for _ in range(3)]
        if side == "chain":
            def chain(self, grads, state, params):
                p = list(params)
                updates, new = self.update(list(grads), state, p)
                torch._foreach_add_(p, tree_leaves(updates))
                for old, t in zip(tree_leaves(state), tree_leaves(new)):
                    if t is not old:
                        old.copy_(t)
            nn.opt.apply_ = chain.__get__(nn.opt, Optimizer)
        n0, r0 = AmsgradKernel.updates, AmsgradKernel.relayouts
        recs[side] = _steps(nn, batches, [11, 12, 13])
        assert (AmsgradKernel.updates - n0) == (3 if side == "kernel" else 0)
        print(side, "gradient leaves copied contiguous a step:",
              (AmsgradKernel.relayouts - r0) / 3)
        del nn
    recs["kernel"]["p0"] = recs["chain"]["p0"]
    got = compare(recs["kernel"], recs["chain"])
    print(json.dumps(got))
    for k, limit in limits.items():
        assert got[k] <= limit, (k, got[k], limit)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.chip
@pytest.mark.parametrize("case", ["amsgrad", "all"])
def test_model_axis_on_one_card(case, tmp_path):
    """Two gloo ranks sharing the card at model axis 2 (``dec/out_w``,
    ``out_b`` and ``embed`` vocab shards): the kernel's whole parameters
    and state against one process's foreach chain on the whole tree, the
    replicated leaves bit-equal on both ranks."""
    import sys

    import torch.multiprocessing as mp

    # the module by its path: another installed package may own "tests"
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_ranks

    _card()
    out = str(tmp_path / "rec")
    jobs = [("opt_kernel_model_axis", (CASES[case], SEED, SCALES))]
    mp.spawn(torch_ranks.run_jobs, args=(2, _free_port(), jobs, out),
             nprocs=2, join=True)
    recs = []
    for r in range(2):
        with open(f"{out}.0.{r}", "rb") as f:
            recs.append(pickle.load(f))
    single = torch_ranks.opt_kernel_model_axis(None, CASES[case], SEED,
                                               SCALES)
    assert recs[0]["replicated"] == recs[1]["replicated"]
    assert recs[0]["kernel_updates"] == recs[1]["kernel_updates"] == len(
        SCALES)
    for part in ("params", "opt"):
        for r in range(2):
            got, want = recs[r][part], single[part]
            assert sorted(got) == sorted(want)
            for k in want:
                if want[k].dtype.kind in "iu":
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                    continue
                a, b = got[k].astype(np.float64), want[k].astype(np.float64)
                if part == "params":
                    # beside the add's rounding, a float32 step a step
                    tol = 1e-6 * single["max_update"] + len(SCALES) * (
                        np.spacing(np.abs(want[k])).astype(np.float64))
                elif CASES[case].get("moments_dtype") == "bfloat16":
                    # a bf16 first moment: one rounding step apart where
                    # the f32 value differs in its last bit
                    tol = 2.0 ** -7 * np.abs(b).max()
                else:
                    tol = 1e-5 * np.abs(b).max()
                assert (np.abs(a - b) <= tol).all(), (
                    part, k, r, float(np.abs(a - b).max()))
