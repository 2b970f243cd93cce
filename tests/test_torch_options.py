"""The training options that live outside the kernels, ast_tpu_torch
against ast_tpu, each fed the same random numbers: label smoothing and
target corruption in the loss, SpecAugment, weight noise, gradient noise
and the bfloat16 first moment.

Tolerances: the loss 1e-5 relative, the loss head's gradients (out_w,
out_b: no kernel between them and the loss) 1e-5 absolute, every other
gradient as tests/test_torch_train.py (rtol 2e-3 / atol 2e-4, the
decoder's backward sums in another order); SpecAugment bit-equal; weight
noise 1e-6; the bfloat16 moment bit-equal, updates 1e-6; measured noise
levels within 2 % of the schedule (2e5 samples: 0.5 % at 3 sigma).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ast_tpu.models import seq2seq as jax_seq2seq
from ast_tpu.ops import specaugment as jax_sa
from ast_tpu.train import checkpoint as jax_ckpt
from ast_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from ast_tpu.train.trainer import NN as JaxNN
from ast_tpu_torch.checkpoint import flatten
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.ops import specaugment as sa
from ast_tpu_torch.params import from_jax_numpy, tree_map
from ast_tpu_torch.symbols import SYMBOLS
from ast_tpu_torch.train.optimizer import (
    build_optimizer, noise_sigma, tree_leaves)
from ast_tpu_torch.train.trainer import NN, merge, to_numpy
from tests.conftest import TINY_MODEL_CFG, make_tiny_experiment

V = 12
DEC_GRAD = dict(rtol=2e-3, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _mcfg():
    m = jax.tree.map(lambda x: x, TINY_MODEL_CFG)
    m["rnn_config"] = dict(m["rnn_config"], dec_vocab_size=V,
                           fused_encoder=True, fused_decoder=True,
                           fused_interpret=True)
    m["dropout"] = {"embed": 0.3, "rnn": 0.3, "out": 0}
    return m


# ---------------------------------------------------------------------------
# label smoothing and random_out
# ---------------------------------------------------------------------------

def _jax_draws(key, X_shape, y, teach_ratio, add_noise, random_out):
    """The port's Draws from JAX's key, repeating the splits of
    ast_tpu's forward_loss, encode and _fused_decoder_loss."""
    steps = y.shape[1] - 1
    key, ekey = jax.random.split(key)
    enc_key, nkey = jax.random.split(ekey)
    noise = np.asarray(add_noise * jax.random.normal(nkey, X_shape))
    enc_seed = int(jax.random.randint(enc_key, (), 0, 2 ** 31 - 1, jnp.int32))
    k_coin, k_seed, k_rand1, k_rand2 = jax.random.split(key, 4)
    idx = jnp.arange(steps)
    coins = ((idx == 0) | (idx >= steps - 1)
             | jax.random.bernoulli(k_coin, teach_ratio, (steps,)))
    dec_seed = int(jax.random.randint(k_seed, (), 0, 2 ** 31 - 1, jnp.int32))
    draws = seq2seq.Draws(_t(noise), enc_seed, dec_seed,
                          _t(np.asarray(coins, np.int32)))
    if random_out > 0:
        shape = (steps, y.shape[0])
        draws.replace = _t(np.asarray(
            jax.random.uniform(k_rand1, shape) > random_out))
        draws.rand_ids = _t(np.asarray(jax.random.randint(
            k_rand2, shape, SYMBOLS.N_SPECIAL, V), np.int64))
    return draws


@pytest.mark.parametrize("smoothing,random_out", [
    (0.1, 0.0), (0.0, 0.7), (0.1, 0.7)],
    ids=["label_smoothing", "random_out", "both"])
def test_loss_options_match_jax(smoothing, random_out):
    mcfg = _mcfg()
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(3), mcfg)
    params, state = (jax.tree.map(np.asarray, t) for t in (params, state))
    rng = np.random.RandomState(4)
    B, T, U = 3, 40, 7
    X = rng.randn(B, T, 13).astype(np.float32)
    y = rng.randint(4, V, (B, U)).astype(np.int32)
    y[:, 0] = 1
    y[0, 5], y[0, 6] = 2, 0
    y[1, 6] = 2
    y[2, 3], y[2, 4:] = 2, 0
    key, n_real, teach, noise = jax.random.PRNGKey(1), 3.0, 0.8, 0.1

    def loss_fn(p):
        return jax_seq2seq.forward_loss(
            p, state, mcfg, jnp.asarray(X), jnp.asarray(y), key, train=True,
            n_real=n_real, teach_ratio=teach, add_noise=noise,
            random_out=random_out, label_smoothing=smoothing)

    (ref_loss, _), ref_g = jax.value_and_grad(loss_fn, has_aux=True)(params)
    draws = _jax_draws(key, X.shape, y, teach, noise, random_out)
    if random_out > 0:
        hit = draws.replace & (_t(y).t()[1:] >= SYMBOLS.N_SPECIAL)
        assert hit.any() and not hit.all()      # some targets replaced

    tp, ts = from_jax_numpy(params, state)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = seq2seq.forward_loss(tp, ts, mcfg, _t(X), _t(y).long(), n_real,
                                   draws, label_smoothing=smoothing)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    # the options change the loss: the plain loss is another number
    plain, _ = seq2seq.forward_loss(
        tp, ts, mcfg, _t(X), _t(y).long(), n_real,
        seq2seq.Draws(draws.noise, draws.enc_seed, draws.dec_seed,
                      draws.coins))
    assert abs(plain.item() - loss.item()) > 1e-3
    it = iter(torch.autograd.grad(loss, leaves))
    got = flatten(tree_map(lambda _: next(it).numpy(), tp))
    want = jax_ckpt._flatten(jax.tree.map(np.asarray, ref_g))
    assert sorted(got) == sorted(want)
    for k in want:
        tol = (dict(rtol=0, atol=1e-5) if k in ("dec/out_w", "dec/out_b")
               else DEC_GRAD)
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)


def test_make_draws_options():
    X = torch.zeros((4, 50, 13))
    lens = np.array([50, 31, 8, 0], np.int32)
    spec = {"freq_masks": 2, "freq_width": 4, "time_masks": 2,
            "time_width": 10}
    a = seq2seq.make_draws(9, X, 6, 0.5, 0.25, random_out=0.3, vocab=V,
                           spec_cfg=spec, frame_len=lens)
    b = seq2seq.make_draws(9, X, 6, 0.5, 0.25, random_out=0.3, vocab=V,
                           spec_cfg=spec, frame_len=lens)
    plain = seq2seq.make_draws(9, X, 6, 0.5, 0.25)
    # the optional draws leave the others as they were
    assert torch.equal(a.coins, plain.coins) and a.enc_seed == plain.enc_seed
    assert plain.replace is None and plain.spec is None
    assert torch.equal(a.replace, b.replace)
    assert torch.equal(a.rand_ids, b.rand_ids)
    assert a.replace.shape == a.rand_ids.shape == (6, 4)
    assert a.replace.dtype == torch.bool
    assert SYMBOLS.N_SPECIAL <= int(a.rand_ids.min())
    assert int(a.rand_ids.max()) < V
    assert 0.4 < a.replace.float().mean() < 0.95     # P(u > 0.3) = 0.7
    assert len(a.spec.freq) == len(a.spec.time) == 2
    for (s1, w1), (s2, w2) in zip(a.spec.freq + a.spec.time,
                                  b.spec.freq + b.spec.time):
        assert torch.equal(s1, s2) and torch.equal(w1, w2)


# ---------------------------------------------------------------------------
# SpecAugment
# ---------------------------------------------------------------------------

def _jax_masks(key, shape, cfg, lengths):
    """The starts and widths ast_tpu's spec_augment draws from ``key``
    (its splits and draws repeated), as the port's SpecMasks."""
    B, T, D = shape
    n_f, f_w = cfg["freq_masks"], cfg["freq_width"]
    n_t, t_w = cfg["time_masks"], cfg["time_width"]
    t_p = cfg.get("time_p", 0.0)
    keys = jax.random.split(key, n_f + n_t)
    lengths = jnp.asarray(lengths, jnp.int32).reshape(B, 1)

    def axis(k, max_width, span, cap=None):
        kw, ks = jax.random.split(k)
        span = jnp.broadcast_to(jnp.asarray(span, jnp.int32), (B, 1))
        w = jax.random.randint(kw, (B, 1), 0, max_width + 1)
        if cap is not None:
            w = jnp.minimum(w, cap)
        w = jnp.minimum(w, span)
        u = jax.random.uniform(ks, (B, 1))
        start = jnp.floor(u * (span - w + 1).astype(jnp.float32))
        return (_t(np.asarray(start, np.int64)), _t(np.asarray(w, np.int64)))

    cap = ((t_p * lengths.astype(jnp.float32)).astype(jnp.int32)
           if t_p > 0 else None)
    return sa.SpecMasks(
        [axis(keys[m], f_w, D) for m in range(n_f)],
        [axis(keys[n_f + m], t_w, lengths, cap) for m in range(n_t)])


def _padded_batch(seed=0, B=5, T=60, D=13):
    rng = np.random.RandomState(seed)
    X = rng.randn(B, T, D).astype(np.float32)
    lens = np.array([60, 41, 17, 5, 0], np.int32)[:B]
    for r, n in enumerate(lens):
        X[r, n:] = 0
    return X, lens


@pytest.mark.parametrize("cfg", [
    {"freq_masks": 2, "freq_width": 6, "time_masks": 2, "time_width": 40},
    {"freq_masks": 1, "freq_width": 3, "time_masks": 3, "time_width": 25,
     "time_p": 0.2},
    {"freq_masks": 2, "freq_width": 5, "time_masks": 0, "time_width": 40},
], ids=["default", "time_p", "freq_only"])
@pytest.mark.parametrize("given_lengths", [True, False],
                         ids=["loader_lengths", "inferred_lengths"])
def test_spec_augment_matches_jax(cfg, given_lengths):
    X, lens = _padded_batch()
    key = jax.random.PRNGKey(17)
    want = np.asarray(jax_sa.spec_augment(
        key, jnp.asarray(X), cfg, lengths=lens if given_lengths else None))
    np.testing.assert_array_equal(sa.frame_lengths(_t(X)).numpy(),
                                  np.asarray(jax_sa.frame_lengths(
                                      jnp.asarray(X))))
    used = lens if given_lengths else sa.frame_lengths(_t(X)).numpy()
    got = sa.apply_spec_masks(_t(X), _jax_masks(key, X.shape, cfg, used))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).sum() > (X == 0).sum()       # something was masked


def test_spec_mask_draws_stay_in_bounds():
    cfg = {"freq_masks": 2, "freq_width": 6, "time_masks": 2,
           "time_width": 40, "time_p": 0.5}
    X, lens = _padded_batch()
    L = torch.from_numpy(lens).long()[:, None]
    for seed in range(20):
        gen = torch.Generator().manual_seed(seed)
        m = sa.draw_spec_masks(gen, X.shape, cfg, lens)
        for start, w in m.freq:
            assert start.shape == w.shape == (5, 1)
            assert (w >= 0).all() and (w <= 6).all() and (start >= 0).all()
            assert (start + w <= 13).all()
        for start, w in m.time:
            assert (w <= 40).all() and (w <= L // 2).all()
            assert (start >= 0).all() and (start + w <= L).all()
        # drawing and applying in one call is the two in turn
        again = torch.Generator().manual_seed(seed)
        one = sa.spec_augment(again, _t(X), cfg, lens)
        assert torch.equal(one, sa.apply_spec_masks(_t(X), m))
        assert torch.equal(one[lens == 0], _t(X)[lens == 0])
    inferred = sa.draw_spec_masks(torch.Generator().manual_seed(0), X.shape,
                                  cfg, X=_t(X))
    given = sa.draw_spec_masks(torch.Generator().manual_seed(0), X.shape,
                               cfg, lens)
    assert all(torch.equal(a, b) for p, q in zip(inferred.time, given.time)
               for a, b in zip(p, q))


# ---------------------------------------------------------------------------
# weight noise
# ---------------------------------------------------------------------------

def test_weight_noise_matches_jax():
    mcfg = _mcfg()
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(3), mcfg)
    key, mean, sigma = jax.random.PRNGKey(8), 0.01, 0.05
    want = jax_seq2seq.add_weight_noise(params, key, mean, sigma)
    # the noise ast_tpu draws, leaf by leaf in its order
    enc = jax.tree.leaves(params["enc"]["lstm"])
    dec = jax.tree.leaves(params["dec"]["lstm"])
    keys = jax.random.split(key, len(enc) + 1 + len(dec))
    shapes = [a.shape for a in enc + dec] + [params["dec"]["embed"].shape]
    noise = [_t(np.asarray(jax.random.normal(k, s)))
             for k, s in zip(keys, shapes)]

    tp, _ = from_jax_numpy(jax.tree.map(np.asarray, params), {})
    for p in tree_leaves(tp):
        p.requires_grad_(True)              # as the trainer holds them
    targets = seq2seq.weight_noise_targets(tp)
    assert [tuple(p.shape) for _, p in targets] == [tuple(s) for s in shapes]
    flat = flatten(tp, leaf=lambda t: t)
    assert all(flat[path] is p for path, p in targets)
    seq2seq.add_weight_noise(tp, mean, sigma, noise)
    got = flatten(to_numpy(tp))
    ref = jax_ckpt._flatten(jax.tree.map(np.asarray, want))
    before = jax_ckpt._flatten(jax.tree.map(np.asarray, params))
    moved = 0
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6,
                                   err_msg=k)
        if np.array_equal(ref[k], before[k]):
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)
        else:
            moved += 1
    assert moved == len(shapes)
    with pytest.raises(ValueError, match="noise tensors"):
        seq2seq.add_weight_noise(tp, mean, sigma, noise[:-1])


def test_trainer_adds_weight_noise_from_its_epoch(tmp_path):
    exp = make_tiny_experiment(str(tmp_path), n_train=4, n_dev=4, extras={
        "weight_noise_iter": 2, "weight_noise_mean": 0.0,
        "weight_noise_sigma": 0.5})
    nn = NN(exp, "cpu")
    moved = []
    orig = nn.add_weight_noise
    nn.add_weight_noise = lambda epoch: (moved.append(epoch), orig(epoch))
    w0 = nn.params["dec"]["embed"].detach().clone()
    nn.train_epoch("tiny_train", epoch=1)
    assert moved == []
    w1 = nn.params["dec"]["embed"].detach().clone()
    nn.train_epoch("tiny_train", epoch=2)
    assert moved == [2]
    # sigma 0.5 on the embedding dwarfs one step at lr 0.01
    assert float((w1 - w0).abs().max()) < 0.1
    assert float((nn.params["dec"]["embed"].detach() - w1).std()) > 0.3


# ---------------------------------------------------------------------------
# gradient noise and the bfloat16 first moment
# ---------------------------------------------------------------------------

def _toy_params(rng, big=0):
    p = {"cnn": [{"w": rng.randn(4, 1, 3, 2).astype(np.float32)}],
         "dec": {"embed": rng.randn(5, 3).astype(np.float32),
                 "lstm": [{"b": rng.randn(8).astype(np.float32)}]}}
    if big:
        p["dec"]["out_w"] = np.zeros(big, np.float32)
    return p


@pytest.mark.parametrize("opt_cfg", [
    {"type": 0, "lr": 1e-3, "l2": 1e-4, "grad_clip": 2,
     "grad_noise_eta": 0.01},
    {"type": 0, "lr": 1e-3, "grad_clip": 2, "grad_noise_eta": 0.01,
     "moments_dtype": "bfloat16", "freeze": ["cnn"]},
    {"type": 1, "lr": 0.1, "grad_noise_eta": 0.3},
], ids=["amsgrad", "bf16_freeze", "sgd"])
def test_noise_state_layout_matches_optax(opt_cfg):
    params = _toy_params(np.random.RandomState(0))
    seed = 1234567
    _, jstate = jax_build_optimizer(opt_cfg, jax.tree.map(jnp.asarray,
                                                          params), seed=seed)
    tp, _ = from_jax_numpy(params, {})
    _, state = build_optimizer(opt_cfg, tp, seed=seed)
    want = jax_ckpt._flatten(jax.tree.map(jax_ckpt._savable, jstate))
    got = flatten(to_numpy(state))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert any(k.endswith("/key") and got[k].dtype == np.uint32
               and got[k].shape == (2,) for k in got)
    # ast_tpu's state loads into the port's, bf16 moments in their dtype
    loaded = merge(state, jax_ckpt._unflatten(want), "opt")
    mus = [t for t in tree_leaves(loaded) if t.dtype == torch.bfloat16]
    assert bool(mus) == (opt_cfg.get("moments_dtype") == "bfloat16")


def test_noise_sigma_follows_ast_tpu_schedule():
    """The level of the noise each package adds at steps 0, 1 and 10,
    measured on 2e5 zero gradients, against the port's schedule."""
    eta, n = 0.04, 200_000
    opt_cfg = {"type": 1, "lr": 1.0, "grad_noise_eta": eta}     # SGD: -g
    params = _toy_params(np.random.RandomState(0), big=n)
    zeros = jax.tree.map(np.zeros_like, params)
    tx, jstate = jax_build_optimizer(opt_cfg, jax.tree.map(jnp.asarray,
                                                           params), seed=3)
    tp, _ = from_jax_numpy(params, {})
    tz, _ = from_jax_numpy(zeros, {})
    opt, state = build_optimizer(opt_cfg, tp, seed=3)
    for step in range(11):
        ju, jstate = tx.update(jax.tree.map(jnp.asarray, zeros), jstate)
        u, state = opt.update(tz, state, tp)
        if step in (0, 1, 10):
            want = np.sqrt(eta / (1.0 + step) ** 0.55)
            assert abs(noise_sigma(eta, step) - want) < 1e-7
            for got in (np.asarray(ju["dec"]["out_w"]),
                        u["dec"]["out_w"].numpy()):
                np.testing.assert_allclose(got.std(), want, rtol=0.02)
                assert abs(got.mean()) < 0.02 * want
    flat = flatten(to_numpy(state))
    assert int(flat["0/count"]) == 11 == int(jstate[0]["count"])
    # a state loaded at step 11 goes on with step 11's draw
    opt2, state2 = build_optimizer(opt_cfg, tp, seed=3)
    u2, _ = opt2.update(tz, merge(state2, to_numpy(state), "opt"), tp)
    u1, _ = opt.update(tz, state, tp)
    assert torch.equal(u1["dec"]["out_w"], u2["dec"]["out_w"])
    np.testing.assert_allclose(float(u1["dec"]["out_w"].std()),
                               noise_sigma(eta, 11), rtol=0.02)


def test_bf16_first_moment_matches_optax():
    opt_cfg = {"type": 0, "lr": 1e-3, "l2": 1e-4, "grad_clip": 2,
               "moments_dtype": "bfloat16"}
    rng = np.random.RandomState(0)
    params = _toy_params(rng)
    jparams = jax.tree.map(jnp.asarray, params)
    tx, jstate = jax_build_optimizer(opt_cfg, jparams)
    tp, _ = from_jax_numpy(params, {})
    opt, state = build_optimizer(opt_cfg, tp)
    for step, scale in enumerate((3.0, 0.05, 1.0)):
        g = jax.tree.map(
            lambda a: (rng.randn(*a.shape) * scale).astype(np.float32),
            params)
        ju, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, ju)
        tg, _ = from_jax_numpy(g, {})
        u, state = opt.update(tg, state, tp)
        for p, d in zip(tree_leaves(tp), tree_leaves(u)):
            p.add_(d)
        _, mu, nu, _ = state[2]
        assert all(t.dtype == torch.bfloat16 for t in tree_leaves(mu))
        assert all(t.dtype == torch.float32 for t in tree_leaves(nu))
        assert jstate[2].mu["dec"]["embed"].dtype == jnp.bfloat16
        want = jax_ckpt._flatten({
            "u": jax.tree.map(np.asarray, ju),
            "opt": jax.tree.map(jax_ckpt._savable, jstate)})
        got = flatten({"u": to_numpy(u), "opt": to_numpy(state)})
        assert sorted(got) == sorted(want), step
        for k in want:
            if k.startswith("opt/2/1/"):            # the stored mu
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"step {step} {k}")
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=1e-6,
                                           err_msg=f"step {step} {k}")


# ---------------------------------------------------------------------------
# all of them through the trainer, and across the packages
# ---------------------------------------------------------------------------

ALL_EXTRAS = {"label_smoothing": 0.1, "random_out": 0.1}
ALL_OPT = {"grad_noise_eta": 0.01, "moments_dtype": "bfloat16"}
SPEC = {"freq_masks": 1, "freq_width": 3, "time_masks": 1, "time_width": 10}


def _options_exp(root):
    exp = make_tiny_experiment(str(root), n_train=12, n_dev=4,
                               extras=ALL_EXTRAS, optimizer=ALL_OPT)
    path = os.path.join(exp, "train_cfg.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["data"]["spec_augment"] = SPEC
    with open(path, "w") as f:
        json.dump(cfg, f)
    return exp


def _flat_opt(state):
    return flatten(to_numpy(state))


def test_options_train_and_ast_tpu_resumes(tmp_path, capsys):
    exp = _options_exp(tmp_path)
    nn = NN(exp, "cpu")
    seen = []
    orig = seq2seq.forward_loss

    def spy(*a, **k):
        seen.append((a[6], k.get("label_smoothing")))
        return orig(*a, **k)

    seq2seq.forward_loss = spy
    try:
        losses = [nn.train_epoch("tiny_train", epoch=e) for e in (1, 2, 3)]
    finally:
        seq2seq.forward_loss = orig
    assert all(np.isfinite(losses)) and losses[2] < losses[0]
    draws, smoothing = seen[0]
    assert smoothing == 0.1 and draws.replace is not None
    assert len(draws.spec.freq) == len(draws.spec.time) == 1
    nn.save(3)
    capsys.readouterr()
    ref = JaxNN(exp)
    assert "optimizer state not restored" not in capsys.readouterr().out
    assert ref.max_epoch == 3
    want = jax_ckpt._flatten(jax.tree.map(jax_ckpt._savable, ref.opt_state))
    got = _flat_opt(nn.opt_state)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["2/count"]) == int(got["3/0"]) == 12     # 3 x 4 steps
    assert ref.opt_state[3].mu["dec"]["embed"].dtype == jnp.bfloat16


def test_port_resumes_ast_tpu_options_checkpoint(tmp_path, capsys):
    exp = _options_exp(tmp_path)
    src = JaxNN(exp)
    src.save(2)
    capsys.readouterr()
    nn = NN(exp, "cpu")
    assert "optimizer state not restored" not in capsys.readouterr().out
    assert nn.max_epoch == 2
    mu = nn.opt_state[3][1]
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(mu))
    want = jax_ckpt._flatten(jax.tree.map(jax_ckpt._savable, src.opt_state))
    got = _flat_opt(nn.opt_state)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.isfinite(nn.train_epoch("tiny_train", epoch=3))
