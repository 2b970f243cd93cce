"""The trainer's feed options in ast_tpu_torch against ast_tpu, on the CPU
(plain versions): grouped runs and index-mode batches of the loader, the
device feature cache, ``transfer_dtype``'s host rounding,
``steps_per_dispatch`` and its snapshots, ``hbm_cache`` and ``remat``.

Tolerances: none.  The streams, the cache, the rounding and the resume
positions equal ast_tpu's exactly; an ``hbm_cache`` epoch, a grouped
epoch and a ``remat`` step are bit-equal to their option off (one
process, the same draws, the same arithmetic), as
tests/test_device_cache.py and tests/test_multi_dispatch.py hold
ast_tpu's.
"""

import copy
import json
import os
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ast_tpu.data import dataloader as jax_dataloader
from ast_tpu.data.device_cache import EpochFeatureCache as JaxCache
from ast_tpu.train import checkpoint as jax_ckpt
from ast_tpu.train.trainer import NN as JaxNN
from ast_tpu_torch.checkpoint import flatten, load_checkpoint
from ast_tpu_torch.data import dataloader
from ast_tpu_torch.data.device_cache import EpochFeatureCache, gather_batch
from ast_tpu_torch.train import trainer
from ast_tpu_torch.train.trainer import NN, PreemptedError, to_numpy
from ast_tpu_torch.utils.seeding import stable_seed
from tests.conftest import make_tiny_experiment

TRAIN, DEV = "tiny_train", "tiny_dev"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tests: several test workers
    with a torch thread a core each oversubscribe the cores, which slows
    these small steps many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edit(exp, **extras):
    path = os.path.join(exp, "train_cfg.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["extras"].update(extras)
    with open(path, "w") as f:
        json.dump(cfg, f)


def _tiny(root, n_train=14, **extras):
    exp = make_tiny_experiment(str(root), n_train=n_train, n_dev=5,
                               batch_size=4)
    _edit(exp, **extras)
    return exp


def _tcfg(exp):
    with open(os.path.join(exp, "train_cfg.json")) as f:
        return json.load(f)


def _loaders(exp):
    tcfg = _tcfg(exp)
    return (dataloader.make_dataloader(copy.deepcopy(tcfg), exp),
            jax_dataloader.make_dataloader(copy.deepcopy(tcfg), exp))


def _flat(nn):
    return flatten({"p": to_numpy(nn.params), "s": to_numpy(nn.state),
                    "o": to_numpy(nn.opt_state)})


def _assert_flat_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the loader: grouped runs, index mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run_len", [1, 2, 3, 4])
def test_group_bucket_runs_equals_ast_tpu(run_len):
    rng = np.random.RandomState(run_len)
    batch_list = [((f"u{i}",), int(rng.randint(5))) for i in range(41)]
    got = dataloader._group_bucket_runs(list(batch_list), run_len)
    assert got == jax_dataloader._group_bucket_runs(list(batch_list),
                                                    run_len)
    assert sorted(got) == sorted(batch_list)


@pytest.mark.parametrize("G", [2, 4])
def test_grouped_stream_equals_ast_tpu(tmp_path, G):
    """utts, bucket, rows, X (frame dropout on) and y of each batch."""
    port, ref = _loaders(_tiny(tmp_path, n_train=30))
    kw = dict(train=True, labels=True, epoch=3, group_runs=G,
              tail_shrink=8)
    got = list(port.get_batch(4, TRAIN, **kw))
    want = list(ref.get_batch(4, TRAIN, **kw))
    assert len(got) == len(want) > 4
    for g, w in zip(got, want):
        for k in ("utts", "bucket", "rows", "n_real"):
            assert g[k] == w[k], k
        for k in ("X", "y", "frame_len"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # the runs: same-bucket batches pulled together, a permutation of G=1
    plain = list(port.get_batch(4, TRAIN, train=True, labels=True, epoch=3,
                                tail_shrink=8))
    assert sorted(tuple(b["utts"]) for b in got) == sorted(
        tuple(b["utts"]) for b in plain)


def test_index_mode_stream_equals_ast_tpu(tmp_path):
    """rows_idx, drop_mask (uint8) and frame_len equal ast_tpu's, with
    frame dropout on; the cache's rows times the mask are the port's
    host-mode X bit for bit."""
    exp = _tiny(tmp_path, n_train=20)
    port, ref = _loaders(exp)
    host = dataloader.make_dataloader(_tcfg(exp), exp)
    assert port.data_cfg["zero_input"] > 0
    cache, jcache = EpochFeatureCache(port, TRAIN), JaxCache(ref, TRAIN)
    kw = dict(train=True, labels=True, epoch=2, group_runs=2,
              tail_shrink=8)
    got = list(port.get_batch(4, TRAIN, index_cache=cache, **kw))
    want = list(ref.get_batch(4, TRAIN, index_cache=jcache, **kw))
    hosted = list(host.get_batch(4, TRAIN, **kw))
    assert len(got) == len(want) == len(hosted) > 2
    dropped = 0
    for g, w, h in zip(got, want, hosted):
        assert g["X"] is None and g["utts"] == w["utts"] == h["utts"]
        assert g["drop_mask"].dtype == np.uint8
        for k in ("rows_idx", "drop_mask", "frame_len", "y"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        X = gather_batch(cache.bucket_array(g["bucket"]),
                         torch.from_numpy(g["rows_idx"]),
                         torch.from_numpy(g["drop_mask"]))
        np.testing.assert_array_equal(X.numpy().view(np.int32),
                                      h["X"].view(np.int32))
        dropped += int((g["drop_mask"][:g["n_real"]] == 0).sum())
    assert dropped > 0


# ---------------------------------------------------------------------------
# the device feature cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_equals_ast_tpu(tmp_path, dtype):
    """Each bucket's array (its bit pattern), row_of, true_len, pad rows
    and nbytes; the loader's host cache is off while it builds."""
    port, ref = _loaders(_tiny(tmp_path))
    jdt = np.float32 if dtype == "float32" else jnp.bfloat16
    cache = EpochFeatureCache(port, TRAIN, dtype=getattr(torch, dtype))
    want = JaxCache(ref, TRAIN, dtype=jdt)
    assert port.cache_features and not port._cache
    assert cache.row_of == want.row_of and cache.true_len == want.true_len
    assert cache.nbytes == want.nbytes
    bits = np.int32 if dtype == "float32" else np.int16
    for b in range(port.buckets[TRAIN]["num_b"]):
        g, w = cache.bucket_array(b), want.bucket_array(b)
        assert (g is None) == (w is None)
        if g is None:
            continue
        assert cache.pad_row(b) == want.pad_row(b) == g.shape[0] - 1
        assert g.dtype == getattr(torch, dtype)
        gb = g.view(torch.int32 if bits == np.int32 else torch.int16)
        np.testing.assert_array_equal(gb.numpy(),
                                      np.asarray(w).view(bits))
        assert not g[-1].any()


def test_cache_and_option_refusals(tmp_path):
    """ast_tpu's ValueErrors: a text-encoder loader, hbm_cache over audio
    or text, a bad hbm_cache_dtype or transfer_dtype."""
    class TextLoader:
        text_mode = True

    with pytest.raises(ValueError, match="text-encoder"):
        EpochFeatureCache(TextLoader(), "train")
    exp = _tiny(tmp_path)
    for extras, match in (({"hbm_cache": True, "hbm_cache_dtype": "int8"},
                           "hbm_cache_dtype='int8': float32 | bfloat16"),
                          ({"transfer_dtype": "int8"},
                           "transfer_dtype='int8': use float32 | bfloat16 "
                           "| float16")):
        _edit(exp, hbm_cache=False, hbm_cache_dtype="float32",
              transfer_dtype="float32")
        _edit(exp, **extras)
        with pytest.raises(ValueError, match=re.escape(match)):
            NN(exp, "cpu")
        with pytest.raises(ValueError, match=re.escape(match)):
            JaxNN(exp)
    cfg = _tcfg(exp)
    cfg["extras"].update(hbm_cache=True, transfer_dtype="float32",
                         hbm_cache_dtype="float32")
    for data, match in (({"features": "wav"}, "needs precomputed features"),
                        ({"enc_key": "src"}, "text-encoder mode")):
        c = copy.deepcopy(cfg)
        c["data"].update(data)
        with pytest.raises(ValueError, match=match):
            trainer.require_train_variant(c)


# ---------------------------------------------------------------------------
# transfer_dtype
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_transfer_rounding_equals_ast_tpu(tmp_path, name):
    """Train features cross in the narrow dtype with ast_tpu's host
    rounding bit for bit (ml_dtypes / numpy), the step widens them; eval
    batches ship f32."""
    exp = _tiny(tmp_path, transfer_dtype=name)
    nn, ref = NN(exp, "cpu"), JaxNN(exp)
    batch = next(nn.data_loader.get_batch(4, TRAIN, train=True, labels=True,
                                          epoch=1))
    X = batch["X"] * np.float32(1 + 2 ** -9)     # off the narrow grid
    batch = dict(batch, X=X)
    got = nn._device_batch(batch, narrow=True)
    want = np.asarray(ref._device_batch(batch, True, narrow=True)["X"])
    np_dt = ml_dtypes.bfloat16 if name == "bfloat16" else np.float16
    assert want.dtype == np_dt
    assert got["X"].dtype == getattr(torch, name)
    bits = got["X"].view(torch.int16).numpy()
    np.testing.assert_array_equal(bits, want.view(np.int16))
    np.testing.assert_array_equal(bits, X.astype(np_dt).view(np.int16))
    assert nn.features(got).dtype == torch.float32
    np.testing.assert_array_equal(nn.features(got).numpy(),
                                  want.astype(np.float32))
    assert got["h2d_bytes"] == X.size * 2 + batch["y"].nbytes
    assert nn._device_batch(batch)["X"].dtype == torch.float32


# ---------------------------------------------------------------------------
# hbm_cache
# ---------------------------------------------------------------------------

def _train(exp, epochs=2):
    nn = NN(exp, "cpu")
    losses = [nn.train_epoch(TRAIN, epoch=e) for e in range(1, epochs + 1)]
    return nn, losses


def test_hbm_cache_epochs_bit_equal_to_host_feeding(tmp_path):
    """Two epochs with frame dropout on: losses and parameters bit-equal;
    eval_loss, predict and decode_beam_set equal; only indices, mask and
    targets crossed."""
    host, losses_h = _train(_tiny(tmp_path / "h"))
    cached, losses_c = _train(_tiny(tmp_path / "c", hbm_cache=True))
    assert losses_c == losses_h
    _assert_flat_equal(_flat(cached), _flat(host))
    assert cached.epoch_h2d_bytes < host.epoch_h2d_bytes / 5
    assert cached.eval_loss(DEV) == host.eval_loss(DEV)
    assert cached.predict(DEV) == host.predict(DEV)
    assert (cached.decode_beam_set(DEV, 2, 2)
            == host.decode_beam_set(DEV, 2, 2))


def test_hbm_cache_bf16_trains(tmp_path):
    nn, losses = _train(_tiny(tmp_path, hbm_cache=True,
                              hbm_cache_dtype="bfloat16"), epochs=1)
    assert np.isfinite(losses).all()
    assert nn._hbm_caches[TRAIN].bucket_array(0).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# steps_per_dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [2, 3])
def test_grouped_epoch_bit_equal_to_single_steps(tmp_path, G):
    """An epoch at G equals single steps over the grouped stream, each
    with its batch's place in the epoch as its seed: losses and every
    parameter, BN and optimizer leaf bit-equal."""
    grouped, (loss_g,) = _train(_tiny(tmp_path / "g",
                                      steps_per_dispatch=G), epochs=1)
    single = NN(_tiny(tmp_path / "s"), "cpu")
    seed = single.seed
    losses, sizes = [], []
    for i, batch in enumerate(single.data_loader.get_batch(
            4, TRAIN, train=True, labels=True, epoch=1, group_runs=G,
            tail_shrink=8)):
        losses.append(float(single.train_step(
            batch, stable_seed(f"{seed}|1|{i}"))))
        sizes.append(max(1, len(batch["utts"])))
    assert loss_g == float(sum(np.float32(v) / s for v, s in
                               zip(losses, sizes)) / len(losses))
    _assert_flat_equal(_flat(grouped), _flat(single))
    assert grouped.timer.n_steps == len(losses)


def _record_utts(nn, monkeypatch):
    seen = []
    orig = nn.train_step

    def step(batch, seed):
        seen.append(tuple(batch["utts"]))
        return orig(batch, seed)

    monkeypatch.setattr(nn, "train_step", step)
    return seen


def test_resume_at_G_consumes_the_exact_suffix(tmp_path, monkeypatch):
    """Preempted at G = 3 after its first run (at a run boundary), a fresh
    NN resumes at that position, trains exactly the rest of the grouped
    stream, and ends bit-equal to an uninterrupted epoch."""
    whole, _ = _train(_tiny(tmp_path / "w", n_train=30,
                            steps_per_dispatch=3), epochs=1)
    exp = _tiny(tmp_path / "p", n_train=30, steps_per_dispatch=3)
    nn1 = NN(exp, "cpu")
    nn1.request_preempt()
    with pytest.raises(PreemptedError):
        nn1.train_epoch(TRAIN, epoch=1)
    extra = load_checkpoint(os.path.join(exp, trainer.INFLIGHT))["extra"]
    step = int(extra["step"])
    assert int(extra["g"]) == 3 and 1 <= step <= 3
    nn2 = NN(exp, "cpu")
    assert nn2.inflight_resume == (1, step)
    seen = _record_utts(nn2, monkeypatch)
    nn2.train_epoch(TRAIN, epoch=1)
    stream = [tuple(b["utts"]) for b in nn2.data_loader.get_batch(
        4, TRAIN, train=True, labels=True, epoch=1, group_runs=3,
        tail_shrink=8)]
    assert seen == stream[step:]
    _assert_flat_equal(_flat(nn2), _flat(whole))


def test_snapshot_of_another_G_restarts_its_epoch(tmp_path, capsys):
    exp = _tiny(tmp_path, steps_per_dispatch=2)
    nn1 = NN(exp, "cpu")
    nn1.request_preempt()
    with pytest.raises(PreemptedError):
        nn1.train_epoch(TRAIN, epoch=1)
    _edit(exp, steps_per_dispatch=3)
    capsys.readouterr()
    nn2 = NN(exp, "cpu")
    assert ("inflight snapshot was written with steps_per_dispatch=2 but "
            "the config says 3; restarting epoch 1 from the beginning"
            in capsys.readouterr().out)
    assert nn2.inflight_resume is None and nn2.max_epoch == 0
    _assert_flat_equal(_flat(nn2), _flat(nn1))


@pytest.mark.parametrize("writer", ["ast_tpu", "port"])
def test_inflight_at_G2_crosses_packages(tmp_path, writer, monkeypatch):
    """A snapshot at steps_per_dispatch 2 resumes in the other package at
    its position in the grouped stream."""
    exp = _tiny(tmp_path, n_train=20, steps_per_dispatch=2)
    if writer == "ast_tpu":
        JaxNN(exp).save_inflight(1, 2)
        got = NN(exp, "cpu")
        assert got.inflight_resume == (1, 2)
        seen = _record_utts(got, monkeypatch)
        got.train_epoch(TRAIN, epoch=1)
        stream = [tuple(b["utts"]) for b in got.data_loader.get_batch(
            4, TRAIN, train=True, labels=True, epoch=1, group_runs=2,
            tail_shrink=8)]
        want = [tuple(b["utts"]) for b in JaxNN(exp).data_loader.get_batch(
            4, TRAIN, train=True, labels=True, epoch=1, group_runs=2,
            tail_shrink=8)]
        assert stream == want and seen == stream[2:]
    else:
        src = NN(exp, "cpu")
        src.save_inflight(1, 2)
        got = JaxNN(exp)
        assert got.max_epoch == 0 and got.inflight_resume == (1, 2)
        _assert_flat_equal(jax_ckpt._flatten(jax.tree.map(np.asarray, {
            "p": got.params, "s": got.state, "o": got.opt_state})),
            _flat(src))


# ---------------------------------------------------------------------------
# remat, and every option at once
# ---------------------------------------------------------------------------

def test_remat_gradients_bit_equal(tmp_path, monkeypatch):
    """One step's gradients with forward_loss under checkpoint equal the
    step's without it, bit for bit, and so do the loss and the update."""
    grads = {}

    def run(exp, key):
        nn = NN(exp, "cpu")
        orig = nn.opt.update

        def update(g, state, params):
            grads[key] = [t.clone() for t in trainer.tree_leaves(g)]
            return orig(g, state, params)

        monkeypatch.setattr(nn.opt, "update", update)
        batch = next(nn.data_loader.get_batch(4, TRAIN, train=True,
                                              labels=True, epoch=1))
        return nn, float(nn.train_step(batch, 17))

    plain, loss_p = run(_tiny(tmp_path / "p"), "plain")
    remat, loss_r = run(_tiny(tmp_path / "r", remat=True), "remat")
    assert remat.remat and loss_r == loss_p
    assert len(grads["plain"]) == len(grads["remat"]) > 10
    for a, b in zip(grads["plain"], grads["remat"]):
        assert torch.equal(a, b)
    _assert_flat_equal(_flat(remat), _flat(plain))


def test_every_feed_option_at_once(tmp_path, capsys):
    """steps_per_dispatch 4, hbm_cache, transfer_dtype bfloat16 and remat
    together: NN trains an epoch and names nothing as ignored."""
    exp = _tiny(tmp_path, steps_per_dispatch=4, hbm_cache=True,
                transfer_dtype="bfloat16", remat=True)
    capsys.readouterr()
    nn, losses = _train(exp, epochs=1)
    out = capsys.readouterr().out
    assert "set and ignored" not in out and "hbm_cache[tiny_train]" in out
    assert np.isfinite(losses).all() and nn.timer.n_steps > 0
    assert nn.steps_per_dispatch == 4 and nn.remat
