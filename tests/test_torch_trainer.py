"""ast_tpu_torch's trainer machinery on the CPU (plain versions): the dev
loss against ast_tpu's, in-flight snapshots and preemption, the prefetch
threads and the decode pipeline, explicit checkpoints, a ``bn: false``
model, and what the gate still refuses.

Tolerances: ``eval_loss`` 1e-5 relative (f32 sums in another order);
a resumed epoch against an uninterrupted one bit-equal (one process, one
thread of arithmetic, the same draws); snapshots carried between the
packages bit-equal.
"""

import json
import os
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from ast_tpu.config import Config as JaxConfig
from ast_tpu.models import seq2seq as jax_seq2seq
from ast_tpu.train import checkpoint as jax_ckpt
from ast_tpu.train.trainer import NN as JaxNN
from ast_tpu_torch.checkpoint import (
    checkpoint_path, flatten, load_checkpoint, save_checkpoint)
from ast_tpu_torch.cli import train as train_cli
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.ops import beam as beam_ops
from ast_tpu_torch.train import trainer
from ast_tpu_torch.train.trainer import NN, PreemptedError, Prefetcher, to_numpy
from tests.conftest import make_tiny_experiment

TRAIN, DEV = "tiny_train", "tiny_dev"


def _edit_cfg(exp, fn, name="train_cfg.json"):
    path = os.path.join(exp, name)
    with open(path) as f:
        cfg = json.load(f)
    fn(cfg)
    with open(path, "w") as f:
        json.dump(cfg, f)


def _tiny(root, **kw):
    return make_tiny_experiment(str(root), n_train=12, n_dev=4, batch_size=4,
                                **kw)


def _flat(nn):
    return flatten({"p": to_numpy(nn.params), "s": to_numpy(nn.state),
                    "o": to_numpy(nn.opt_state)})


def _jax_flat(nn):
    return jax_ckpt._flatten(jax.tree.map(np.asarray, {
        "p": nn.params, "s": nn.state, "o": nn.opt_state}))


def _assert_flat_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# eval_loss
# ---------------------------------------------------------------------------

def test_eval_loss_matches_ast_tpu(tmp_path):
    exp = make_tiny_experiment(str(tmp_path), n_dev=7)
    # ast_tpu through its Pallas kernels, in interpret mode
    _edit_cfg(exp, lambda m: m["rnn_config"].update(
        fused_encoder=True, fused_decoder=True, fused_interpret=True),
        "model_cfg.json")
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(5),
                                           JaxConfig(exp).model)
    rng = np.random.RandomState(0)
    for s in state["cnn_bn"]:       # running statistics that matter
        s["bn_mean"] = rng.randn(*s["bn_mean"].shape).astype(np.float32) * .1
        s["bn_var"] = rng.uniform(.5, 2., s["bn_var"].shape).astype(
            np.float32)
    jax_ckpt.save_checkpoint(checkpoint_path(exp, 1), params, state)
    want = JaxNN(exp).eval_loss(DEV)
    nn = NN(exp, "cpu")
    before = _flat(nn)
    got = nn.eval_loss(DEV)
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert nn.eval_loss(DEV) == got         # no dropout, no noise
    _assert_flat_equal(_flat(nn), before)   # and nothing updated


# ---------------------------------------------------------------------------
# in-flight snapshots, preemption, mid-epoch resume
# ---------------------------------------------------------------------------

class _Boom(RuntimeError):
    pass


def _crash_after(nn, n_batches):
    """Make the loader's stream raise after ``n_batches`` batches."""
    orig = nn.data_loader.get_batch

    def wrapper(*a, **k):
        for i, b in enumerate(orig(*a, **k)):
            if i == n_batches:
                raise _Boom()
            yield b

    nn.data_loader.get_batch = wrapper


def _record_steps(nn):
    """[(utts, step seed)] of every train_step of ``nn`` from now on."""
    steps, orig = [], nn.train_step

    def step(batch, seed):
        steps.append((tuple(batch["utts"]), seed))
        return orig(batch, seed)

    nn.train_step = step
    return steps


def test_kill_and_resume_consumes_exact_suffix(tmp_path):
    whole_exp = _tiny(tmp_path / "whole")
    exp = _tiny(tmp_path / "cut")
    _edit_cfg(exp, lambda c: c.update(checkpoint_steps=1))

    whole = NN(whole_exp, "cpu")
    want = _record_steps(whole)
    whole_loss = whole.train_epoch(TRAIN, epoch=1)
    assert len(want) == 4 and len({s for _, s in want}) == 4

    nn1 = NN(exp, "cpu")
    first = _record_steps(nn1)
    _crash_after(nn1, 2)
    with pytest.raises(_Boom):
        nn1.train_epoch(TRAIN, epoch=1)
    assert first == want[:2]
    assert os.path.exists(os.path.join(exp, "seq2seq_inflight.npz"))

    nn2 = NN(exp, "cpu")                    # a fresh process's stand-in
    assert nn2.max_epoch == 0 and nn2.inflight_resume == (1, 2)
    _assert_flat_equal(_flat(nn2), _flat(nn1))
    assert int(_flat(nn2)["o/2/0"]) == 2    # AMSGrad's count goes on
    second = _record_steps(nn2)
    loss = nn2.train_epoch(TRAIN, epoch=1)
    # exactly the unconsumed batches, under the seeds of an uninterrupted
    # epoch, to the same parameters; the loss covers the suffix only
    assert second == want[2:]
    assert nn2.timer.n_steps == 2 and nn2.inflight_resume is None
    _assert_flat_equal(_flat(nn2), _flat(whole))
    assert np.isfinite(loss) and loss != whole_loss

    nn3 = NN(exp, "cpu")    # the "epoch 2 has consumed 0 batches" marker
    assert nn3.max_epoch == 1 and nn3.inflight_resume is None
    _assert_flat_equal(_flat(nn3), _flat(nn2))


def test_preempt_snapshots_and_resumes(tmp_path):
    """SIGTERM through the CLI's handler, without checkpoint_steps."""
    exp = _tiny(tmp_path)
    nn1 = NN(exp, "cpu")
    old = signal.getsignal(signal.SIGTERM)
    try:
        train_cli._install_preempt_handler(nn1)
        if threading.current_thread() is threading.main_thread():
            os.kill(os.getpid(), signal.SIGTERM)
        else:               # no handler can be installed off the main thread
            nn1.request_preempt()
        with pytest.raises(PreemptedError, match="after 1 batches"):
            nn1.train_epoch(TRAIN, epoch=1)
    finally:
        if threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGTERM, old)
    assert nn1.preempt_pending()
    extra = load_checkpoint(os.path.join(exp, "seq2seq_inflight.npz"))["extra"]
    assert {k: (int(v), v.dtype) for k, v in extra.items()} == {
        "epoch": (1, np.int64), "step": (1, np.int64), "g": (1, np.int64)}

    nn2 = NN(exp, "cpu")
    assert nn2.max_epoch == 0 and nn2.inflight_resume == (1, 1)
    assert not nn2.preempt_pending()
    _assert_flat_equal(_flat(nn2), _flat(nn1))
    assert np.isfinite(nn2.train_epoch(TRAIN, epoch=1))
    assert nn2.timer.n_steps == 3           # the stream's 4 minus 1


def test_inflight_position_discarded_on_g_change(tmp_path, capsys):
    """A position written at another steps_per_dispatch indexes another
    stream: the parameters load, the epoch restarts, and a line says so."""
    exp = _tiny(tmp_path)
    nn1 = NN(exp, "cpu")
    nn1.request_preempt()
    with pytest.raises(PreemptedError):
        nn1.train_epoch(TRAIN, epoch=1)
    assert NN(exp, "cpu").inflight_resume == (1, 1)
    path = os.path.join(exp, "seq2seq_inflight.npz")
    snap = load_checkpoint(path)
    snap["extra"]["g"] = np.int64(3)
    save_checkpoint(path, snap["params"], snap["state"], snap["opt"],
                    extra=snap["extra"])
    capsys.readouterr()
    nn2 = NN(exp, "cpu")
    assert ("inflight snapshot was written with steps_per_dispatch=3 but "
            "the config says 1; restarting epoch 1 from the beginning"
            in capsys.readouterr().out)
    assert nn2.inflight_resume is None and nn2.max_epoch == 0
    _assert_flat_equal(_flat(nn2), _flat(nn1))


def test_stale_inflight_is_ignored(tmp_path):
    exp = _tiny(tmp_path)
    _edit_cfg(exp, lambda c: c.update(checkpoint_steps=1))
    nn1 = NN(exp, "cpu")
    nn1.train_epoch(TRAIN, epoch=1)
    nn1.save(5)             # a newer epoch checkpoint outranks the snapshot
    nn2 = NN(exp, "cpu")
    assert nn2.max_epoch == 5 and nn2.inflight_resume is None


def test_preempt_after_training_phase_saves_epoch(tmp_path, monkeypatch):
    orig = trainer.NN.train_epoch

    def finish_then_preempt(self, *a, **k):
        loss = orig(self, *a, **k)
        self.request_preempt()      # SIGTERM as the batch loop ends
        return loss

    monkeypatch.setattr(trainer.NN, "train_epoch", finish_then_preempt)
    exp = _tiny(tmp_path)
    # -e 3 with iters_save 2: epoch 1 is not due for a save
    train_cli.main(["-m", exp, "-e", "3", "--device", "cpu"])
    assert os.path.exists(checkpoint_path(exp, 1))
    with open(os.path.join(exp, "train.log")) as f:
        assert len(f.read().splitlines()) == 1
    assert not os.path.exists(os.path.join(exp, "dev.log"))
    assert NN(exp, "cpu").max_epoch == 1


@pytest.mark.parametrize("writer", ["ast_tpu", "port"])
def test_inflight_snapshot_crosses_packages(tmp_path, writer):
    """A snapshot written by one package is resumed by the other at its
    step, with its parameters, BN state and optimizer state."""
    exp = _tiny(tmp_path)
    if writer == "ast_tpu":
        src = JaxNN(exp)
        src.save_inflight(1, 3)
        got = NN(exp, "cpu")
        _assert_flat_equal(_flat(got), _jax_flat(src))
        assert got.max_epoch == 0 and got.inflight_resume == (1, 3)
        steps = _record_steps(got)
        got.train_epoch(TRAIN, epoch=1)
        whole = [tuple(b["utts"]) for b in got.data_loader.get_batch(
            4, TRAIN, train=True, labels=True, epoch=1, tail_shrink=8)]
        assert [u for u, _ in steps] == whole[3:] and len(whole) == 4
    else:
        src = NN(exp, "cpu")
        src.request_preempt()
        with pytest.raises(PreemptedError):
            src.train_epoch(TRAIN, epoch=1)
        src.save_inflight(1, 3)
        got = JaxNN(exp)
        _assert_flat_equal(_jax_flat(got), _flat(src))
        assert got.max_epoch == 0 and got.inflight_resume == (1, 3)


# ---------------------------------------------------------------------------
# explicit checkpoint, options named at start-up
# ---------------------------------------------------------------------------

def test_explicit_ckpt_skips_resume_scan(tmp_path):
    exp = _tiny(tmp_path)
    nn1 = NN(exp, "cpu")
    assert nn1.loaded_ckpt is None
    nn1.save(4)
    other = str(tmp_path / "other.npz")
    p, s = seq2seq.init_model(nn1.mcfg, seed=99)
    save_checkpoint(other, to_numpy(p), to_numpy(s))
    nn1.save_inflight(6, 2)                 # newer than epoch 4
    auto = NN(exp, "cpu")
    assert auto.loaded_ckpt == checkpoint_path(exp, 4)
    assert auto.max_epoch == 5 and auto.inflight_resume == (6, 2)
    nn2 = NN(exp, "cpu", ckpt=other)
    assert nn2.loaded_ckpt == other and nn2.max_epoch == 0
    assert nn2.inflight_resume is None
    _assert_flat_equal(flatten(to_numpy(nn2.params)), flatten(to_numpy(p)))


def test_ignored_options_are_named(tmp_path, capsys):
    """No option is set and ignored any more: remat is ported, and a
    ``parallel`` block is the (data, model) mesh over the process group
    -- one process refuses an explicit data axis of 4 and a 1x2 mesh
    (ast_tpu's make_mesh: more than its devices)."""
    exp = _tiny(tmp_path)
    NN(exp, "cpu")
    assert "set and ignored" not in capsys.readouterr().out

    def edit(c):
        c["extras"]["remat"] = True
        c["parallel"] = {"data_axis": 4}
    _edit_cfg(exp, edit)
    with pytest.raises(ValueError, match="needs more than 1 devices"):
        NN(exp, "cpu")
    _edit_cfg(exp, lambda c: c.update(parallel={"data_axis": 1,
                                                "model_axis": 2}))
    with pytest.raises(ValueError, match="mesh 1x2 needs more than 1 "
                                         "devices"):
        NN(exp, "cpu")
    _edit_cfg(exp, lambda c: c.update(parallel={"data_axis": 1}))
    nn = NN(exp, "cpu")
    assert nn.mesh is None and nn.remat
    assert "set and ignored" not in capsys.readouterr().out


@pytest.mark.parametrize("name,edit", [
    ("steps_per_dispatch",
     lambda c: c["extras"].update(steps_per_dispatch=2)),
    ("hbm_cache", lambda c: c["extras"].update(hbm_cache=True)),
    ("transfer_dtype", lambda c: c["extras"].update(transfer_dtype="bfloat16")),
    ("compute_dtype", lambda c: c["extras"].update(compute_dtype="bfloat16")),
])
def test_nn_refuses_unported_options_by_name(tmp_path, name, edit):
    """Each option once refused by name is ported since: NN builds with
    it and trains an epoch, refusing nothing."""
    exp = _tiny(tmp_path)
    _edit_cfg(exp, edit)
    nn = NN(exp, "cpu")
    assert {"steps_per_dispatch": nn.steps_per_dispatch == 2,
            "hbm_cache": nn.hbm_cache,
            "transfer_dtype": nn.transfer_dtype == torch.bfloat16,
            "compute_dtype": nn.compute_dtype == torch.bfloat16}[name]
    assert np.isfinite(nn.train_epoch("tiny_train", epoch=1))


# ---------------------------------------------------------------------------
# prefetch threads and the decode pipeline
# ---------------------------------------------------------------------------

def test_prefetcher_keeps_order_and_raises_in_place():
    import time

    def slow_first(i):
        time.sleep(0.05 if i % 3 == 0 else 0.0)
        if i == 7:
            raise _Boom()
        return i * i

    pf = Prefetcher(iter(range(10)), slow_first, depth=4, workers=3)
    got = []
    with pytest.raises(_Boom):
        for v in pf:
            got.append(v)
    assert got == [i * i for i in range(7)]
    for t in pf.threads:
        t.join(timeout=5)
        assert not t.is_alive()


def test_prefetcher_under_contention():
    """More workers than cores and a short switch interval: every item
    once, in order, and no thread left behind."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pf = Prefetcher(iter(range(400)), lambda i: (i, i % 7), depth=3,
                        workers=8)
        got = list(pf)
    finally:
        sys.setswitchinterval(old)
    assert got == [(i, i % 7) for i in range(400)]
    for t in pf.threads:
        t.join(timeout=5)
        assert not t.is_alive()
    # a consumer that leaves early releases the workers too
    pf = Prefetcher(iter(range(400)), lambda i: i, depth=2, workers=4)
    for v in pf:
        if v == 5:
            break
    pf.close()
    for t in pf.threads:
        t.join(timeout=5)
        assert not t.is_alive()


@pytest.fixture(scope="module")
def decode_exp(tmp_path_factory):
    """A tiny experiment with a checkpoint and, computed batch by batch
    with no thread and no pipeline, its train order, greedy predictions
    and beams."""
    exp = make_tiny_experiment(str(tmp_path_factory.mktemp("pipe")),
                               n_train=12, n_dev=7, batch_size=4)
    nn = NN(exp, "cpu")
    with torch.no_grad():
        nn.params["dec"]["out_b"][2] -= 2.0     # EOS held back
    nn.save(1)
    order = [tuple(b["utts"]) for b in nn.data_loader.get_batch(
        4, TRAIN, train=True, labels=True, epoch=1, tail_shrink=8)]
    preds, beams = [], {}
    decode = beam_ops.make_beam_decoder(nn.mcfg, N=3, K=3, stop_limit=16)
    with torch.inference_mode():
        for b in nn.data_loader.get_batch(4, DEV, train=False,
                                          tail_shrink=8):
            X = torch.from_numpy(b["X"])
            p = seq2seq.predict_greedy(nn.params, nn.state, nn.mcfg, X, 16)[0]
            preds.extend(zip(b["utts"], p[:len(b["utts"])].tolist()))
            hyps, scores, lengths = decode(nn.params, nn.state, X)
            for j, u in enumerate(b["utts"]):
                beams[u] = [(hyps[j, n, :int(lengths[j, n])].tolist(),
                             float(scores[j, n])) for n in range(3)]
    return exp, order, preds, beams


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_and_pipeline_keep_order(decode_exp, depth):
    exp, order, preds, beams = decode_exp
    _edit_cfg(exp, lambda c: c["extras"].update(prefetch_workers=depth,
                                                decode_pipeline=depth))
    nn = NN(exp, "cpu")
    assert nn._decode_pipeline_depth() == depth
    assert nn.predict(DEV) == preds and len(preds) == 7
    # the loader's dev order moves with every pass: a fresh NN's first
    # pass is the fixture's
    got = NN(exp, "cpu").decode_beam_set(DEV, N=3, K=3)
    assert list(got) == list(beams)
    for u in beams:
        assert [h for h, _ in got[u]] == [h for h, _ in beams[u]]
        np.testing.assert_allclose([s for _, s in got[u]],
                                   [s for _, s in beams[u]], rtol=0,
                                   atol=1e-6)
    steps = _record_steps(nn)
    nn.train_epoch(TRAIN, epoch=1)
    assert [u for u, _ in steps] == order


def test_decode_pipeline_defaults_to_two(decode_exp):
    exp = decode_exp[0]
    _edit_cfg(exp, lambda c: c["extras"].pop("decode_pipeline", None))
    assert NN(exp, "cpu")._decode_pipeline_depth() == 2


# ---------------------------------------------------------------------------
# bn: false
# ---------------------------------------------------------------------------

def test_nn_resumes_ast_tpu_checkpoint_without_bn(tmp_path):
    exp = _tiny(tmp_path)
    _edit_cfg(exp, lambda m: m["cnn_config"].update(bn=False),
              "model_cfg.json")
    src = JaxNN(exp)
    assert src.state["cnn_bn"] == [{}, {}]
    src.save(2)
    nn = NN(exp, "cpu")
    assert nn.max_epoch == 2 and nn.state["cnn_bn"] == [{}, {}]
    assert "bn_gamma" not in nn.params["cnn"][0]
    _assert_flat_equal(_flat(nn), _jax_flat(src))
    loss = nn.train_epoch(TRAIN, epoch=3)
    assert np.isfinite(loss)
    nn.save(3)
    back = JaxNN(exp)                       # and ast_tpu takes it back
    assert back.max_epoch == 3
    _assert_flat_equal(_jax_flat(back), _flat(nn))
