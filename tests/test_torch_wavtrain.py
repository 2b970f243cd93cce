"""Training on audio (``data.features: "wav"``) in the port against
ast_tpu, on the CPU, on an experiment the port's fisher-recipe ``--wav``
writes from a tiny raw tree (tests/test_torch_recipe.py).

- ``WavDataLoader``'s batch stream equals ast_tpu's over an epoch with
  ``zero_input`` 0.1 set (no frame dropout in wav mode, and its RNG not
  drawn from): order, audio, CMVN rows, ``frame_len``, ``n_frames`` and
  targets;
- ``NN.train_step``'s first loss, featurized on the device before the
  draws, within 1e-5 relative of ast_tpu's jitted step on the same
  params and random draws (ast_tpu's Pallas kernels in interpret mode);
- ``eval_loss`` within 1e-5 relative; greedy tokens equal; ``cli.beam``'s
  ``.en`` bytes equal; and ``cli.train --device cpu`` trains an epoch.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ast_tpu.cli import beam as jax_beam
from ast_tpu.config import Config as JaxConfig
from ast_tpu.data.dataloader import make_dataloader as jax_make_loader
from ast_tpu.models import seq2seq as jax_seq2seq
from ast_tpu.train import checkpoint as jax_ckpt
from ast_tpu.train.trainer import NN as JaxNN
from ast_tpu_torch.checkpoint import checkpoint_path
from ast_tpu_torch.cli import beam, prep_data
from ast_tpu_torch.cli import train as train_cli
from ast_tpu_torch.data.dataloader import make_dataloader
from ast_tpu_torch.train import trainer
from ast_tpu_torch.train.trainer import NN
from tests.conftest import TINY_MODEL_CFG
from tests.test_torch_recipe import make_raw_tree, recipe_argv, run_cli
from tests.test_torch_train import _jax_draws

TRAIN, DEV = "train", "dev"
LOSS_TOL = 1e-5


def _edit(path, fn):
    with open(path) as f:
        cfg = json.load(f)
    fn(cfg)
    with open(path, "w") as f:
        json.dump(cfg, f)


@pytest.fixture(scope="module")
def wav_exp(tmp_path_factory):
    """The port's recipe --wav over a tiny raw tree (ast_tpu's Pallas
    kernels asked for in interpret mode), and a checkpoint of ast_tpu's
    init with EOS held back."""
    root = str(tmp_path_factory.mktemp("wavtrain"))
    raw = make_raw_tree(os.path.join(root, "raw"), n_utts=10)
    mcfg = json.loads(json.dumps(TINY_MODEL_CFG))
    mcfg["rnn_config"].update(fused_encoder=True, fused_decoder=True,
                              fused_interpret=True)
    mc = os.path.join(root, "model.json")
    with open(mc, "w") as f:
        json.dump(mcfg, f)
    out = os.path.join(root, "out")
    code, _ = run_cli(prep_data.main, recipe_argv(raw, out, True, mc)
                      + ["--device", "cpu"])
    assert code is None
    exp = os.path.join(out, "exp")
    _edit(os.path.join(exp, "train_cfg.json"), lambda c: (
        c.update(batch_size=4), c["data"].update(max_pred=16)))
    with open(os.path.join(exp, "train_cfg.json")) as f:
        cfg = json.load(f)
    assert cfg["data"]["features"] == "wav"
    assert cfg["data"]["zero_input"] == 0.1
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(5),
                                           JaxConfig(exp).model)
    params["dec"]["out_b"] = params["dec"]["out_b"].at[2].add(-2.0)
    jax_ckpt.save_checkpoint(checkpoint_path(exp, 1), params, state)
    return exp, cfg


def _batches(loader, set_key, train, epoch):
    return list(loader.get_batch(4, set_key, train=train, labels=True,
                                 epoch=epoch, tail_shrink=8))


@pytest.mark.parametrize("set_key,train,epoch", [
    (TRAIN, True, 1), (TRAIN, True, 2), (DEV, False, None)])
def test_wav_loader_stream_equals_ast_tpu(wav_exp, set_key, train, epoch):
    exp, cfg = wav_exp
    got = _batches(make_dataloader(cfg, exp), set_key, train, epoch)
    want = _batches(jax_make_loader(cfg, exp), set_key, train, epoch)
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert "X" not in a and "X_rows" not in a
        assert sorted(a) == sorted(b)
        assert a["utts"] == b["utts"]
        for k in ("n_real", "bucket", "rows", "n_frames"):
            assert a[k] == b[k], k
        for k in ("audio", "cmvn_mean", "cmvn_std", "frame_len", "y"):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        # S = (T - 1) * 80 + 200: exactly T frames
        assert a["audio"].shape[1] == (a["n_frames"] - 1) * 80 + 200
        assert (a["cmvn_std"][:a["n_real"]] != 1).all()


def test_first_wav_step_loss_matches_ast_tpu(wav_exp, monkeypatch):
    exp, cfg = wav_exp
    jnn = JaxNN(exp)
    batch = _batches(jnn.data_loader, TRAIN, True, 1)[0]
    epoch_key = jax.random.fold_in(jax.random.PRNGKey(jnn.seed), 1)
    step = jnn._make_train_step()
    X = tuple(jnp.asarray(batch[k])
              for k in ("audio", "cmvn_mean", "cmvn_std"))
    *_, ref = step(jax.tree.map(jnp.copy, jnn.params),
                   jax.tree.map(jnp.copy, jnn.state),
                   jax.tree.map(jnp.copy, jnn.opt_state), X,
                   jnp.asarray(batch["y"]), np.float32(batch["n_real"]),
                   epoch_key, 0, jnp.asarray(batch["frame_len"]))
    key = jax.random.fold_in(epoch_key, 0)

    nn = NN(exp, "cpu")
    extras = cfg["extras"]
    shapes = []

    def draws(seed, X, steps, teach_ratio, noise, **kw):
        shapes.append(tuple(X.shape))
        return _jax_draws(key, tuple(X.shape), steps, teach_ratio, noise)

    monkeypatch.setattr(trainer.seq2seq, "make_draws", draws)
    loss = nn.train_step(batch, 0)
    # the draws saw the features' shape: T frames, not the audio's samples
    assert shapes == [(batch["rows"], batch["n_frames"], 13)]
    assert extras["speech_noise"] > 0
    np.testing.assert_allclose(float(loss), float(ref), rtol=LOSS_TOL)
    # and the features are ast_tpu's
    got = nn.features(nn._device_batch(batch)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnn._featurize(X)), rtol=0,
                               atol=1e-4)


def test_wav_eval_loss_and_greedy_match_ast_tpu(wav_exp):
    exp, _ = wav_exp
    jnn, nn = JaxNN(exp), NN(exp, "cpu")
    want = jnn.eval_loss(DEV)
    got = nn.eval_loss(DEV)
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)
    ref = dict(jnn.predict(DEV))
    preds = dict(nn.predict(DEV))
    assert sorted(preds) == sorted(ref) and len(preds) > 1
    for u, ids in ref.items():
        assert preds[u] == [int(i) for i in ids], u


def test_wav_beam_cli_matches_ast_tpu(wav_exp):
    exp, _ = wav_exp
    args = ["-n", "3", "-k", "3", "-s", DEV, "-w", "0.6"]
    en = os.path.join(exp, f"{DEV}_beam_N-3_K-3_W-0.60.en")
    pkl = os.path.join(exp, f"{DEV}_beam_N-3_K-3.p")
    texts = []
    for main, extra in ((jax_beam.main, []),
                        (beam.main, ["--device", "cpu"])):
        main(["-m", exp] + args + extra)
        with open(en, "rb") as f:
            texts.append(f.read())
        os.remove(en)
        os.remove(pkl)
    assert texts[0] == texts[1] and texts[0]


def test_wav_train_cli_trains_an_epoch(wav_exp, tmp_path):
    exp, _ = wav_exp
    copy = str(tmp_path / "exp")
    shutil.copytree(exp, copy)
    _edit(os.path.join(copy, "train_cfg.json"),
          lambda c: c["data"].update(spec_augment={"freq_masks": 1,
                                                   "time_masks": 1}))
    train_cli.main(["-m", copy, "-e", "1", "--device", "cpu"])
    with open(os.path.join(copy, "train.log")) as f:
        rows = f.read().splitlines()
    assert len(rows) == 1 and rows[0].startswith("2, ")
    assert np.isfinite(float(rows[0].split(", ")[1]))
    assert os.path.exists(os.path.join(copy, "dev.log"))
    assert os.path.exists(checkpoint_path(copy, 2))


def test_hbm_cache_over_audio_is_refused_as_ast_tpu(wav_exp, tmp_path):
    exp, _ = wav_exp
    copy = str(tmp_path / "exp")
    shutil.copytree(exp, copy)
    _edit(os.path.join(copy, "train_cfg.json"),
          lambda c: c["extras"].update(hbm_cache=True))
    with pytest.raises(ValueError) as want:
        JaxNN(copy)
    with pytest.raises(ValueError) as got:
        NN(copy, "cpu")
    assert str(got.value) == str(want.value)
    assert "hbm_cache" in str(got.value)
