"""ast_tpu_torch: weight bridge, checkpoints, vocab, detokenisation, and
the rule that the port never imports JAX.

Parameters made by ast_tpu's init_model go through numpy into the port
and back; checkpoints written by either package load in the other.
"""

import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from ast_tpu.data.dataloader import FisherDataLoader
from ast_tpu.data.detok import ids_to_text as jax_ids_to_text
from ast_tpu.models import seq2seq as jax_seq2seq
from ast_tpu.train import checkpoint as jax_ckpt
from ast_tpu_torch import checkpoint as port_ckpt
from ast_tpu_torch.detok import dec_i2w, get_hyps, ids_to_text
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.params import from_flat, from_jax_numpy, to_flat
from tests.conftest import TINY_MODEL_CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mcfg(bn=True):
    m = jax.tree.map(lambda x: x, TINY_MODEL_CFG)
    m["rnn_config"] = dict(m["rnn_config"], dec_vocab_size=12)
    m["cnn_config"] = dict(m["cnn_config"], bn=bn)
    return m


@pytest.fixture(scope="module")
def jax_model():
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(0), _mcfg())
    return (jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, state))


def _assert_flat_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_flat_keys_match_jax_flatten(jax_model):
    params, state = jax_model
    tp, ts = from_jax_numpy(params, state)
    _assert_flat_equal(to_flat(tp, ts),
                       jax_ckpt._flatten({"params": params, "state": state}))
    # and back: flat -> torch trees -> flat is the identity
    _assert_flat_equal(to_flat(*from_flat(to_flat(tp, ts))), to_flat(tp, ts))
    # bn: false -- a conv bias, and an empty dict a layer in the BN state
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(0),
                                           _mcfg(bn=False))
    params, state = (jax.tree.map(np.asarray, t) for t in (params, state))
    tp, ts = from_jax_numpy(params, state)
    want = jax_ckpt._flatten({"params": params, "state": state})
    assert "state/cnn_bn/0/__emptydict__" in want
    assert "params/cnn/0/b" in want and "params/cnn/0/bn_gamma" not in want
    _assert_flat_equal(to_flat(tp, ts), want)
    _assert_flat_equal(to_flat(*from_flat(to_flat(tp, ts))), want)


def test_port_init_has_jax_shapes(jax_model):
    tp, ts = seq2seq.init_model(_mcfg(), seed=0)
    mine = to_flat(tp, ts)
    ref = jax_ckpt._flatten({"params": jax_model[0], "state": jax_model[1]})
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert mine[k].shape == np.shape(ref[k]), k
        assert mine[k].dtype == np.asarray(ref[k]).dtype, k


def test_port_init_follows_bn():
    """``cnn_config.bn: false``: a conv bias, no BatchNorm leaves and an
    empty state a layer, as ast_tpu's init_model."""
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(0),
                                           _mcfg(bn=False))
    ref = jax_ckpt._flatten({"params": jax.tree.map(np.asarray, params),
                             "state": state})
    tp, ts = seq2seq.init_model(_mcfg(bn=False), seed=0)
    assert ts["cnn_bn"] == [{}, {}]
    mine = to_flat(tp, ts)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert mine[k].shape == np.shape(ref[k]), k
        assert mine[k].dtype == np.asarray(ref[k]).dtype, k
    assert not np.asarray(mine["params/cnn/1/b"]).any()      # zero bias


def test_jax_checkpoint_loads_in_port(tmp_path, jax_model):
    params, state = jax_model
    path = str(tmp_path / "seq2seq_3.model.npz")
    jax_ckpt.save_checkpoint(path, params, state, opt_state=None,
                             extra={"epoch": 3})
    assert port_ckpt.latest_checkpoint(str(tmp_path)) == (path, 3)
    snap = port_ckpt.load_checkpoint(path)
    tp, ts = from_jax_numpy(snap["params"], snap["state"])
    _assert_flat_equal(to_flat(tp, ts),
                       jax_ckpt._flatten({"params": params, "state": state}))


def test_port_checkpoint_loads_in_jax(tmp_path, jax_model):
    tp, ts = seq2seq.init_model(_mcfg(), seed=1)
    path = str(tmp_path / "seq2seq_1.model.npz")
    tree = port_ckpt.unflatten(to_flat(tp, ts))
    port_ckpt.save_checkpoint(path, tree["params"], tree["state"])
    loaded = jax_ckpt.load_checkpoint(path)
    # ast_tpu restores by merging into its own template (leaf order and
    # shapes checked), as NN._load_snapshot does
    params = jax_ckpt.merge_into(jax_model[0], loaded["params"], "params")
    state = jax_ckpt.merge_into(jax_model[1], loaded["state"], "state")
    _assert_flat_equal(
        jax_ckpt._flatten({"params": jax.tree.map(np.asarray, params),
                           "state": jax.tree.map(np.asarray, state)}),
        to_flat(tp, ts))


@pytest.mark.parametrize("limit_vocab", [False, True])
def test_dec_i2w_matches_ast_tpu(tmp_path, limit_vocab):
    vocab = {"i2w": {0: b"_PAD", 4: b"top"},
             "bpe_w": {"i2w": {0: b"_PAD", 4: b"bp@@"}},
             "en_w": {"i2w": {0: b"_PAD", 4: b"en"}}}
    path = str(tmp_path / "v.vocab")
    with open(path, "wb") as f:
        pickle.dump(vocab, f)
    data = {"vocab_path": path, "dec_key": "bpe_w",
            "limit_vocab": limit_vocab}
    # FisherDataLoader.dec_i2w reads only .vocab and .data_cfg
    ref = FisherDataLoader.dec_i2w.fget(
        SimpleNamespace(vocab=vocab, data_cfg=data))
    assert dec_i2w({"data": data}) == ref


@pytest.mark.parametrize("dec_key", ["en_w", "bpe_w", "en_c"])
def test_detok_matches_ast_tpu(dec_key):
    i2w = {0: b"_PAD", 1: b"_GO", 2: b"_EOS", 3: b"_UNK", 4: b"ha@@",
           5: b"llo", 6: b"w", 7: b"x y"}
    ids = [1, 4, 5, 2, 6, 0, 7, 3, 4]
    lookup = lambda i: i2w[i].decode()  # noqa: E731
    assert ids_to_text(ids, lookup, dec_key) == jax_ids_to_text(
        ids, lookup, dec_key)
    assert get_hyps([("u", np.asarray(ids))], i2w, dec_key) == {
        "u": jax_ids_to_text(ids, lookup, dec_key).split()}


def test_port_imports_no_jax(tmp_path):
    """Importing every module of the port, and the scripts that drive it
    on the card (chip_smoke, ab_kernels, profile_decode, the port's two
    learning scripts and its epoch benchmark), loads no JAX and no module
    of ast_tpu (nor bench / __graft_entry__, which import JAX); nor does
    the corpus preparation build its native library on import."""
    code = ("import importlib, os, pkgutil, sys\n"
            "import ast_tpu_torch, ast_tpu_torch.cli.infer, "
            "ast_tpu_torch.ops.beam, ast_tpu_torch.cli.train, "
            "ast_tpu_torch.cli.beam, ast_tpu_torch.utils.profiling, "
            "ast_tpu_torch.train.trainer, ast_tpu_torch.data.dataloader, "
            "ast_tpu_torch.eval.bleu, ast_tpu_torch.eval.wer, "
            "ast_tpu_torch.eval.metrics, ast_tpu_torch.cli.copy_params, "
            "ast_tpu_torch.train.chainer_import, ast_tpu_torch.checkpoint\n"
            "import ast_tpu_torch.cli.prep_data, ast_tpu_torch.native, "
            "ast_tpu_torch.data.recipe, ast_tpu_torch.data.wav_loader, "
            "ast_tpu_torch.data.transcripts, ast_tpu_torch.data.bpe, "
            "ast_tpu_torch.data.vocab, ast_tpu_torch.data.preprocess, "
            "ast_tpu_torch.data.kaldi_ark, ast_tpu_torch.data.feature_pack, "
            "ast_tpu_torch.data.validate, ast_tpu_torch.data.shorten, "
            "ast_tpu_torch.ops.bnf, ast_tpu_torch.ops.fbank\n"
            "from pathlib import Path\n"
            "ast_tpu_torch.native.BUILD_DIR = Path(sys.argv[1])\n"
            "for m in pkgutil.walk_packages(ast_tpu_torch.__path__, "
            "'ast_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import ab_kernels, chip_smoke, profile_decode\n"
            "sys.path.insert(0, 'scripts')\n"
            "import torch_synthetic_train, torch_transfer_ab\n"
            "import torch_trainer_epoch_bench\n"
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'ast_tpu', 'bench', "
            "'__graft_entry__', 'trainer_epoch_bench')]\n"
            "assert not bad, bad\n"
            "assert ast_tpu_torch.native._lib is None\n"
            "assert not os.path.exists(sys.argv[1])\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "native_build")], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr

