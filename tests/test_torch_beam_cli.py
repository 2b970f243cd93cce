"""ast_tpu_torch.cli.beam vs ast_tpu.cli.beam on one tiny experiment.

A checkpoint saved by ast_tpu is beam-decoded over the dev split by both
CLIs (the port on the CPU, plain versions).  Tolerances: pickle keys and
token lists equal, scores within 1e-4 (sums of a few f32 log-probs), BLEU
equal to 2 decimals, the ``.en`` text byte for byte; each package
``--resume``s the other's pickle without decoding again.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from ast_tpu.cli import beam as jax_beam
from ast_tpu.models import seq2seq as jax_seq2seq
from ast_tpu.train import checkpoint as jax_ckpt
from ast_tpu.train import trainer as jax_trainer
from ast_tpu_torch.cli import beam
from ast_tpu_torch.train import trainer
from tests.conftest import make_tiny_experiment

N, K, W = 3, 3, 0.6
SET = "tiny_dev"
ARGS = ["-n", str(N), "-k", str(K), "-s", SET, "-w", str(W)]
SCORE_TOL = 1e-4


def _files(exp, tag=""):
    return (os.path.join(exp, f"{SET}_beam_N-{N}_K-{K}{tag}.p"),
            os.path.join(exp, f"{SET}_beam_N-{N}_K-{K}_W-{W:.2f}{tag}.en"))


def _read(exp, tag=""):
    """(beam dict, .en bytes) of a run, removed from the directory so the
    next run starts clean."""
    p, en = _files(exp, tag)
    with open(p, "rb") as f:
        raw = f.read()
    with open(en, "rb") as f:
        text = f.read()
    os.remove(p)
    os.remove(en)
    return pickle.loads(raw), text, raw


def _assert_beams_equal(got, ref):
    assert list(got) == list(ref)
    for utt in ref:
        assert len(got[utt]) == len(ref[utt]) == N
        for (g_ids, g_s), (r_ids, r_s) in zip(got[utt], ref[utt]):
            assert g_ids == r_ids and g_ids[0] == 1, utt
            assert abs(g_s - r_s) < SCORE_TOL, utt
            assert type(g_ids) is list and type(g_s) is float


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """The experiment, ast_tpu's run of the CLI on it (bleu, beam, text,
    the pickle's bytes) and a second checkpoint for ``--ckpt``."""
    root = tmp_path_factory.mktemp("torch_beam_cli")
    # 7 dev utterances at batch 4: tail batches, padded rows dropped
    exp = make_tiny_experiment(str(root), n_dev=7)
    from ast_tpu.config import Config
    mcfg = Config(exp).model
    other = os.path.join(str(root), "averaged.npz")
    for seed, path in ((11, os.path.join(exp, "seq2seq_2.model.npz")),
                       (12, other)):
        params, state = jax_seq2seq.init_model(jax.random.PRNGKey(seed), mcfg)
        # EOS held back so reranked beams are not all the empty hypothesis
        params["dec"]["out_b"] = params["dec"]["out_b"].at[2].add(-2.0)
        jax_ckpt.save_checkpoint(path, params, state)
    bleu = jax_beam.main(["-m", exp] + ARGS)
    return (exp, other, bleu) + _read(exp)


def test_beam_cli_matches_ast_tpu(experiment, capsys):
    exp, _, ref_bleu, ref_beam, ref_text, _ = experiment
    bleu = beam.main(["-m", exp, "--device", "cpu"] + ARGS)
    assert f"BLEU = {bleu:.2f}" in capsys.readouterr().out
    got_beam, got_text, _ = _read(exp)
    _assert_beams_equal(got_beam, ref_beam)
    assert len(got_beam) == 7
    assert f"{bleu:.2f}" == f"{ref_bleu:.2f}"
    assert got_text == ref_text
    assert len(got_text.splitlines()) == 7 and got_text.strip()


def _no_decode(*a, **k):
    raise AssertionError("--resume decoded again")


def test_port_resumes_ast_tpu_pickle(experiment, monkeypatch):
    exp, _, ref_bleu, _, ref_text, ref_raw = experiment
    with open(_files(exp)[0], "wb") as f:
        f.write(ref_raw)
    monkeypatch.setattr(trainer.NN, "decode_beam_set", _no_decode)
    bleu = beam.main(["-m", exp, "--device", "cpu", "--resume"] + ARGS)
    _, text, raw = _read(exp)
    assert raw == ref_raw                   # the pickle is left as it was
    assert f"{bleu:.2f}" == f"{ref_bleu:.2f}" and text == ref_text


def test_ast_tpu_resumes_port_pickle(experiment, monkeypatch):
    exp, _, ref_bleu, _, ref_text, _ = experiment
    beam.main(["-m", exp, "--device", "cpu"] + ARGS)
    os.remove(_files(exp)[1])
    monkeypatch.setattr(jax_trainer.NN, "decode_beam_set", _no_decode)
    bleu = jax_beam.main(["-m", exp, "--resume"] + ARGS)
    _, text, _ = _read(exp)
    assert f"{bleu:.2f}" == f"{ref_bleu:.2f}" and text == ref_text


def test_ckpt_writes_tagged_files(experiment):
    exp, other, _, ref_beam, _, _ = experiment
    ref_bleu = jax_beam.main(["-m", exp, "--ckpt", other] + ARGS)
    tag = "_ckpt-averaged"
    tagged_beam, tagged_text, _ = _read(exp, tag)
    bleu = beam.main(["-m", exp, "--device", "cpu", "--ckpt", other] + ARGS)
    got_beam, got_text, _ = _read(exp, tag)
    _assert_beams_equal(got_beam, tagged_beam)
    assert got_text == tagged_text and f"{bleu:.2f}" == f"{ref_bleu:.2f}"
    # another model than the latest epoch's, and its files are apart
    assert any(got_beam[u][0][0] != ref_beam[u][0][0] for u in ref_beam)
    assert not os.path.exists(_files(exp)[0])


def test_save_attn_is_refused_by_name(experiment):
    """Once refused by name, ``--save-attn`` now pickles (hyp, score,
    attention history (len, T')) entries equal to ast_tpu's: histories
    within 1e-5, the GO row 0 and every other row a softmax; the BLEU
    and the .en text stay those of the run without it."""
    exp, _, ref_bleu, ref_beam, ref_text, _ = experiment
    want_bleu = jax_beam.main(["-m", exp, "--save-attn"] + ARGS)
    want, want_text, _ = _read(exp)
    bleu = beam.main(["-m", exp, "--device", "cpu", "--save-attn"] + ARGS)
    got, got_text, _ = _read(exp)
    _assert_beams_equal({u: [e[:2] for e in v] for u, v in got.items()},
                        {u: [e[:2] for e in v] for u, v in want.items()})
    _assert_beams_equal({u: [e[:2] for e in v] for u, v in got.items()},
                        ref_beam)
    for utt in want:
        for g, w in zip(got[utt], want[utt]):
            assert g[2].shape == w[2].shape == (len(g[0]), w[2].shape[1])
            np.testing.assert_allclose(g[2], w[2], rtol=0, atol=1e-5)
            np.testing.assert_allclose(g[2][1:].sum(axis=1), 1.0, atol=1e-5)
            assert not g[2][0].any()
    assert f"{bleu:.2f}" == f"{want_bleu:.2f}" == f"{ref_bleu:.2f}"
    assert got_text == want_text == ref_text


def test_beam_cli_cuda_requires_a_gpu(experiment):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        beam.main(["-m", experiment[0], "--device", "cuda"] + ARGS)
