"""ast_tpu_torch.cli.infer vs ast_tpu.cli.infer on one tiny experiment.

A checkpoint saved by ast_tpu is decoded by both CLIs from the same .npy
files (several duration buckets, a truncated over-long input and a
duplicate basename); greedy and beam text must be identical.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from ast_tpu.cli import infer as jax_infer
from ast_tpu.models import seq2seq as jax_seq2seq
from ast_tpu.train import checkpoint as jax_ckpt
from ast_tpu_torch.cli import infer
from tests.conftest import make_tiny_experiment


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    exp = make_tiny_experiment(str(root))
    from ast_tpu.config import Config
    mcfg = Config(exp).model
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(11), mcfg)
    # EOS held back so reranked beams are not all the empty hypothesis
    params["dec"]["out_b"] = params["dec"]["out_b"].at[2].add(-2.0)
    jax_ckpt.save_checkpoint(os.path.join(exp, "seq2seq_2.model.npz"),
                             params, state)
    speech = os.path.join(str(root), "speech", "tiny_dev")
    paths = [os.path.join(speech, f) for f in sorted(os.listdir(speech))]
    long_path = os.path.join(str(root), "long.npy")
    np.save(long_path, np.random.RandomState(1).randn(300, 13).astype(
        np.float32))
    dup_dir = os.path.join(str(root), "dup")
    os.makedirs(dup_dir)
    shutil.copy(paths[0], dup_dir)
    return exp, paths + [long_path, os.path.join(dup_dir,
                                                 os.path.basename(paths[0]))]


@pytest.mark.parametrize("extra", [[], ["--beam", "3,3", "-w", "0.6"]],
                         ids=["greedy", "beam"])
def test_cli_text_matches_ast_tpu(experiment, tmp_path, extra):
    exp, paths = experiment
    ref = jax_infer.main(["-m", exp, "--batch", "3"] + extra + paths)
    out_file = str(tmp_path / "hyps.txt")
    got = infer.main(["-m", exp, "--batch", "3", "--device", "cpu",
                      "-o", out_file] + extra + paths)
    assert list(got) == list(ref)
    assert got == ref
    assert any(got.values())  # not all empty hypotheses
    with open(out_file) as f:
        lines = f.read().splitlines()
    assert [ln.split("\t")[0] for ln in lines] == list(ref)


def test_cli_cuda_requires_a_gpu(experiment):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    exp, paths = experiment
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["-m", exp, "--device", "cuda", paths[0]])


def test_cli_rejects_audio(experiment, tmp_path):
    exp, _ = experiment
    wav = tmp_path / "a.wav"
    wav.write_bytes(b"RIFF")
    audio = tmp_path / "a.npy"
    np.save(audio, np.zeros(8000, np.float32))
    for path in (wav, audio):
        with pytest.raises(NotImplementedError, match="fbank"):
            infer.main(["-m", exp, "--device", "cpu", str(path)])
