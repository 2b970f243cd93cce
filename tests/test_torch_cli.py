"""ast_tpu_torch.cli.infer vs ast_tpu.cli.infer on one tiny experiment.

A checkpoint saved by ast_tpu is decoded by both CLIs from the same .npy
feature files (several duration buckets, a truncated over-long input and
a duplicate basename) and from audio files (.wav, .sph, 1-D .npy) under
each --cmvn mode; greedy and beam text must be identical.
"""

import json
import os
import pickle
import shutil
import wave

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


def test_cli_decodes_a_variant_like_ast_tpu(tmp_path):
    """A model variant the decode kernels do not take (``ln``, two
    heads): greedy and beam text through the routed plain loops equal
    ast_tpu's."""
    exp = make_tiny_experiment(str(tmp_path))
    path = os.path.join(exp, "model_cfg.json")
    with open(path) as f:
        mcfg = json.load(f)
    mcfg["rnn_config"].update(ln=True, n_attn=2)
    with open(path, "w") as f:
        json.dump(mcfg, f)
    from ast_tpu.config import Config
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(12),
                                           Config(exp).model)
    params["dec"]["out_b"] = params["dec"]["out_b"].at[2].add(-2.0)
    jax_ckpt.save_checkpoint(os.path.join(exp, "seq2seq_1.model.npz"),
                             params, state)
    speech = os.path.join(str(tmp_path), "speech", "tiny_dev")
    paths = [os.path.join(speech, f) for f in sorted(os.listdir(speech))
             ][:3]
    for extra in ([], ["--beam", "3,3", "-w", "0.6"]):
        ref = jax_infer.main(["-m", exp, "--batch", "3"] + extra + paths)
        got = infer.main(["-m", exp, "--batch", "3", "--device", "cpu"]
                         + extra + paths)
        assert got == ref and any(got.values())


def test_cli_cuda_requires_a_gpu(experiment):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    exp, paths = experiment
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["-m", exp, "--device", "cuda", paths[0]])


def _write_wav(path, audio, rate=8000):
    pcm = np.clip(audio * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return str(path)


def _write_sph(path, audio, rate=8000):
    pcm = np.clip(audio * 32768.0, -32768, 32767).astype(">i2")
    header = (f"NIST_1A\n   1024\nsample_rate -i {rate}\n"
              "channel_count -i 1\nsample_n_bytes -i 2\n"
              f"sample_count -i {len(pcm)}\nsample_byte_format -s2 10\n"
              "sample_coding -s3 pcm\nend_head\n").encode("ascii")
    with open(path, "wb") as f:
        f.write(header + b" " * (1024 - len(header)) + pcm.tobytes())
    return str(path)


@pytest.fixture(scope="module")
def audio_inputs(tmp_path_factory):
    """A .wav, a big-endian PCM .sph, a 1-D .npy and the committed
    embedded-shorten .sph: 0.75-2 s of 8 kHz audio, under the tiny
    experiment's 250-frame cap."""
    root = tmp_path_factory.mktemp("torch_cli_audio")
    rng = np.random.RandomState(5)
    npy = str(root / "c.npy")
    np.save(npy, (rng.randn(16000) * 0.1).astype(np.float32))
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "shorten", "fisher_like.sph")
    return [_write_wav(root / "a.wav", rng.randn(12000) * 0.1),
            _write_sph(str(root / "b.sph"), rng.randn(8000) * 0.1),
            npy, fixture]


@pytest.mark.parametrize("cmvn", ["utt", "none", "pkl"])
@pytest.mark.parametrize("extra", [[], ["--beam", "3,3"]],
                         ids=["greedy", "beam"])
def test_cli_audio_matches_ast_tpu(experiment, audio_inputs, tmp_path,
                                   cmvn, extra):
    """.wav, .sph (PCM and embedded-shorten) and 1-D .npy audio through
    each package's MFCC front-end and CMVN, then decoding: the same
    lines."""
    exp, _ = experiment
    if cmvn == "pkl":
        rng = np.random.RandomState(2)
        stats = {spk: {"mean": rng.randn(13).astype(np.float32),
                       "std": (1 + rng.rand(13)).astype(np.float32)}
                 for spk in ("s1", "s2", "fisher_like")}
        path = tmp_path / "cmvn.stats"
        with open(path, "wb") as f:
            pickle.dump({"utt2spk": {"a": "s1", "b": "s2", "c": "s1"},
                         "stats": stats}, f)
        cmvn = str(path)
    argv = ["-m", exp, "--batch", "2", "--cmvn", cmvn] + extra
    ref = jax_infer.main(argv + audio_inputs)
    got = infer.main(argv + ["--device", "cpu"] + audio_inputs)
    assert list(got) == ["a", "b", "c", "fisher_like"]
    assert got == ref
    assert any(got.values())


def test_cli_audio_cmvn_speaker_missing(experiment, audio_inputs,
                                        tmp_path):
    exp, _ = experiment
    path = tmp_path / "cmvn.stats"
    with open(path, "wb") as f:
        pickle.dump({"utt2spk": {}, "stats": {}}, f)
    argv = ["-m", exp, "--cmvn", str(path), audio_inputs[0]]
    with pytest.raises(KeyError) as got:
        infer.main(argv + ["--device", "cpu"])
    with pytest.raises(KeyError) as want:
        jax_infer.main(argv)
    assert got.value.args == want.value.args


def test_cli_rejects_audio(experiment, tmp_path):
    """Audio the front-end cannot take: another sample rate (ast_tpu's
    message), a 3-D .npy, a file that is no WAV."""
    exp, _ = experiment
    wrong_rate = _write_wav(tmp_path / "r.wav", np.zeros(8000), rate=16000)
    with pytest.raises(ValueError, match="sample rate 16000") as got:
        infer.main(["-m", exp, "--device", "cpu", wrong_rate])
    with pytest.raises(ValueError) as want:
        jax_infer.main(["-m", exp, wrong_rate])
    assert str(got.value) == str(want.value)
    cube = tmp_path / "a.npy"
    np.save(cube, np.zeros((2, 3, 4), np.float32))
    with pytest.raises(ValueError, match="expected 1-D audio or 2-D"):
        infer.main(["-m", exp, "--device", "cpu", str(cube)])
    wav = tmp_path / "a.wav"
    wav.write_bytes(b"RIFF")
    with pytest.raises((wave.Error, EOFError)):
        infer.main(["-m", exp, "--device", "cpu", str(wav)])
