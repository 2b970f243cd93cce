"""The port's MFCC / log-mel front-end and CMVN (ast_tpu_torch.ops.fbank)
against ast_tpu.ops.fbank on the CPU.

Seeded audio of 0, 199 (one sample short of a frame), 200 (one frame),
4,000 and 96,000 samples, and a batch of 3: MFCC and log-mel within 1e-3
absolute of ast_tpu's; the Kaldi goldens at ast_tpu's own 0.03; the
constant bases, frame counts, sample counts and CMVN bit-equal.
"""

import os

import numpy as np
import pytest
import torch

from ast_tpu.data import wav_loader as jax_wav
from ast_tpu.ops import fbank as jax_fbank
from ast_tpu_torch.data import wav_loader
from ast_tpu_torch.ops import fbank

TOL = 1e-3
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "kaldi_mfcc.npz")
LENGTHS = (0, 199, 200, 4000, 96000)


def _audio(shape, seed=0):
    return (np.random.RandomState(seed).randn(*shape) * 0.3).astype(
        np.float32)


@pytest.fixture(scope="module")
def extractors():
    return fbank.MfccExtractor(), jax_fbank.MfccExtractor()


@pytest.mark.parametrize("shape", [(n,) for n in LENGTHS] + [(3, 4000)],
                         ids=[str(n) for n in LENGTHS] + ["batch3"])
def test_mfcc_and_logmel_match_ast_tpu(extractors, shape):
    port, ref = extractors
    audio = _audio(shape)
    for name in ("__call__", "logmel"):
        got = getattr(port, name)(audio)
        want = np.asarray(getattr(ref, name)(audio))
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        assert tuple(got.shape) == want.shape
        if want.size:
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    n_fr = fbank.num_frames(port.cfg, shape[-1])
    assert got.shape[-2] == n_fr


def test_mfcc_takes_a_tensor(extractors):
    port, _ = extractors
    audio = _audio((2, 4000), seed=1)
    assert torch.equal(port(torch.from_numpy(audio)), port(audio))


@pytest.mark.parametrize(
    "name", ["tones", "noise", "chirp", "silence_then_tone"])
def test_mfcc_matches_kaldi_golden(name):
    z = np.load(FIXTURES)
    got = fbank.MfccExtractor()(z[f"audio_{name}"][None])[0].numpy()
    np.testing.assert_allclose(got, z[f"mfcc_{name}"], rtol=0, atol=0.03)


@pytest.mark.parametrize("kw", [{}, {"window": "hamming"},
                                {"window": "hanning"}, {"window": "rect"},
                                {"cepstral_lifter": 0.0},
                                {"sample_rate": 16000, "n_mels": 40}],
                         ids=["default", "hamming", "hanning", "rect",
                              "no-lifter", "16k"])
def test_bases_bit_equal(kw):
    port, ref = fbank.MfccConfig(**kw), jax_fbank.MfccConfig(**kw)
    assert vars(port) == vars(ref)
    for name in ("_window_fn", "_mel_filterbank", "_dct_matrix"):
        np.testing.assert_array_equal(getattr(fbank, name)(port),
                                      getattr(jax_fbank, name)(ref))
    for a, b in zip(fbank._dft_bases(port), jax_fbank._dft_bases(ref)):
        np.testing.assert_array_equal(a, b)


def test_frame_and_sample_counts_bit_equal():
    port, ref = fbank.MfccConfig(), jax_fbank.MfccConfig()
    for n in list(LENGTHS) + [1, 279, 280, 281, 8000]:
        assert fbank.num_frames(port, n) == jax_fbank.num_frames(ref, n)
    for t in (-1, 0, 1, 2, 98, 1680):
        assert (wav_loader.samples_for_frames(port, t)
                == jax_wav.samples_for_frames(ref, t))
        if t > 0:
            assert fbank.num_frames(
                port, wav_loader.samples_for_frames(port, t)) == t


def test_cmvn_bit_equal():
    rng = np.random.RandomState(0)
    arrays = [(rng.randn(n, 13) * 3 + 5).astype(np.float32)
              for n in (50, 1, 0, 17)]
    got, want = fbank.compute_cmvn_stats(arrays), \
        jax_fbank.compute_cmvn_stats(arrays)
    assert got["count"] == want["count"] == 68
    for k in ("mean", "std"):
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    for norm_vars in (True, False):
        for a in arrays:
            np.testing.assert_array_equal(
                fbank.apply_cmvn(a, got, norm_vars),
                np.asarray(jax_fbank.apply_cmvn(a, want, norm_vars)))


@pytest.mark.parametrize("arrays", [[], [np.zeros((0, 13))]],
                         ids=["empty-list", "zero-rows"])
def test_cmvn_stats_refuse_no_frames(arrays):
    with pytest.raises(ValueError, match="no frames") as got:
        fbank.compute_cmvn_stats(arrays)
    with pytest.raises(ValueError) as want:
        jax_fbank.compute_cmvn_stats(arrays)
    assert str(got.value) == str(want.value)
