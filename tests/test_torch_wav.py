"""The port's audio readers (ast_tpu_torch.data.wav_loader) and shorten
decoder (ast_tpu_torch.data.shorten) against ast_tpu's, bit for bit.

WAV at 8 / 16 / 24 / 32 bits, mono and stereo, with and without a
channel; SPHERE PCM of either endianness, 2-channel mu-law and the
committed embedded-shorten goldens; the shorten decoder on streams of
ast_tpu's encoder for every predictor and option case of
tests/test_shorten.py, and on its error cases.
"""

import os
import wave

import numpy as np
import pytest

from ast_tpu.data import shorten as jax_sh
from ast_tpu.data import wav_loader as jax_wav
from ast_tpu_torch.data import shorten as sh
from ast_tpu_torch.data import wav_loader

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "shorten")


def _write_wav(path, width, channels, n=500, rate=8000, seed=0):
    rng = np.random.RandomState(seed)
    raw = rng.randint(0, 256, n * width * channels).astype(np.uint8)
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(raw.tobytes())
    return path


def _write_sph(path, data_bytes, coding="pcm", n_bytes=2, channels=1,
               n_samples=0, byte_format="01", rate=8000):
    header = (
        "NIST_1A\n   1024\n"
        f"sample_rate -i {rate}\n"
        f"channel_count -i {channels}\n"
        f"sample_n_bytes -i {n_bytes}\n"
        f"sample_count -i {n_samples}\n"
        f"sample_byte_format -s{len(byte_format)} {byte_format}\n"
        f"sample_coding -s{len(coding)} {coding}\n"
        "end_head\n"
    ).encode("ascii")
    with open(path, "wb") as f:
        f.write(header + b" " * (1024 - len(header)))
        f.write(data_bytes)
    return path


def _same(path, reader, jax_reader, **kw):
    got, rate = reader(path, with_rate=True, **kw)
    want, want_rate = jax_reader(path, with_rate=True, **kw)
    assert rate == want_rate
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(reader(path, **kw), want)
    return got


@pytest.mark.parametrize("width", [1, 2, 3, 4])
@pytest.mark.parametrize("channels,channel", [(1, None), (2, None), (2, 1)],
                         ids=["mono", "stereo-mean", "stereo-ch1"])
def test_read_wav_bit_equal(tmp_path, width, channels, channel):
    path = _write_wav(str(tmp_path / "a.wav"), width, channels, seed=width)
    x = _same(path, wav_loader.read_wav, jax_wav.read_wav, channel=channel)
    assert x.shape == (500,)
    assert np.abs(x).max() <= 1.0


def test_read_wav_refuses_a_missing_channel(tmp_path):
    path = _write_wav(str(tmp_path / "a.wav"), 2, 2)
    with pytest.raises(ValueError) as got:
        wav_loader.read_wav(path, channel=2)
    with pytest.raises(ValueError) as want:
        jax_wav.read_wav(path, channel=2)
    assert str(got.value) == str(want.value)
    assert "channel 2" in str(got.value)


@pytest.mark.parametrize("byte_format,dtype", [("01", "<i2"), ("10", ">i2")],
                         ids=["little", "big"])
def test_read_sph_pcm_bit_equal(tmp_path, byte_format, dtype):
    x = (np.sin(np.linspace(0, 60, 500)) * 25000).astype(np.int16)
    path = _write_sph(str(tmp_path / "p.sph"), x.astype(dtype).tobytes(),
                      byte_format=byte_format, n_samples=len(x), rate=16000)
    got = _same(path, wav_loader.read_sph, jax_wav.read_sph)
    np.testing.assert_array_equal(got, x.astype(np.float32) / 32768.0)


def test_read_sph_ulaw_two_channel_bit_equal(tmp_path):
    codes = np.random.RandomState(3).randint(0, 256, 800).astype(np.uint8)
    path = _write_sph(str(tmp_path / "u.sph"), codes.tobytes(),
                      coding="ulaw", n_bytes=1, channels=2, n_samples=400)
    for channel in (None, 0, 1):
        _same(path, wav_loader.read_sph, jax_wav.read_sph, channel=channel)
    np.testing.assert_array_equal(wav_loader._ulaw_to_linear(codes),
                                  jax_wav._ulaw_to_linear(codes))
    assert wav_loader._ulaw_to_linear(np.array([0x00]))[0] == -32124
    with pytest.raises(ValueError, match="channel_count 2"):
        wav_loader.read_sph(path, channel=2)


@pytest.mark.parametrize("name", ["fisher_like", "pcm_like"])
def test_read_sph_embedded_shorten_goldens(name):
    path = os.path.join(FIX, f"{name}.sph")
    exp = np.load(os.path.join(FIX, f"{name}_expected.npy"))
    for ch in (0, 1):
        x = _same(path, wav_loader.read_sph, jax_wav.read_sph, channel=ch)
        np.testing.assert_array_equal(x, exp[:, ch].astype(np.float32))
    x = _same(path, wav_loader.read_sph, jax_wav.read_sph)
    np.testing.assert_array_equal(x, exp.mean(axis=1).astype(np.float32))


@pytest.mark.parametrize("data,match", [
    (b"ABCD" + b"\x00" * 60, "NIST"),
    (None, "shorten"),
])
def test_read_sph_errors_match(tmp_path, data, match):
    path = str(tmp_path / "bad.sph")
    if data is None:       # embedded shorten whose stream is garbage
        _write_sph(path, b"\x00" * 64, coding="pcm,embedded-shorten-v2.00")
    else:
        with open(path, "wb") as f:
            f.write(data)
    with pytest.raises(ValueError, match=match) as got:
        wav_loader.read_sph(path)
    with pytest.raises(ValueError) as want:
        jax_wav.read_sph(path)
    assert str(got.value) == str(want.value)


def _sig(n=4000, seed=0, scale=2000.0):
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    x = scale * np.sin(t / 25.0) + rng.randint(-100, 100, n)
    return np.stack([x, np.roll(x, 3)], axis=1).astype(np.int64)


def _decode_same(data, **kw):
    got = sh.decode(data, **kw)
    want = jax_sh.decode(data, _force_python=True, **kw)
    assert (got.ftype, got.nchan, got.verbatim) == (
        want.ftype, want.nchan, want.verbatim)
    np.testing.assert_array_equal(got.samples, want.samples)
    assert sh.samples_to_bytes(got) == jax_sh.samples_to_bytes(want)
    return got


@pytest.mark.parametrize("kw", [
    {"use_qlpc": True, "predictors": (jax_sh.FN_QLPC,)},
    {"predictors": (jax_sh.FN_DIFF0,)},
    {"predictors": (jax_sh.FN_DIFF1,)},
    {"predictors": (jax_sh.FN_DIFF2,)},
    {"predictors": (jax_sh.FN_DIFF3,)},
    {"nmean": 0}, {"nmean": 1}, {"nmean": 4},
    {"blocksize": 64}, {"blocksize": 100},
    {"bitshift": 2},
    {"version": 1},
])
def test_shorten_decode_every_predictor_and_option(kw):
    x = _sig()
    if kw.get("bitshift"):
        x &= ~3
    st = _decode_same(jax_sh.encode(x, jax_sh.TYPE_S16LH, **kw))
    np.testing.assert_array_equal(st.samples, x)


@pytest.mark.parametrize("ftype", [
    jax_sh.TYPE_S16LH, jax_sh.TYPE_S16HL, jax_sh.TYPE_U16LH,
    jax_sh.TYPE_U16HL, jax_sh.TYPE_S8, jax_sh.TYPE_U8, jax_sh.TYPE_AU1,
    jax_sh.TYPE_AU2, jax_sh.TYPE_ULAW, jax_sh.TYPE_AU3, jax_sh.TYPE_ALAW])
def test_shorten_decode_every_sample_type(ftype):
    x = _sig()
    codes = jax_sh._nearest_code(x.reshape(-1), jax_sh._ULAW_EXPAND)
    internal = {
        jax_sh.TYPE_U16LH: x + 0x8000, jax_sh.TYPE_U16HL: x + 0x8000,
        jax_sh.TYPE_U8: (x % 200) + 28,
        jax_sh.TYPE_S8: np.clip(x // 32, -128, 127),
        jax_sh.TYPE_AU1: jax_sh._SIGNMAG_IN[codes].reshape(x.shape),
        jax_sh.TYPE_AU2: jax_sh._SIGNMAG_IN[codes].reshape(x.shape),
        jax_sh.TYPE_AU3: jax_sh._SIGNMAG_IN[codes].reshape(x.shape),
        jax_sh.TYPE_ULAW: jax_sh._ULAW_EXPAND[codes].reshape(x.shape),
        jax_sh.TYPE_ALAW: jax_sh._ALAW_EXPAND[codes].reshape(x.shape),
    }.get(ftype, x)
    _decode_same(jax_sh.encode(internal, ftype))


def test_shorten_zero_blocks_verbatim_partial_tail_and_early_stop():
    x = np.zeros((700, 1), dtype=np.int64)  # not a blocksize multiple
    x[300:400] = 1234
    st = _decode_same(jax_sh.encode(x, jax_sh.TYPE_S16LH,
                                    verbatim=b"HDRxyz", nmean=0))
    assert st.verbatim == b"HDRxyz"
    y = _sig(8000)
    st = _decode_same(jax_sh.encode(y, jax_sh.TYPE_S16LH), max_samples=1000)
    assert 1000 <= len(st.samples) < 8000


def test_shorten_raw_golden():
    with open(os.path.join(FIX, "raw_s16.shn"), "rb") as f:
        st = _decode_same(f.read())
    np.testing.assert_array_equal(
        st.samples, np.load(os.path.join(FIX, "raw_s16_expected.npy")))


@pytest.mark.parametrize("case", ["magic", "version", "truncated"])
def test_shorten_errors_match(case):
    x = jax_sh.encode(_sig(1000), jax_sh.TYPE_S16LH)
    data = {"magic": b"nope" + b"\x00" * 100,
            "version": jax_sh.MAGIC + bytes([9]) + b"\x00" * 100,
            "truncated": x[: len(x) // 2]}[case]
    with pytest.raises(ValueError, match=case) as got:
        sh.decode(data)
    with pytest.raises(ValueError) as want:
        jax_sh.decode(data, _force_python=True)
    assert str(got.value) == str(want.value)
