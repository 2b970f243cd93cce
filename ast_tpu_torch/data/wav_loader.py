"""Audio readers: PCM WAV and NIST SPHERE files -> float32 mono samples.

The port's copies of ``read_wav``, ``_ulaw_to_linear``, ``read_sph`` and
``samples_for_frames`` of ``ast_tpu/data/wav_loader.py``, NumPy and the
standard library only, bit-equal to the originals.  SPHERE's
embedded-shorten coding (the real LDC Fisher tapes) decodes through the
port's own :mod:`ast_tpu_torch.data.shorten`.
"""

import wave

import numpy as np

from ast_tpu_torch.data import shorten as _shorten


def read_wav(path, channel=None, with_rate=False):
    """PCM wav -> float32 mono in [-1, 1] (stdlib only).

    ``channel``: 0-based channel to keep; None averages channels.
    ``with_rate=True`` additionally returns the file's sample rate."""
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        channels = w.getnchannels()
        rate = w.getframerate()
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        # 24-bit PCM: sign-extend 3-byte little-endian samples via i32
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        i32 = (b[:, 0].astype(np.int32)
               | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        i32 = (i32 << 8) >> 8  # sign extend bit 23
        x = i32.astype(np.float32) / 8388608.0
    elif width == 1:
        # wav 8-bit is unsigned
        x = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
        x = (x - 128.0) / 128.0
    else:
        raise ValueError(
            f"{path}: unsupported wav sample width {width} bytes")
    if channel is not None and channel >= channels:
        raise ValueError(
            f"{path}: channel {channel} requested but file has "
            f"{channels} channel(s)")
    if channels > 1:
        x = x.reshape(-1, channels)
        x = x[:, channel] if channel is not None else x.mean(axis=1)
    x = np.ascontiguousarray(x, dtype=np.float32)
    return (x, rate) if with_rate else x


def _ulaw_to_linear(u8):
    """G.711 mu-law bytes -> int16-range PCM (vectorized)."""
    u = np.invert(np.asarray(u8, dtype=np.uint8))
    sign = (u & 0x80) != 0
    exponent = (u >> 4) & 0x07
    mantissa = (u & 0x0F).astype(np.int32)
    magnitude = (((mantissa << 3) + 0x84) << exponent) - 0x84
    return np.where(sign, -magnitude, magnitude).astype(np.int16)


def read_sph(path, channel=None, with_rate=False):
    """NIST SPHERE audio -> float32 mono in [-1, 1] (stdlib only).

    Supported codings: uncompressed PCM (1/2-byte, either endianness),
    mu-law, and shorten v2 compression ("embedded-shorten", the coding
    of the LDC Fisher tapes; decoded by :mod:`ast_tpu_torch.data.shorten`,
    no sph2pipe needed).

    ``channel``: 0-based channel to keep (Fisher is 2-channel, one per
    speaker); None averages channels.  ``with_rate=True`` additionally
    returns the header's sample_rate.
    """
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"NIST_1A"):
            raise ValueError(f"{path}: not a NIST SPHERE file")
        header_size = int(f.readline().strip())
        f.seek(0)
        header = f.read(header_size).decode("ascii", errors="replace")
        f.seek(header_size)
        raw = f.read()

    fields = {}
    for line in header.splitlines()[2:]:
        line = line.strip()
        if line == "end_head":
            break
        parts = line.split(None, 2)
        if len(parts) == 3:
            name, typ, value = parts
            fields[name] = int(value) if typ == "-i" else value

    coding = str(fields.get("sample_coding", "pcm")).lower()
    n_bytes = int(fields.get("sample_n_bytes", 2))
    channels = int(fields.get("channel_count", 1))
    byte_format = str(fields.get("sample_byte_format", "01"))
    n_samples = int(fields.get("sample_count", 0))

    shorten_ftype = None
    if "shorten" in coding:
        # embedded-shorten: the waveform section is a shorten v2
        # stream; decode it to the original sample bytes, then fall
        # through to the ulaw/pcm branches below (the header's
        # sample_coding prefix describes the DECODED bytes)
        stream = _shorten.decode(raw)
        shorten_ftype = stream.ftype
        raw = _shorten.samples_to_bytes(stream)
    if coding.startswith("ulaw") or coding.startswith("mu-law"):
        x = _ulaw_to_linear(np.frombuffer(raw, dtype=np.uint8))
        x = x.astype(np.float32) / 32768.0
    elif coding.startswith("pcm"):
        if n_bytes == 2:
            dtype = ">i2" if byte_format == "10" else "<i2"
            # the stream's own type is authoritative for endianness
            if shorten_ftype == _shorten.TYPE_S16HL:
                dtype = ">i2"
            elif shorten_ftype == _shorten.TYPE_S16LH:
                dtype = "<i2"
            x = np.frombuffer(raw, dtype=dtype).astype(np.float32) / 32768.0
        elif n_bytes == 1:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                 - 128.0) / 128.0
        else:
            raise ValueError(
                f"{path}: unsupported pcm sample_n_bytes={n_bytes}")
    else:
        raise ValueError(f"{path}: unsupported sample_coding={coding!r}")

    if n_samples:
        x = x[: n_samples * channels]
    if channel is not None and channel >= channels:
        raise ValueError(
            f"{path}: channel {channel} requested but header says "
            f"channel_count {channels}")
    if channels > 1:
        x = x.reshape(-1, channels)
        x = x[:, channel] if channel is not None else x.mean(axis=1)
    x = np.ascontiguousarray(x, dtype=np.float32)
    if with_rate:
        return x, int(fields.get("sample_rate", 8000))
    return x


def samples_for_frames(cfg, t_frames):
    """Audio samples needed to produce exactly ``t_frames`` frames of
    ``cfg`` (an ``ops.fbank.MfccConfig``)."""
    if t_frames <= 0:
        return 0
    return (t_frames - 1) * cfg.shift + cfg.frame_len
