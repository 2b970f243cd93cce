"""Shorten v2 (embedded-SPHERE) lossless audio codec.

The port's copy of ``ast_tpu/data/shorten.py``: the LDC
Fisher Spanish tapes are SPHERE files whose waveform section is
compressed with *shorten v2* ("sample_coding: ulaw,embedded-shorten-v2"),
which the reference pipeline decodes with the external sph2pipe binary
(reference: linking_files/fisher/kaldi/local/fsp_data_prep.sh:37-41).
It decodes the whole bitstream -- Rice-coded residuals, fixed linear
predictors DIFF0-3, quantized LPC, block mean offsets, bitshift,
verbatim chunks -- and serializes the samples back to the file's bytes;
``decode`` runs the port's native C++ decoder
(:mod:`ast_tpu_torch.native`) and keeps this Python one as its
reference (``_force_python=True``).  ``encode`` writes such streams
(test tapes; byte-equal to ``ast_tpu``'s encoder).

Format (Robinson 1994, CUED/F-INFENG/TR.156; shorten-2.x/3.x stream):

* magic ``ajkg`` + one version byte; all further data is a bitstream
  read MSB-first (the original packs 32-bit big-endian words; byte
  order is identical when reading MSB-first byte-by-byte, with the
  stream zero-padded to a word boundary).
* ``uvar(k)``: unary quotient (N zero bits then a one bit) followed by
  k literal LSBs -> (N << k) | low.  ``var(k)``: uvar(k+1) with the
  LSB as sign: v = (u >> 1) ^ -(u & 1).  ``ulong``: k = uvar(2), then
  uvar(k).
* header (v2: every uint is a ``ulong``): file type, channel count,
  blocksize, maxnlpc, nmean, nskip (+ nskip literal bytes as uvar(7)).
* then a command stream of uvar(2)-coded function codes:
  DIFF0..3 / QLPC / ZERO decode one channel block (channels cycle in
  order); BLOCKSIZE / BITSHIFT change state; VERBATIM passes literal
  bytes through; QUIT ends the stream.
* a channel block: residual Rice parameter ``resn = uvar(3)`` (absent
  for ZERO), per-sample residuals ``var(resn)``, predictor:
    DIFF0 s[i] = e + coffset        DIFF1 s[i] = e + s[i-1]
    DIFF2 s[i] = e + 2 s[i-1] - s[i-2]
    DIFF3 s[i] = e + 3 (s[i-1] - s[i-2]) + s[i-3]
    QLPC  order = uvar(2), coeffs var(5); history is de-offset, then
          s[i] = e + ((2**5 + sum_j q_j s[i-1-j]) >> 5), re-offset
  where ``coffset`` is the rounded mean of the last ``nmean`` block
  means (v2: +nmean/2 before the divide, then a rounded shift down by
  ``bitshift``); after decoding, the block mean (+blocksize/2, v2) is
  pushed onto the offset history <<bitshift, and samples are shifted
  left by ``bitshift``.

Sample types: the linear types (U8/S8/S16HL/S16LH/U16HL/U16LH) follow
the spec exactly; the ulaw/alaw family (AU1/AU2/ULAW/AU3/ALAW) follows
the shorten paper's description (sign-magnitude code <-> monotone
integer bijections, G.711 expansion for ULAW/ALAW).
"""

import numpy as np

MAGIC = b"ajkg"

# file types (shorten.h)
TYPE_AU1 = 0      # original lossless ulaw
TYPE_S8 = 1
TYPE_U8 = 2
TYPE_S16HL = 3    # big-endian signed 16
TYPE_U16HL = 4
TYPE_S16LH = 5    # little-endian signed 16
TYPE_U16LH = 6
TYPE_ULAW = 7     # ulaw via linear expansion
TYPE_AU2 = 8      # lossless ulaw with distinct zero mapping
TYPE_AU3 = 9      # lossless alaw
TYPE_ALAW = 10

TYPE_NAMES = {
    TYPE_AU1: "au1", TYPE_S8: "s8", TYPE_U8: "u8", TYPE_S16HL: "s16hl",
    TYPE_U16HL: "u16hl", TYPE_S16LH: "s16lh", TYPE_U16LH: "u16lh",
    TYPE_ULAW: "ulaw", TYPE_AU2: "au2", TYPE_AU3: "au3",
    TYPE_ALAW: "alaw",
}

# function codes
FN_DIFF0, FN_DIFF1, FN_DIFF2, FN_DIFF3 = 0, 1, 2, 3
FN_QUIT, FN_BLOCKSIZE, FN_BITSHIFT, FN_QLPC, FN_ZERO, FN_VERBATIM = (
    4, 5, 6, 7, 8, 9)

# fixed bit widths
FNSIZE = 2
ULONGSIZE = 2
ENERGYSIZE = 3
BITSHIFTSIZE = 2
LPCQSIZE = 2
LPCQUANT = 5
XBYTESIZE = 7
VERBATIM_CKSIZE_SIZE = 5
VERBATIM_BYTE_SIZE = 8
V2LPC_QOFFSET = 1 << LPCQUANT   # v2 rounding offset inside QLPC sums
DEFAULT_BLOCK_SIZE = 256
NWRAP = 3

# ---------------------------------------------------------------------------
# ulaw / alaw maps (bijections between the 256 codes and integers)
# ---------------------------------------------------------------------------

def _ulaw_expand_table():
    """G.711 mu-law byte -> 16-bit-range linear (matches
    wav_loader._ulaw_to_linear)."""
    u = np.invert(np.arange(256, dtype=np.uint8))
    sign = (u & 0x80) != 0
    exponent = (u >> 4) & 0x07
    mantissa = (u & 0x0F).astype(np.int64)
    mag = (((mantissa << 3) + 0x84) << exponent) - 0x84
    return np.where(sign, -mag, mag).astype(np.int64)


def _alaw_expand_table():
    """G.711 A-law byte -> 16-bit-range linear."""
    a = np.arange(256, dtype=np.uint8) ^ 0x55
    sign = (a & 0x80) != 0
    exponent = (a >> 4) & 0x07
    mantissa = (a & 0x0F).astype(np.int64)
    mag = np.where(exponent == 0, (mantissa << 4) + 8,
                   ((mantissa << 4) + 0x108) << (exponent - 1))
    return np.where(sign, -mag, mag).astype(np.int64)


def _sign_mag_inward_table():
    """AU1/AU3-style monotone map: 8-bit sign-magnitude code ->
    integer in [-128, 127] ordered by signed amplitude.  Positive ulaw
    codes 0xff..0x80 -> 0..127, negative 0x7f..0x00 -> -1..-128."""
    b = np.arange(256)
    u = b ^ 0xFF
    mag = (u & 0x7F).astype(np.int64)
    return np.where((u & 0x80) != 0, -mag - 1, mag)


_ULAW_EXPAND = _ulaw_expand_table()
_ALAW_EXPAND = _alaw_expand_table()
_SIGNMAG_IN = _sign_mag_inward_table()


# ---------------------------------------------------------------------------
# bit IO
# ---------------------------------------------------------------------------

class _BitReader:
    """MSB-first bit reader over bytes.

    The positions of all 1-bits are indexed once up front
    (``self.ones``), so unary scans are a searchsorted instead of a
    rescan of the remaining stream — the naive per-call flatnonzero
    made whole-stream decode quadratic.
    """

    __slots__ = ("bits", "pos", "n", "ones")

    def __init__(self, data):
        self.bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
        self.pos = 0
        self.n = len(self.bits)
        self.ones = np.flatnonzero(self.bits)

    def uvar(self, k):
        bits = self.bits
        pos = self.pos
        # unary: count zero bits until a one
        j = np.searchsorted(self.ones, pos, side="left")
        if j >= len(self.ones):
            raise ValueError("shorten: bitstream truncated (unary)")
        t = int(self.ones[j])
        q = t - pos
        pos = t + 1
        v = q
        if k:
            if pos + k > self.n:
                raise ValueError("shorten: bitstream truncated (low bits)")
            low = 0
            for b in bits[pos:pos + k]:
                low = (low << 1) | int(b)
            v = (q << k) | low
            pos += k
        self.pos = pos
        return v

    def var(self, k):
        u = self.uvar(k + 1)
        return (u >> 1) ^ -(u & 1)

    def ulong(self):
        return self.uvar(self.uvar(ULONGSIZE))

    def uvar_block(self, k, n):
        """n consecutive var(k) residuals, vectorized.

        Finds the n unary terminators with one flatnonzero over the
        remaining stream, then gathers each code's k+1 low bits with a
        strided index matrix — no per-sample Python loop.
        """
        k = k + 1  # signed codes carry the sign LSB
        bits = self.bits
        ones = self.ones
        n_ones = len(ones)
        # terminator of code i is the first 1-bit at/after its start;
        # each code then consumes k low bits (which may contain 1-bits,
        # so terminators are a data-dependent walk over `ones`, resolved
        # with one searchsorted per code on the global index)
        q = np.empty(n, dtype=np.int64)
        ends = np.empty(n, dtype=np.int64)
        start = self.pos
        ji = int(np.searchsorted(ones, start, side="left"))
        for i in range(n):
            if ji >= n_ones:
                raise ValueError("shorten: bitstream truncated (block)")
            t = int(ones[ji])
            q[i] = t - start
            start = t + 1 + k
            ends[i] = start
            # skip the 1-bits consumed as this code's low bits
            ji = int(np.searchsorted(ones, start, side="left"))
        if ends[-1] > self.n:
            raise ValueError("shorten: bitstream truncated (block)")
        if k:
            idx = ends[:, None] - k + np.arange(k)[None, :]
            low = bits[idx].astype(np.int64)
            weights = 1 << np.arange(k - 1, -1, -1, dtype=np.int64)
            u = (q << k) | (low * weights).sum(axis=1)
        else:
            u = q
        self.pos = int(ends[-1])
        return (u >> 1) ^ -(u & 1)


class _BitWriter:
    __slots__ = ("chunks",)

    def __init__(self):
        self.chunks = []

    def uvar(self, v, k):
        q = v >> k
        self.chunks.append(np.zeros(q, dtype=np.uint8))
        one = np.ones(1, dtype=np.uint8)
        self.chunks.append(one)
        if k:
            low = np.array([(v >> (k - 1 - i)) & 1 for i in range(k)],
                           dtype=np.uint8)
            self.chunks.append(low)

    def var(self, v, k):
        # sign in the LSB: u = (v >= 0) ? v << 1 : ((-v - 1) << 1) | 1
        u = (v << 1) if v >= 0 else (((-v - 1) << 1) | 1)
        self.uvar(u, k + 1)

    def vars(self, e, k):
        """``var(v, k)`` for every v of the int array ``e`` at once: the
        same bits, assembled without a Python loop over samples."""
        e = np.asarray(e, dtype=np.int64)
        if not len(e):
            return
        u = np.where(e >= 0, e << 1, ((-e - 1) << 1) | 1)
        n = k + 1
        q = u >> n
        ends = np.cumsum(q + 1 + n)
        starts = ends - (q + 1 + n)
        bits = np.zeros(int(ends[-1]), dtype=np.uint8)
        bits[starts + q] = 1                  # the unary part's one
        low = (u[:, None] >> np.arange(n - 1, -1, -1)[None, :]) & 1
        pos = (starts + q + 1)[:, None] + np.arange(n)[None, :]
        bits[pos.ravel()] = low.ravel()
        self.chunks.append(bits)

    def ulong(self, v):
        k = max(int(v).bit_length() - 3, 0) if v else 0
        # any k decodes; pick one that keeps the unary part short
        while (v >> k) > 31:
            k += 1
        self.uvar(k, ULONGSIZE)
        self.uvar(v, k)

    def tobytes(self):
        bits = (np.concatenate(self.chunks) if self.chunks
                else np.zeros(0, dtype=np.uint8))
        # pad to a 32-bit word boundary like the original's word IO
        pad = (-len(bits)) % 32
        if pad:
            bits = np.concatenate([bits, np.zeros(pad, dtype=np.uint8)])
        return np.packbits(bits).tobytes()


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _cdiv(a, b):
    """C-style truncating division (toward zero) — the original's
    ``sum / nmean`` etc. are C integer divides, and block means go
    negative on zero-centered audio, where Python's floor divide
    differs by one (caught by the libavcodec cross-check)."""
    q = abs(a) // b
    return -q if a < 0 else q


def _rounded_shift_down(x, n):
    return x if n == 0 else ((x >> (n - 1)) + 1) >> 1


class ShortenStream:
    """Decoded shorten stream: interleaved samples + passthrough bytes."""

    def __init__(self, ftype, nchan, samples, verbatim):
        self.ftype = ftype
        self.nchan = nchan
        self.samples = samples      # (n, nchan) int32 internal values
        self.verbatim = verbatim    # bytes (in stream order)


def decode(data, max_samples=None, _force_python=False):
    """Decode a shorten v2 (or v1) stream.

    ``data``: bytes starting at the ``ajkg`` magic.  Returns
    :class:`ShortenStream` with internal (pre-serialization) sample
    values.  ``max_samples``: optional early stop after that many
    per-channel samples (segment reads don't pay for the whole tape).

    Runs the native decoder (``ast_tpu_torch/native/shorten_dec.cc``);
    this Python path (``_force_python=True``) is its reference, held
    equal to it on every predictor and option case, the path of a
    machine without ``g++``, and the one that reports a malformed
    stream.
    """
    if not _force_python:
        from ast_tpu_torch import native
        try:
            out = native.shn_decode(data, max_samples)
        except ValueError:
            # a malformed stream: the Python decoder below raises with
            # the reference's message
            out = None
        if out is not None:
            ftype, samples, verbatim = out
            return ShortenStream(ftype, samples.shape[1],
                                 samples.astype(np.int64), verbatim)
    if data[:4] != MAGIC:
        raise ValueError("shorten: bad magic (expected 'ajkg')")
    version = data[4]
    if version not in (1, 2):
        raise ValueError(f"shorten: unsupported version {version}")
    r = _BitReader(data[5:])

    ftype = r.ulong()
    nchan = r.ulong()
    blocksize = r.ulong()
    maxnlpc = r.ulong()
    nmean = r.ulong()
    nskip = r.ulong()
    skipped = bytes(r.uvar(XBYTESIZE) for _ in range(nskip))

    if ftype not in TYPE_NAMES:
        raise ValueError(f"shorten: unknown file type {ftype}")

    nwrap = max(NWRAP, maxnlpc)
    # per-channel: history of nwrap samples + current block
    hist = [np.zeros(nwrap, dtype=np.int64) for _ in range(nchan)]
    mean0 = 0x80 if ftype == TYPE_U8 else (
        0x8000 if ftype in (TYPE_U16HL, TYPE_U16LH) else 0)
    offset = [[mean0] * max(1, nmean) for _ in range(nchan)]
    bitshift = 0
    lpcqoffset = V2LPC_QOFFSET if version > 0 else 0

    out = [[] for _ in range(nchan)]
    verbatim = [skipped] if skipped else []
    chan = 0
    n_done = 0

    while True:
        cmd = r.uvar(FNSIZE)
        if cmd == FN_QUIT:
            break
        if cmd == FN_BLOCKSIZE:
            blocksize = r.ulong()
            continue
        if cmd == FN_BITSHIFT:
            bitshift = r.uvar(BITSHIFTSIZE)
            continue
        if cmd == FN_VERBATIM:
            n = r.uvar(VERBATIM_CKSIZE_SIZE)
            verbatim.append(bytes(
                r.uvar(VERBATIM_BYTE_SIZE) & 0xFF for _ in range(n)))
            continue
        if cmd not in (FN_ZERO, FN_DIFF0, FN_DIFF1, FN_DIFF2, FN_DIFF3,
                       FN_QLPC):
            raise ValueError(f"shorten: unknown function code {cmd}")

        resn = 0
        if cmd != FN_ZERO:
            resn = r.uvar(ENERGYSIZE)
            if version == 0:
                resn -= 1

        if nmean == 0:
            coffset = offset[chan][0]
        else:
            s = (0 if version < 2 else nmean // 2) + sum(offset[chan])
            if version < 2:
                coffset = _cdiv(s, nmean)
            else:
                coffset = _rounded_shift_down(_cdiv(s, nmean), bitshift)

        h = hist[chan]
        buf = np.empty(blocksize, dtype=np.int64)
        if cmd == FN_ZERO:
            buf[:] = 0
        elif cmd == FN_DIFF0:
            buf[:] = r.uvar_block(resn, blocksize) + coffset
        elif cmd == FN_DIFF1:
            e = r.uvar_block(resn, blocksize)
            # s[i] = e[i] + s[i-1]  =>  prefix sum from history
            buf[:] = np.cumsum(e) + h[-1]
        elif cmd == FN_DIFF2:
            e = r.uvar_block(resn, blocksize)
            # second difference: double prefix sum
            d1 = np.cumsum(e) + (h[-1] - h[-2])      # s[i] - s[i-1]
            buf[:] = np.cumsum(d1) + h[-1]
        elif cmd == FN_DIFF3:
            e = r.uvar_block(resn, blocksize)
            prev = (int(h[-1]), int(h[-2]), int(h[-3]))
            for i in range(blocksize):
                v = (int(e[i]) + 3 * (prev[0] - prev[1]) + prev[2])
                buf[i] = v
                prev = (v, prev[0], prev[1])
        else:  # FN_QLPC
            nlpc = r.uvar(LPCQSIZE)
            qlpc = [r.var(LPCQUANT) for _ in range(nlpc)]
            e = r.uvar_block(resn, blocksize)
            prev = [int(h[-1 - j]) - coffset for j in range(nlpc)]
            for i in range(blocksize):
                acc = lpcqoffset
                for j in range(nlpc):
                    acc += qlpc[j] * prev[j]
                v = int(e[i]) + (acc >> LPCQUANT)
                buf[i] = v
                if nlpc:
                    prev = [v] + prev[:-1]
            if coffset != 0:
                buf += coffset

        if nmean > 0:
            s = (0 if version < 2 else blocksize // 2) + int(buf.sum())
            offset[chan] = offset[chan][1:] + [
                _cdiv(s, blocksize) if version < 2
                else _cdiv(s, blocksize) << bitshift]

        if nwrap:
            if blocksize >= nwrap:
                hist[chan] = buf[-nwrap:].copy()
            else:
                hist[chan] = np.concatenate([h, buf])[-nwrap:]

        if bitshift:
            buf = buf << bitshift
        out[chan].append(buf)

        if chan == nchan - 1:
            n_done += blocksize
            if max_samples is not None and n_done >= max_samples:
                break
        chan = (chan + 1) % nchan

    per_chan = [np.concatenate(c) if c else np.zeros(0, np.int64)
                for c in out]
    n = min(len(c) for c in per_chan)
    samples = np.stack([c[:n] for c in per_chan], axis=1)
    return ShortenStream(ftype, nchan, samples, b"".join(verbatim))


# ---------------------------------------------------------------------------
# sample (de)serialization: internal values <-> original file bytes
# ---------------------------------------------------------------------------

def samples_to_bytes(stream):
    """Serialize decoded internal values to the original file's sample
    bytes (interleaved, as ``shorten -x`` would write)."""
    s = stream.samples.reshape(-1)  # interleaved
    t = stream.ftype
    if t == TYPE_U8:
        return np.clip(s, 0, 255).astype(np.uint8).tobytes()
    if t == TYPE_S8:
        return np.clip(s, -128, 127).astype(np.int8).tobytes()
    if t == TYPE_S16HL:
        return np.clip(s, -32768, 32767).astype(">i2").tobytes()
    if t == TYPE_S16LH:
        return np.clip(s, -32768, 32767).astype("<i2").tobytes()
    if t == TYPE_U16HL:
        return np.clip(s, 0, 65535).astype(">u2").tobytes()
    if t == TYPE_U16LH:
        return np.clip(s, 0, 65535).astype("<u2").tobytes()
    if t in (TYPE_AU1, TYPE_AU2):
        return _signmag_to_code(s, t).tobytes()
    if t in (TYPE_AU3, TYPE_ALAW):
        return _alaw_code(s, t).tobytes()
    if t == TYPE_ULAW:
        return _ulaw_code(s).tobytes()
    raise ValueError(f"shorten: unserializable type {t}")


def _signmag_to_code(s, t):
    """Inverse of the AU1/AU2 inward map, via the sorted-value route
    (nearest value; exact for in-range streams).

    Under this table the two ulaw zeros already map to distinct
    integers (+0 -> 0, -0 -> -1), so the "zero mapping" AU2 adds over
    AU1 is inherent and the two types share one bijection here.
    """
    return _nearest_code(s, _SIGNMAG_IN).astype(np.uint8)


_SORT_CACHE = {}


def _nearest_code(v, table):
    key = id(table)
    if key not in _SORT_CACHE:
        order = np.argsort(table, kind="stable")
        _SORT_CACHE[key] = (table[order], order)
    sv, order = _SORT_CACHE[key]
    idx = np.searchsorted(sv, v)
    idx = np.clip(idx, 0, len(sv) - 1)
    lo = np.clip(idx - 1, 0, len(sv) - 1)
    pick = np.where(np.abs(sv[idx] - v) <= np.abs(v - sv[lo]), idx, lo)
    return order[pick].astype(np.uint8)


def _ulaw_code(s):
    return _nearest_code(s, _ULAW_EXPAND)


def _alaw_code(s, t):
    if t == TYPE_AU3:
        return _nearest_code(s, _SIGNMAG_IN)
    return _nearest_code(s, _ALAW_EXPAND)


def bytes_to_samples(raw, ftype, nchan):
    """Original file sample bytes -> internal values (n, nchan)."""
    if ftype == TYPE_U8:
        s = np.frombuffer(raw, dtype=np.uint8).astype(np.int64)
    elif ftype == TYPE_S8:
        s = np.frombuffer(raw, dtype=np.int8).astype(np.int64)
    elif ftype == TYPE_S16HL:
        s = np.frombuffer(raw, dtype=">i2").astype(np.int64)
    elif ftype == TYPE_S16LH:
        s = np.frombuffer(raw, dtype="<i2").astype(np.int64)
    elif ftype == TYPE_U16HL:
        s = np.frombuffer(raw, dtype=">u2").astype(np.int64)
    elif ftype == TYPE_U16LH:
        s = np.frombuffer(raw, dtype="<u2").astype(np.int64)
    elif ftype in (TYPE_AU1, TYPE_AU2, TYPE_AU3):
        s = _SIGNMAG_IN[np.frombuffer(raw, dtype=np.uint8)]
    elif ftype == TYPE_ULAW:
        s = _ULAW_EXPAND[np.frombuffer(raw, dtype=np.uint8)]
    elif ftype == TYPE_ALAW:
        s = _ALAW_EXPAND[np.frombuffer(raw, dtype=np.uint8)]
    else:
        raise ValueError(f"shorten: unsupported type {ftype}")
    n = (len(s) // nchan) * nchan
    return s[:n].reshape(-1, nchan)


def samples_to_float(stream):
    """Decoded internal values -> float32 audio in [-1, 1], (n, nchan)."""
    s = stream.samples
    t = stream.ftype
    if t in (TYPE_S16HL, TYPE_S16LH):
        return (s / 32768.0).astype(np.float32)
    if t in (TYPE_U16HL, TYPE_U16LH):
        return ((s - 32768.0) / 32768.0).astype(np.float32)
    if t == TYPE_U8:
        return ((s - 128.0) / 128.0).astype(np.float32)
    if t == TYPE_S8:
        return (s / 128.0).astype(np.float32)
    if t == TYPE_ULAW:
        return (s / 32768.0).astype(np.float32)
    if t == TYPE_ALAW:
        return (s / 32768.0).astype(np.float32)
    if t in (TYPE_AU1, TYPE_AU2, TYPE_AU3):
        # sign-magnitude internal values: expand through the code table
        codes = samples_to_bytes(stream)
        u = np.frombuffer(codes, dtype=np.uint8)
        lin = (_ALAW_EXPAND if t == TYPE_AU3 else _ULAW_EXPAND)[u]
        return (lin.reshape(s.shape) / 32768.0).astype(np.float32)
    raise ValueError(f"shorten: unsupported type {t}")


# ---------------------------------------------------------------------------
# encoder (fixture generation / tests; spec-complete v2 writer)
# ---------------------------------------------------------------------------

def _best_resn(e):
    """Rice parameter minimizing the block's coded size."""
    a = np.abs(e.astype(np.float64))
    mean = a.mean() if len(a) else 0.0
    k0 = max(int(np.log2(mean + 1)) if mean >= 1 else 0, 0)
    best_k, best_bits = 0, None
    u = np.where(e >= 0, e.astype(np.int64) << 1,
                 ((-e.astype(np.int64) - 1) << 1) | 1)
    for k in range(max(0, k0 - 2), k0 + 4):
        bits = int((u >> (k + 1)).sum()) + len(e) * (k + 2)
        if best_bits is None or bits < best_bits:
            best_k, best_bits = k, bits
    return best_k, best_bits


def encode(samples, ftype, blocksize=DEFAULT_BLOCK_SIZE, nmean=4,
           use_qlpc=False, verbatim=None, version=2, bitshift=0,
           predictors=None):
    """Encode interleaved samples ((n, nchan) ints in the type's
    internal domain, or raw bytes) to a shorten v2 stream.

    Independent of :func:`decode` (separate arithmetic paths) so
    round-trip tests are meaningful; additionally validated by
    libavcodec decoding its output bit-exact (linear types).
    ``verbatim``: optional bytes emitted as an FN_VERBATIM chunk before
    the first sample block (how embedded headers ride along).
    ``bitshift``: emit FN_BITSHIFT and code samples>>bitshift (samples
    must be multiples of 2**bitshift for losslessness).
    """
    if isinstance(samples, (bytes, bytearray)):
        raise TypeError("pass internal-domain samples; use "
                        "bytes_to_samples first")
    samples = np.asarray(samples, dtype=np.int64)
    if samples.ndim == 1:
        samples = samples[:, None]
    if bitshift:
        if np.any(samples & ((1 << bitshift) - 1)):
            raise ValueError(
                f"bitshift={bitshift} requires samples divisible by "
                f"{1 << bitshift}")
        samples = samples >> bitshift
    n, nchan = samples.shape

    w = _BitWriter()
    maxnlpc = 2 if use_qlpc else 0
    w.ulong(ftype)
    w.ulong(nchan)
    w.ulong(blocksize)
    w.ulong(maxnlpc)
    w.ulong(nmean)
    w.ulong(0)  # nskip

    mean0 = 0x80 if ftype == TYPE_U8 else (
        0x8000 if ftype in (TYPE_U16HL, TYPE_U16LH) else 0)
    offset = [[mean0] * max(1, nmean) for _ in range(nchan)]
    nwrap = max(NWRAP, maxnlpc)
    hist = [np.zeros(nwrap, dtype=np.int64) for _ in range(nchan)]

    if verbatim:
        w.uvar(FN_VERBATIM, FNSIZE)
        w.uvar(len(verbatim), VERBATIM_CKSIZE_SIZE)
        for b in verbatim:
            w.uvar(b, VERBATIM_BYTE_SIZE)
    if bitshift:
        w.uvar(FN_BITSHIFT, FNSIZE)
        w.uvar(bitshift, BITSHIFTSIZE)

    pos = 0
    cur_bs = blocksize
    while pos < n:
        take = min(cur_bs, n - pos)
        if take != cur_bs:
            w.uvar(FN_BLOCKSIZE, FNSIZE)
            w.ulong(take)
            cur_bs = take
        for chan in range(nchan):
            buf = samples[pos:pos + take, chan]
            h = hist[chan]

            if nmean == 0:
                coffset = offset[chan][0]
            else:
                s = (0 if version < 2 else nmean // 2) + sum(offset[chan])
                if version < 2:
                    coffset = _cdiv(s, nmean)
                else:
                    coffset = _rounded_shift_down(_cdiv(s, nmean), bitshift)

            if not buf.any() and coffset == 0:
                w.uvar(FN_ZERO, FNSIZE)
                resid, cmd = None, FN_ZERO
            else:
                # candidate residuals for DIFF0..3 (+ QLPC if enabled)
                prev = np.concatenate([h[-3:], buf])
                cands = {}
                cands[FN_DIFF0] = buf - coffset
                cands[FN_DIFF1] = prev[3:] - prev[2:-1]
                cands[FN_DIFF2] = (prev[3:] - 2 * prev[2:-1]
                                   + prev[1:-2])
                cands[FN_DIFF3] = (prev[3:] - 3 * (prev[2:-1]
                                   - prev[1:-2]) - prev[:-3])
                if use_qlpc:
                    # fixed order-2 quantized predictor (encoder
                    # freedom; exercises the decoder's QLPC path)
                    qlpc = [int(round(1.8 * (1 << LPCQUANT))),
                            int(round(-0.85 * (1 << LPCQUANT)))]
                    qlpc = [max(min(q, (1 << 15) - 1), -(1 << 15))
                            for q in qlpc]
                    ph = [int(h[-1]) - coffset, int(h[-2]) - coffset]
                    e = np.empty(take, dtype=np.int64)
                    vprev = ph
                    for i in range(take):
                        acc = V2LPC_QOFFSET
                        acc += qlpc[0] * vprev[0] + qlpc[1] * vprev[1]
                        pred = acc >> LPCQUANT
                        v = int(buf[i]) - coffset
                        e[i] = v - pred
                        vprev = [v, vprev[0]]
                    cands[FN_QLPC] = e
                if predictors is not None:
                    cands = {c: e for c, e in cands.items()
                             if c in predictors}
                best_cmd, best_cost, best_e, best_k = None, None, None, 0
                for cmdc, e in cands.items():
                    k, bits = _best_resn(e)
                    if best_cost is None or bits < best_cost:
                        best_cmd, best_cost, best_e, best_k = (
                            cmdc, bits, e, k)
                cmd, resid = best_cmd, best_e
                w.uvar(cmd, FNSIZE)
                w.uvar(best_k, ENERGYSIZE)
                if cmd == FN_QLPC:
                    w.uvar(2, LPCQSIZE)
                    w.var(qlpc[0], LPCQUANT)
                    w.var(qlpc[1], LPCQUANT)
                w.vars(resid, best_k)

            if nmean > 0:
                s = (0 if version < 2 else take // 2) + int(buf.sum())
                offset[chan] = offset[chan][1:] + [
                    _cdiv(s, take) if version < 2
                    else _cdiv(s, take) << bitshift]
            if take >= nwrap:
                hist[chan] = buf[-nwrap:].copy()
            else:
                hist[chan] = np.concatenate([h, buf])[-nwrap:]
        pos += take

    w.uvar(FN_QUIT, FNSIZE)
    return MAGIC + bytes([version]) + w.tobytes()
