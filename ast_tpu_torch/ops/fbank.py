"""MFCC / log-mel filterbank features and CMVN, in PyTorch.

The counterpart of ``ast_tpu/ops/fbank.py`` (Kaldi's compute-mfcc-feats
for 8 kHz telephone speech: 25 ms frames every 10 ms, snip-edges, DC
removal, pre-emphasis 0.97, povey window, 23 mel bins on [20 Hz,
Nyquist], log floored at FLT_EPSILON, 13 ceps, cepstral lifter 22, no
dither; per-speaker CMVN with variance normalisation).  The chain is an
index gather of the frames and three float32 matmuls against constant
bases -- the DFT as cos / sin bases, the mel filterbank, the DCT with the
lifter folded in -- which ``ast_tpu`` leaves to XLA outside any Pallas
kernel and this port to ``torch.matmul``.  The bases are built with
NumPy exactly as ``ast_tpu`` builds them and moved to the extractor's
device once.
"""

import math

import numpy as np
import torch


class MfccConfig:
    def __init__(self, sample_rate=8000, frame_ms=25.0, shift_ms=10.0,
                 n_mels=23, n_ceps=13, preemph=0.97, remove_dc=True,
                 window="povey", low_freq=20.0, high_freq=0.0,
                 cepstral_lifter=22.0, log_floor=None):
        self.sample_rate = sample_rate
        self.frame_len = int(sample_rate * frame_ms / 1000)
        self.shift = int(sample_rate * shift_ms / 1000)
        self.n_fft = 1 << (self.frame_len - 1).bit_length()  # next pow2
        self.n_mels = n_mels
        self.n_ceps = n_ceps
        self.preemph = preemph
        self.remove_dc = remove_dc
        self.window = window
        self.low_freq = low_freq
        self.high_freq = high_freq if high_freq > 0 else sample_rate / 2
        self.cepstral_lifter = cepstral_lifter
        # Kaldi floors mel energies at FLT_EPSILON before the log
        self.log_floor = (float(np.finfo(np.float32).eps)
                          if log_floor is None else log_floor)


def _window_fn(cfg):
    n = cfg.frame_len
    a = 2 * math.pi / (n - 1)
    i = np.arange(n)
    if cfg.window == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif cfg.window == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif cfg.window == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    else:
        w = np.ones(n)
    return w.astype(np.float32)


def _mel_scale(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def _mel_filterbank(cfg):
    """Kaldi-style triangular mel filterbank matrix (n_bins, n_mels)."""
    n_bins = cfg.n_fft // 2 + 1
    fft_freqs = np.arange(n_bins) * cfg.sample_rate / cfg.n_fft
    mel_low = _mel_scale(cfg.low_freq)
    mel_high = _mel_scale(cfg.high_freq)
    mel_pts = np.linspace(mel_low, mel_high, cfg.n_mels + 2)
    mel_f = _mel_scale(fft_freqs)
    fb = np.zeros((n_bins, cfg.n_mels), dtype=np.float32)
    for m in range(cfg.n_mels):
        left, center, right = mel_pts[m], mel_pts[m + 1], mel_pts[m + 2]
        up = (mel_f - left) / (center - left)
        down = (right - mel_f) / (right - center)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def _dct_matrix(cfg):
    """Orthonormal DCT-II (n_mels, n_ceps) with cepstral liftering folded
    into the matrix (both are linear)."""
    n, k = cfg.n_mels, cfg.n_ceps
    j = np.arange(n)[:, None]
    i = np.arange(k)[None, :]
    dct = np.sqrt(2.0 / n) * np.cos(math.pi * (j + 0.5) * i / n)
    dct[:, 0] = 1.0 / math.sqrt(n)
    if cfg.cepstral_lifter > 0:
        q = cfg.cepstral_lifter
        lifter = 1.0 + 0.5 * q * np.sin(math.pi * np.arange(k) / q)
        dct = dct * lifter[None, :]
    return dct.astype(np.float32)


def _dft_bases(cfg):
    """Real/imag DFT bases (frame_len, n_bins): the frame is implicitly
    zero-padded to n_fft by truncating the basis rows."""
    n_bins = cfg.n_fft // 2 + 1
    t = np.arange(cfg.frame_len)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = -2.0 * math.pi * t * k / cfg.n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def num_frames(cfg, n_samples):
    """snip-edges frame count."""
    if n_samples < cfg.frame_len:
        return 0
    return 1 + (n_samples - cfg.frame_len) // cfg.shift


class MfccExtractor:
    """Batched MFCC on one device: audio (..., n_samples) -> (..., F,
    n_ceps) float32 tensors on that device.  ``audio``: a tensor or
    anything ``numpy.asarray`` takes."""

    def __init__(self, cfg=None, device="cpu"):
        self.cfg = cfg or MfccConfig()
        self.device = torch.device(device)
        cos_b, sin_b = _dft_bases(self.cfg)
        self.cos_b, self.sin_b, self.win, self.fb, self.dct = (
            torch.from_numpy(a).to(self.device)
            for a in (cos_b, sin_b, _window_fn(self.cfg),
                      _mel_filterbank(self.cfg), _dct_matrix(self.cfg)))

    def _audio(self, audio):
        if isinstance(audio, torch.Tensor):
            return audio.to(self.device, torch.float32)
        return torch.from_numpy(np.asarray(audio, np.float32)).to(
            self.device)

    def _logmel(self, audio, n_fr):
        """Frames, DC removal, pre-emphasis, window, power spectrum, mel
        and log: the MFCC chain before the DCT."""
        cfg = self.cfg
        idx = (torch.arange(n_fr, device=self.device)[:, None] * cfg.shift
               + torch.arange(cfg.frame_len, device=self.device)[None, :])
        frames = audio[..., idx]                    # (..., F, frame_len)
        if cfg.remove_dc:
            frames = frames - frames.mean(dim=-1, keepdim=True)
        if cfg.preemph > 0:
            prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
            frames = frames - cfg.preemph * prev
        frames = frames * self.win
        re = torch.matmul(frames, self.cos_b)       # (..., F, n_bins)
        im = torch.matmul(frames, self.sin_b)
        mel = torch.matmul(re * re + im * im, self.fb)
        return torch.log(torch.clamp(mel, min=cfg.log_floor))

    def __call__(self, audio):
        audio = self._audio(audio)
        n_fr = num_frames(self.cfg, audio.shape[-1])
        if n_fr == 0:
            return audio.new_zeros(audio.shape[:-1] + (0, self.cfg.n_ceps))
        return torch.matmul(self._logmel(audio, n_fr), self.dct)

    def logmel(self, audio):
        """Log-mel filterbank features (the MFCC chain minus the DCT)."""
        audio = self._audio(audio)
        n_fr = num_frames(self.cfg, audio.shape[-1])
        if n_fr == 0:
            return audio.new_zeros(audio.shape[:-1] + (0, self.cfg.n_mels))
        return self._logmel(audio, n_fr)


# ---------------------------------------------------------------------------
# CMVN (reference: apply-cmvn --norm-vars=true, per speaker)
# ---------------------------------------------------------------------------

def compute_cmvn_stats(feature_arrays):
    """Accumulate per-group CMVN stats from a list of (T, D) arrays.

    Returns {"mean": (D,), "std": (D,), "count": n} — the per-speaker
    statistics Kaldi's compute_cmvn_stats.sh produces.
    """
    total = None
    total_sq = None
    count = 0
    for x in feature_arrays:
        x = np.asarray(x, np.float64)
        s = x.sum(axis=0)
        sq = (x * x).sum(axis=0)
        total = s if total is None else total + s
        total_sq = sq if total_sq is None else total_sq + sq
        count += x.shape[0]
    if not count:
        # a speaker group whose utterances were all filtered out would
        # otherwise die on a bare TypeError/ZeroDivisionError in numpy
        raise ValueError(
            "compute_cmvn_stats: no frames to accumulate (empty list "
            "or every array has zero rows)")
    mean = total / count
    var = total_sq / count - mean * mean
    return {
        "mean": mean.astype(np.float32),
        "std": np.sqrt(np.maximum(var, 1e-10)).astype(np.float32),
        "count": count,
    }


def apply_cmvn(feats, stats, norm_vars=True):
    """Normalize (…, T, D) features with precomputed stats (NumPy arrays,
    or tensors with stats on their device)."""
    out = feats - stats["mean"]
    if norm_vars:
        out = out / stats["std"]
    return out
