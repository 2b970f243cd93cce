"""Plain PyTorch reference of LAS-6-1280, the Listen-Attend-Spell model of
SpecAugment's LibriSpeech 960h recipe (Park et al., Interspeech 2019,
arXiv:1904.08779, sections 3-4): a two-layer CNN of stride 2 over
log-mel filter banks with delta and delta-delta, a listener of d jointly
stacked bidirectional LSTM layers of w cells a direction, an attention
speller of two w-cell LSTM layers, label smoothing, the SpecAugment LD
policy, and AMSGrad with L2 and global-norm clipping.

The CPU tests' copy (``benchmark/reference/las_model.py`` is the
benchmark's): it imports neither JAX nor ``ast_tpu`` nor anything of
the port.  Each step is written from the model's equations as the
configuration defines them; the step's random draws (dropout seeds,
sampling coins, SpecAugment's masks) and the hash dropout masks are
worked out again from the step's seed.  Every product is float32 (the
caller turns TF32 off on a GPU).

Departures from the paper (the configuration's ``assumed``):

- attention is Luong's general form, ``q = h_top W_a + b`` (H -> He)
  over the listener's He = 2w wide states, ``ht = tanh(W_c [cv; h_top] +
  b)``, fed back with the next step's input (input feeding); the paper's
  LAS uses content-based MLP attention and feeds c_{i-1};
- the speller's embedding E 512 and attentional vector A 1,280 are not
  given in the paper;
- the convs are 3x3, stride 2 in time and frequency, 32 channels, each
  with BatchNorm and ReLU and no max-pooling (the paper: "2-layer CNN
  with max-pooling and stride of 2");
- the speller starts from zero states: the listener's final states (six
  layers of 2w) are not its shape;
- no time warping; label smoothing 0.1; dropout 0.3 on the embedding
  and on every LSTM layer's output (listener and speller), scheduled
  sampling at teach ratio 0.8;
- the listener's layer l drops its output with the hash mask of step t
  under the seed ``enc_seed + l T' + t`` over (direction, row, unit).

Parameters are a flat dict ``{path: tensor}``: ``cnn/i/w`` (O, C, 3, 3),
``cnn/i/bn_gamma``, ``cnn/i/bn_beta``; ``enc/lstm/l/wx`` (2, C_l, 4w),
``enc/lstm/l/wh`` (2, w, 4w), ``enc/lstm/l/b`` (2, 4w); ``attn/wa/0/w``
(H, He), ``attn/wa/0/b``, ``attn/context/w`` (He + H, A),
``attn/context/b``; ``dec/embed`` (V, E), ``dec/lstm/l/wx``, ``wh``,
``b``; ``dec/out_w`` (A, V), ``dec/out_b``.  Gate order [i, f, g, o].
"""

import torch
import torch.utils.checkpoint


PAD, GO, EOS = 0, 1, 2
BN_EPS = 2e-5

_M32 = 0xFFFFFFFF


def _mul32(x, c):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def drop_hash(flat, seed):
    """The 32-bit hash of flat indices (int64 tensor) under ``seed``."""
    seed = seed & _M32
    x = (flat + _mul32(torch.as_tensor(seed, device=flat.device),
                       2654435761)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def drop_keep(shape, rate, seed, row_axis=None, device="cpu"):
    """The keep-mask (bool, ``shape``) of dropout at ``rate``."""
    flat = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for axis in reversed(range(len(shape))):
        view = [1] * len(shape)
        view[axis] = shape[axis]
        ids = torch.arange(shape[axis], dtype=torch.int64,
                           device=device).view(view)
        flat = (flat + ids * stride) & _M32
        stride *= shape[axis]
    return drop_hash(flat.expand(shape), seed) >= int(rate * (2 ** 32))


def mm(a, b, mode="f32"):
    """``a @ b`` in float32: this copy has no lower precision modes."""
    if mode != "f32":
        raise ValueError(f"the tests' reference runs at f32, not {mode}")
    return torch.matmul(a, b)


def _lstm(z, c, H):
    i = torch.sigmoid(z[..., :H])
    f = torch.sigmoid(z[..., H:2 * H])
    g = torch.tanh(z[..., 2 * H:3 * H])
    o = torch.sigmoid(z[..., 3 * H:])
    c = f * c + i * g
    return o * torch.tanh(c), c


def _flat_mm(x, w, mode):
    """``x (..., K) @ w (K, N)`` at ``mode``."""
    return mm(x.reshape(-1, x.shape[-1]), w, mode).reshape(
        *x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# the step's draws
# ---------------------------------------------------------------------------

class Draws:
    """One step's random numbers: the dropout seeds, the coins of the
    U - 1 decoder steps (True: the teacher's token) and SpecAugment's
    masks, each a list of ``(start, width)`` pairs of (B,) int64."""

    def __init__(self, enc_seed, dec_seed, coins, freq, time):
        self.enc_seed, self.dec_seed = enc_seed, dec_seed
        self.coins, self.freq, self.time = coins, freq, time


def _mask_axis(gen, B, max_width, span, cap=None):
    """One mask's (start, width) over ``span`` (an int, or (B,) ints):
    width uniform in 0 .. max_width, cut to ``cap`` and the span, then
    the start uniform over the places it fits."""
    span = torch.as_tensor(span).long().reshape(-1, 1).expand(B, 1)
    w = torch.randint(0, max_width + 1, (B, 1), generator=gen)
    if cap is not None:
        w = torch.minimum(w, cap)
    w = torch.minimum(w, span)
    u = torch.rand((B, 1), generator=gen)
    start = torch.floor(u * (span - w + 1).float()).long()
    return start[:, 0], w[:, 0]


def make_draws(seed, B, bins, steps, teach_ratio, spec, frame_len):
    """The draws of a step from its seed, in the order the recipe draws
    them from one host generator: the two dropout seeds, the coins (the
    first and last step forced), the frequency masks over a plane's
    ``bins``, then the time masks over each row's true frames
    ``frame_len`` (B,), each at most ``time_p`` of them."""
    gen = torch.Generator().manual_seed(seed)
    enc_seed, dec_seed = torch.randint(0, 2 ** 31 - 1, (2,),
                                       generator=gen).tolist()
    idx = torch.arange(steps)
    coins = ((idx == 0) | (idx >= steps - 1)
             | (torch.rand(steps, generator=gen) < teach_ratio))
    freq = [_mask_axis(gen, B, int(spec["freq_width"]), bins)
            for _ in range(int(spec["freq_masks"]))]
    lengths = torch.as_tensor(frame_len).long().reshape(B, 1)
    cap = (float(spec["time_p"]) * lengths.float()).long()
    time = [_mask_axis(gen, B, int(spec["time_width"]), lengths, cap)
            for _ in range(int(spec["time_masks"]))]
    return Draws(enc_seed, dec_seed, [bool(v) for v in coins], freq, time)


def _outside(masks, n, device):
    """(B, n) bool: True outside every ``(start, width)`` band."""
    i = torch.arange(n, device=device)[None, :]
    keep = torch.ones((masks[0][0].shape[0] if masks else 1, n),
                      dtype=torch.bool, device=device)
    for start, w in masks:
        start, w = start.to(device)[:, None], w.to(device)[:, None]
        keep = keep & ~((i >= start) & (i < start + w))
    return keep


def spec_augment(X, draws, planes):
    """X (B, T, planes * bins) with the time masks' frames and the
    frequency masks' bins of every plane zeroed."""
    B, T, D = X.shape
    keep_t = _outside(draws.time, T, X.device)               # (B, T)
    keep_f = _outside(draws.freq, D // planes, X.device)     # (B, bins)
    keep = keep_t[:, :, None] & keep_f.repeat(1, planes)[:, None, :]
    return X * keep.to(X.dtype)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def conv_frontend(p, mcfg, X, train, mode="f32"):
    """X (B, T, planes * bins) viewed as (B, planes, T, bins) -> (B, T',
    C W'): each layer a 2-D convolution (one product over the unfolded
    windows), BatchNorm over rows, time and frequency (batch statistics
    in training, population variance; else mean 0 / variance 1, the
    state of a model that has not trained), ReLU; the output's channels
    and bins flattened channel by channel."""
    cnn = mcfg["cnn_config"]
    layers = cnn["cnn_layers"]
    B, T, D = X.shape
    C = int(layers[0].get("in_channels") or 1)
    h = X.reshape(B, T, C, D // C).transpose(1, 2)
    for i, layer in enumerate(layers):
        w = p[f"cnn/{i}/w"]                                   # (O, C, kh, kw)
        O, _, kh, kw = w.shape
        (sh, sw), (ph, pw) = layer["stride"], layer["pad"]
        Hh, Ww = h.shape[2], h.shape[3]
        Ho = (Hh + 2 * ph - kh) // sh + 1
        Wo = (Ww + 2 * pw - kw) // sw + 1
        cols = torch.nn.functional.unfold(h, (kh, kw), padding=(ph, pw),
                                          stride=(sh, sw))    # (B, C k, L)
        out = _flat_mm(cols.transpose(1, 2), w.reshape(O, -1).t(), mode)
        out = out.transpose(1, 2).reshape(B, O, Ho, Wo)
        if train:
            mean = out.mean(dim=(0, 2, 3))
            var = out.var(dim=(0, 2, 3), correction=0)
        else:
            mean, var = torch.zeros(O, device=X.device), torch.ones(
                O, device=X.device)
        out = ((out - mean.view(1, -1, 1, 1))
               * torch.rsqrt(var + BN_EPS).view(1, -1, 1, 1))
        out = (out * p[f"cnn/{i}/bn_gamma"].view(1, -1, 1, 1)
               + p[f"cnn/{i}/bn_beta"].view(1, -1, 1, 1))
        h = torch.relu(out)
    B, O, Tp, Wp = h.shape
    return h.transpose(1, 2).reshape(B, Tp, O * Wp)


def _listener_layer(seq, wx, wh, b, seed, rate, mode):
    """Layer of :func:`listener`: (T', B, C) -> (T', B, 2w), h_fin, c_fin
    (B, 2w)."""
    Tp, B = seq.shape[:2]
    D2, w = wx.shape[0], wx.shape[2] // 4
    xs = [seq, seq.flip(0)][:D2]
    x_proj = torch.stack([_flat_mm(xs[d], wx[d], mode) for d in range(D2)],
                         dim=1)                          # (T', 2, B, 4w)
    h = seq.new_zeros((D2, B, w))
    c = seq.new_zeros((D2, B, w))
    outs = []
    for t in range(Tp):
        z = x_proj[t] + mm(h, wh, mode) + b[:, None, :]
        h, c = _lstm(z, c, w)
        x = h
        if rate > 0:
            keep = drop_keep((D2, B, w), rate, seed + t, row_axis=1,
                             device=x.device)
            x = torch.where(keep, x / (1.0 - rate), 0.0)
        outs.append(x)
    outs = torch.stack(outs)                             # (T', 2, B, w)
    parts = [outs[:, 0]] + ([outs[:, 1].flip(0)] if D2 == 2 else [])
    return (torch.cat(parts, dim=-1), torch.cat(list(h), dim=-1),
            torch.cat(list(c), dim=-1))


def listener(p, mcfg, h_cnn, seed=0, rate=0.0, mode="f32", remat=False):
    """The jointly stacked biLSTM over the conv output (B, T', C): layer
    l runs both directions over the concatenated [forward; backward]
    outputs of layer l - 1 (the backward direction over the reversed
    sequence), its input product taken over the whole sequence; its
    output is dropped at ``rate`` by the hash mask of step t under the
    seed ``seed + l T' + t`` over (direction, row, unit).  ``remat``:
    each layer's steps are recomputed in the backward
    (``torch.utils.checkpoint``; the masks are hashes, so the recomputed
    layer is the same), so that a long utterance's listener fits on the
    card.  Returns (enc (B, T', 2w), h_fin, c_fin (L, B, 2w))."""
    seq = h_cnn.transpose(0, 1)                                # (T', B, C)
    Tp = seq.shape[0]
    h_fin, c_fin = [], []
    for l in range(mcfg["rnn_config"]["enc_layers"]):
        args = (seq, p[f"enc/lstm/{l}/wx"], p[f"enc/lstm/{l}/wh"],
                p[f"enc/lstm/{l}/b"], seed + l * Tp, rate, mode)
        if remat:
            seq, h, c = torch.utils.checkpoint.checkpoint(
                _listener_layer, *args, use_reentrant=False)
        else:
            seq, h, c = _listener_layer(*args)
        h_fin.append(h)
        c_fin.append(c)
    return seq.transpose(0, 1), torch.stack(h_fin), torch.stack(c_fin)


def speller_start(mcfg, h_fin, c_fin):
    """The speller's initial (h, c): the listener's final states where
    they are its shape, else zeros."""
    rnn = mcfg["rnn_config"]
    L, H = rnn["dec_layers"], rnn["hidden_units"]
    if h_fin.shape[0] == L and h_fin.shape[2] == H:
        return h_fin, c_fin
    zero = h_fin.new_zeros((L, h_fin.shape[1], H))
    return zero, zero


def decoder_step(p, mcfg, enc, h, c, ht, tok, drop=None, mode="f32"):
    """One speller step for R rows: embedding (dropped with the step's
    mask), input feeding [emb; ht], the L-layer LSTM (each layer's output
    dropped), Luong general attention over ``enc`` (R, T', He) from the
    top layer's dropped output, ht = tanh(W_c [cv; h] + b), the logits.
    ``drop``: None, or (dec_seed, t, rate_embed, rate_rnn).  Returns
    (logits, h, c, ht)."""
    rnn = mcfg["rnn_config"]
    L, H = rnn["dec_layers"], rnn["hidden_units"]
    R = tok.shape[0]
    x = p["dec/embed"][tok]
    if drop is not None and drop[2] > 0:
        seed, t, r_emb, _ = drop
        keep = drop_keep(tuple(x.shape), r_emb, seed + 2 * t, row_axis=0,
                         device=x.device)
        x = torch.where(keep, x / (1.0 - r_emb), 0.0)
    x = torch.cat([x, ht], dim=-1)
    new_h, new_c = [], []
    for l in range(L):
        z = (mm(x, p[f"dec/lstm/{l}/wx"], mode)
             + mm(h[l], p[f"dec/lstm/{l}/wh"], mode) + p[f"dec/lstm/{l}/b"])
        hl, cl = _lstm(z, c[l], H)
        new_h.append(hl)
        new_c.append(cl)
        x = hl
        if drop is not None and drop[3] > 0:
            seed, t, _, r_rnn = drop
            keep = drop_keep((R, H), r_rnn, seed + 2 * (t * L + l) + 1,
                             row_axis=0, device=x.device)
            x = torch.where(keep, x / (1.0 - r_rnn), 0.0)
    q = mm(x, p["attn/wa/0/w"], mode) + p["attn/wa/0/b"]        # (R, He)
    scores = mm(enc, q[:, :, None], mode)[..., 0]               # (R, T')
    alphas = torch.softmax(scores, dim=-1)
    cv = mm(alphas[:, None, :], enc, mode)[:, 0]                # (R, He)
    ht = torch.tanh(mm(torch.cat([cv, x], dim=-1), p["attn/context/w"],
                       mode) + p["attn/context/b"])
    logits = mm(ht, p["dec/out_w"], mode) + p["dec/out_b"]
    return logits, torch.stack(new_h), torch.stack(new_c), ht


def token_loss(logits, target, eps):
    """Each row's label-smoothed loss: (1 - eps) times the target's
    negative log-probability plus eps times the mean over the vocabulary
    of the negative log-probabilities; 0 at PAD targets."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, target[:, None])[:, 0]
    if eps > 0:
        nll = (1.0 - eps) * nll + eps * -logp.mean(dim=-1)
    return nll * (target != PAD)


def train_loss(p, mcfg, X, y, n_real, draws, eps=0.0, mode="f32",
               inputs=None, remat=False):
    """The training loss of one batch: SpecAugment's masks, the
    train-mode conv front-end and listener, the speller over the U - 1
    steps with the teacher's token where ``draws.coins`` holds and else
    the argmax of the step before's logits, the label-smoothed
    PAD-masked cross-entropy summed over steps and rows over ``n_real``.
    X (B, T, planes * bins), y (B, U) int64.  ``inputs``: a list that
    receives each step's input tokens; ``remat``: :func:`listener`'s."""
    rates = mcfg["dropout"]
    A = mcfg["rnn_config"]["attn_units"]
    planes = int(mcfg["cnn_config"]["cnn_layers"][0].get("in_channels")
                 or 1)
    X = spec_augment(X, draws, planes)
    h_cnn = conv_frontend(p, mcfg, X, True, mode)
    enc, h, c = listener(p, mcfg, h_cnn, draws.enc_seed,
                         float(rates["rnn"]), mode, remat)
    h, c = speller_start(mcfg, h, c)
    yT = y.t()
    steps = yT.shape[0] - 1
    ht = X.new_zeros((X.shape[0], A))
    loss = X.new_zeros(())
    prev = None
    for t in range(steps):
        tok = yT[t] if draws.coins[t] else prev
        if inputs is not None:
            inputs.append(tok)
        logits, h, c, ht = decoder_step(
            p, mcfg, enc, h, c, ht, tok,
            (draws.dec_seed, t, float(rates["embed"]), float(rates["rnn"])),
            mode)
        if t + 1 < steps and not draws.coins[t + 1]:
            prev = torch.argmax(logits.detach(), dim=-1)
        loss = loss + token_loss(logits, yT[t + 1], eps).sum()
    return loss / n_real


def forced_logits(p, mcfg, X, y, mode="f32"):
    """Eval mode along the teacher's tokens: no masks, no dropout,
    BatchNorm at the untrained state.  Returns the logits (U - 1, B,
    V)."""
    A = mcfg["rnn_config"]["attn_units"]
    enc, h, c = listener(p, mcfg, conv_frontend(p, mcfg, X, False, mode),
                         mode=mode)
    h, c = speller_start(mcfg, h, c)
    ht = X.new_zeros((X.shape[0], A))
    out = []
    for t in range(y.shape[1] - 1):
        logits, h, c, ht = decoder_step(p, mcfg, enc, h, c, ht, y[:, t],
                                        mode=mode)
        out.append(logits)
    return torch.stack(out)


class AMSGrad:
    """L2 added to the gradient, global-norm clipping, AMSGrad (b1 0.9,
    b2 0.999, eps 1e-8) whose running maximum is of the bias-corrected
    second moment, then ``-lr`` times the step, on flat dicts."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, opt_cfg, params):
        self.lr, self.l2 = float(opt_cfg["lr"]), float(opt_cfg["l2"])
        self.clip = float(opt_cfg["grad_clip"])
        z = {k: torch.zeros_like(v) for k, v in params.items()}
        self.mu, self.nu = dict(z), dict(z)
        self.nu_max = dict(z)
        self.count = 0

    def step(self, params, grads):
        """Update ``params`` in place; returns the gradient as the
        moments received it (after L2 and clipping)."""
        g = {k: grads[k] + self.l2 * params[k] for k in params}
        norm = torch.sqrt(sum((v * v).sum() for v in g.values()))
        scale = torch.where(norm < self.clip, 1.0, self.clip / norm)
        g = {k: v * scale for k, v in g.items()}
        self.count += 1
        bc1 = 1 - self.B1 ** self.count
        bc2 = 1 - self.B2 ** self.count
        for k in params:
            self.mu[k] = self.B1 * self.mu[k] + (1 - self.B1) * g[k]
            self.nu[k] = self.B2 * self.nu[k] + (1 - self.B2) * g[k] * g[k]
            self.nu_max[k] = torch.maximum(self.nu_max[k],
                                           self.nu[k] / bc2)
            params[k] -= self.lr * (self.mu[k] / bc1) / (
                torch.sqrt(self.nu_max[k]) + self.EPS)
        return g
