"""Plain PyTorch reference of the speech encoder-decoder (Bansal et al.,
arXiv:1809.01431, the es_en_20h model): conv front-end with BatchNorm,
direction-stacked biLSTM encoder, Luong-attention LSTM decoder with
input feeding and scheduled sampling, the PAD-masked cross-entropy, and
AMSGrad with L2 and global-norm clipping.

It imports nothing of the program.  Each step is written from the
model's equations as the program's configuration defines them; the
hash dropout masks and the step's random draws (speech noise, dropout
seeds, sampling coins) are worked out again from the step's seed by
``draws.py``.  Every matrix product goes through ``precision.mm`` at a
``mode`` (float32 for the reference, lower for the controls); the
elementwise math is float32.

Parameters are a flat dict ``{path: tensor}`` in the layout of
``benchmark/core/weights.py`` (``cnn/0/w``, ``enc/lstm/0/wx`` with a
leading direction axis, ``dec/lstm/0/wx``, ``attn/wa/0/w``, ...), gate
order [i, f, g, o].
"""

import torch

from benchmark.reference.draws import drop_keep
from benchmark.reference.precision import mm

PAD, GO, EOS = 0, 1, 2
BN_EPS = 2e-5


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


def conv_frontend(p, mcfg, X, train, mode="f32"):
    """X (B, T, D) -> (B, T', C): each layer a stride-``sh`` window of
    ``kh`` frames over the whole feature axis (layer 0) or the channels,
    one product, BatchNorm (batch statistics over rows and time in
    training, population variance; else mean 0 / variance 1, the state
    of a model that has not trained), ReLU."""
    h = X
    for i, layer in enumerate(mcfg["cnn_config"]["cnn_layers"]):
        kh, sh, ph = layer["ksize"][0], layer["stride"][0], layer["pad"][0]
        h = torch.nn.functional.pad(h, (0, 0, ph, ph))
        T_out = (h.shape[1] - kh) // sh + 1
        win = torch.cat([h[:, k:k + sh * (T_out - 1) + 1:sh]
                         for k in range(kh)], dim=-1)     # (B, T', kh C)
        w = p[f"cnn/{i}/w"]                               # (O, C, kh, kw)
        if i == 0:
            w2 = w[:, 0].permute(1, 2, 0).reshape(-1, w.shape[0])
        else:
            w2 = w[..., 0].permute(2, 1, 0).reshape(-1, w.shape[0])
        out = _flat_mm(win, w2, mode)
        if train:
            mean = out.mean(dim=(0, 1))
            var = out.var(dim=(0, 1), correction=0)
        else:
            mean, var = torch.zeros_like(out[0, 0]), torch.ones_like(
                out[0, 0])
        out = (out - mean) * torch.rsqrt(var + BN_EPS)
        out = out * p[f"cnn/{i}/bn_gamma"] + p[f"cnn/{i}/bn_beta"]
        h = torch.relu(out)
    return h


def encoder(p, mcfg, h_cnn, seed=0, rate=0.0, mode="f32"):
    """The stacked biLSTM over the conv output (B, T', C): both
    directions step together, the backward one over the reversed
    sequence; each layer's output is dropped at ``rate`` by the hash
    mask of (step, layer) under ``seed`` over (direction, row, unit),
    and the next layer reads it.  Returns (enc (B, T', 2 He), h0, c0
    (L, B, 2 He)), the directions concatenated [forward, backward]."""
    rnn = mcfg["rnn_config"]
    L = rnn["enc_layers"]
    seq = h_cnn.transpose(0, 1)                          # (T', B, C)
    xs = torch.stack([seq, seq.flip(0)], dim=1)          # (T', 2, B, C)
    Tp, D2, B, _ = xs.shape
    wx0 = p["enc/lstm/0/wx"]                             # (2, C, 4He)
    He = wx0.shape[2] // 4
    x0 = torch.stack([_flat_mm(xs[:, d], wx0[d], mode) for d in range(D2)],
                     dim=1)                              # (T', 2, B, 4He)
    h = [xs.new_zeros((D2, B, He)) for _ in range(L)]
    c = [xs.new_zeros((D2, B, He)) for _ in range(L)]
    outs = []
    for t in range(Tp):
        x = None
        for l in range(L):
            wh = p[f"enc/lstm/{l}/wh"]
            z = x0[t] if l == 0 else mm(x, p[f"enc/lstm/{l}/wx"], mode)
            z = z + mm(h[l], wh, mode) + p[f"enc/lstm/{l}/b"][:, None, :]
            h[l], c[l] = _lstm(z, c[l], He)
            x = h[l]
            if rate > 0:
                keep = drop_keep((D2, B, He), rate, seed + t * L + l,
                                 row_axis=1, device=x.device)
                x = torch.where(keep, x / (1.0 - rate), 0.0)
        outs.append(x)
    outs = torch.stack(outs)                             # (T', 2, B, He)
    enc = torch.cat([outs[:, 0], outs[:, 1].flip(0)], dim=-1)
    h0 = torch.stack([torch.cat([hl[0], hl[1]], dim=-1) for hl in h])
    c0 = torch.stack([torch.cat([cl[0], cl[1]], dim=-1) for cl in c])
    return enc.transpose(0, 1), h0, c0


def decoder_step(p, mcfg, enc, h, c, ht, tok, drop=None, mode="f32"):
    """One step of the attention decoder for R rows: embedding (dropped
    with the step's mask), input feeding [emb; ht], the L-layer LSTM
    (each layer's output dropped), Luong general attention over ``enc``
    (R, T', H) from the top layer's dropped output, ht = tanh(W_c [cv;
    h] + b), the logits.  ``drop``: None, or (dec_seed, t, rate_embed,
    rate_rnn).  Returns (logits, h, c, ht)."""
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
    q = mm(x, p["attn/wa/0/w"], mode) + p["attn/wa/0/b"]
    scores = mm(enc, q[:, :, None], mode)[..., 0]             # (R, T')
    alphas = torch.softmax(scores, dim=-1)
    cv = mm(alphas[:, None, :], enc, mode)[:, 0]              # (R, H)
    ht = torch.tanh(mm(torch.cat([cv, x], dim=-1), p["attn/context/w"],
                       mode) + p["attn/context/b"])
    logits = mm(ht, p["dec/out_w"], mode) + p["dec/out_b"]
    return logits, torch.stack(new_h), torch.stack(new_c), ht


def train_loss(p, mcfg, X, y, n_real, draws, mode="f32", inputs=None):
    """The training loss of one batch: speech noise, the train-mode conv
    front-end and encoder, the decoder over the U - 1 steps with the
    teacher's token where ``draws.coins`` holds and else the argmax of
    the step before's logits, the PAD-masked cross-entropy summed over
    steps and rows over ``n_real``.  X (B, T, D), y (B, U) int64.
    ``inputs``: a list that receives each step's input tokens."""
    rates = mcfg["dropout"]
    A = mcfg["rnn_config"]["attn_units"]
    if draws.noise is not None:
        X = X * (1.0 + draws.noise)
    h_cnn = conv_frontend(p, mcfg, X, True, mode)
    enc, h, c = encoder(p, mcfg, h_cnn, draws.enc_seed,
                        float(rates["rnn"]), mode)
    yT = y.t()
    steps = yT.shape[0] - 1
    coins = draws.coins
    ht = X.new_zeros((X.shape[0], A))
    loss = X.new_zeros(())
    prev = None
    for t in range(steps):
        tok = yT[t] if coins[t] else prev
        if inputs is not None:
            inputs.append(tok)
        logits, h, c, ht = decoder_step(
            p, mcfg, enc, h, c, ht, tok,
            (draws.dec_seed, t, float(rates["embed"]), float(rates["rnn"])),
            mode)
        if t + 1 < steps and not coins[t + 1]:
            prev = torch.argmax(logits.detach(), dim=-1)
        target = yT[t + 1]
        nll = -torch.log_softmax(logits, dim=-1).gather(
            -1, target[:, None])[:, 0]
        loss = loss + (nll * (target != PAD)).sum()
    return loss / n_real


def encode_eval(p, mcfg, X, mode="f32"):
    """The eval-mode encoder: no noise, no dropout, BatchNorm at the
    untrained state.  Returns (enc, h0, c0)."""
    return encoder(p, mcfg, conv_frontend(p, mcfg, X, False, mode),
                   mode=mode)


def follow(p, mcfg, enc, h0, c0, tokens, mode="f32"):
    """The eval-mode decoder along given token rows: ``tokens`` (R, S)
    int64 starting with GO; ``enc`` (R, T', H) and h0, c0 (L, R, H) of
    each row.  Returns the log-probabilities (R, S - 1, V) of the step
    that each position after GO was chosen at."""
    A = mcfg["rnn_config"]["attn_units"]
    h, c = h0, c0
    ht = enc.new_zeros((enc.shape[0], A))
    out = []
    for s in range(tokens.shape[1] - 1):
        logits, h, c, ht = decoder_step(p, mcfg, enc, h, c, ht,
                                        tokens[:, s], mode=mode)
        out.append(torch.log_softmax(logits, dim=-1))
    return torch.stack(out, dim=1)


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
