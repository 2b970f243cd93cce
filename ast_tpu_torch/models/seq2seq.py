"""Speech encoder-decoder with Luong attention: decode path and the
training loss.

The counterpart of ``ast_tpu/models/seq2seq.py``: conv front-end ->
direction-stacked biLSTM encoder (K1) -> greedy (K5) or beam (K6)
decoding, and for training the scheduled-sampling decoder (K3) with the
PAD-masked cross-entropy, differentiable through K2 and K4.  Parameters
are nested dicts of float32 tensors in ast_tpu's layout (see
``ast_tpu_torch.params``).
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from ast_tpu_torch.symbols import SYMBOLS
from ast_tpu_torch.ops.cnn import conv_frontend
from ast_tpu_torch.ops.fused_decoder import W_NAMES, FusedDecoder
from ast_tpu_torch.ops.fused_infer import (
    greedy_decode_fused, pack_step_weights, require_decode_variant)
from ast_tpu_torch.ops.fused_lstm import (
    ENCODER_TILE, FusedStackedLSTM, fused_stacked_lstm,
    pack_encoder_step_weights, pack_encoder_weights)
from ast_tpu_torch.ops.specaugment import (
    SpecMasks, apply_spec_masks, draw_spec_masks)
from ast_tpu_torch.params import from_jax_numpy


def init_model(mcfg, seed=0, device="cpu"):
    """Seeded (params, state) with the shapes and keys of ast_tpu's
    ``init_model``.  Distributions follow its initialisers (He-normal
    conv, Glorot-uniform input and orthogonal recurrent LSTM weights with
    forget bias 1, LeCun-normal attention and output, N(0, 1) embedding);
    the draws differ from JAX's, since the generators do."""
    rng = np.random.default_rng(seed)
    rnn, cnn = mcfg["rnn_config"], mcfg["cnn_config"]
    require_decode_variant(mcfg)
    hidden = rnn["hidden_units"]
    enc_units = hidden // 2
    E, A, V = rnn["embedding_units"], rnn["attn_units"], rnn["dec_vocab_size"]

    def normal(shape, std):
        return rng.standard_normal(shape).astype(np.float32) * np.float32(std)

    def lstm(in_dim_l, h):
        lim = np.sqrt(6.0 / (in_dim_l + 4 * h))
        q, _ = np.linalg.qr(rng.standard_normal((4 * h, h)))
        b = np.zeros(4 * h, np.float32)
        b[h:2 * h] = 1.0
        return {"wx": rng.uniform(-lim, lim, (in_dim_l, 4 * h)).astype(
                    np.float32),
                "wh": q.T.astype(np.float32), "b": b}

    conv, conv_state, in_ch = [], [], 1
    for layer in cnn["cnn_layers"]:
        out_ch = layer["out_channels"]
        kh, kw = layer["ksize"]
        p = {"w": normal((out_ch, in_ch, kh, kw),
                         np.sqrt(2.0 / (in_ch * kh * kw)))}
        s = {}
        if cnn.get("bn", True):
            p["bn_gamma"] = np.ones(out_ch, np.float32)
            p["bn_beta"] = np.zeros(out_ch, np.float32)
            s["bn_mean"] = np.zeros(out_ch, np.float32)
            s["bn_var"] = np.ones(out_ch, np.float32)
        else:                   # a bias instead of BatchNorm, no state
            p["b"] = np.zeros(out_ch, np.float32)
        conv.append(p)
        conv_state.append(s)
        in_ch = out_ch

    enc = []
    for l in range(rnn["enc_layers"]):
        in_l = cnn["cnn_layers"][-1]["out_channels"] if l == 0 else enc_units
        dirs = [lstm(in_l, enc_units) for _ in range(2)]
        enc.append({k: np.stack([d[k] for d in dirs]) for k in dirs[0]})
    dec = [lstm(E + A if l == 0 else hidden, hidden)
           for l in range(rnn["dec_layers"])]
    params = {
        "cnn": conv,
        "enc": {"lstm": enc, "proj": []},
        "attn": {"wa": [{"w": normal((hidden, hidden), hidden ** -0.5),
                         "b": np.zeros(hidden, np.float32)}],
                 "context": {"w": normal((2 * hidden, A),
                                         (2 * hidden) ** -0.5),
                             "b": np.zeros(A, np.float32)}},
        "dec": {"embed": normal((V, E), 1.0), "lstm": dec,
                "out_w": normal((A, V), A ** -0.5),
                "out_b": np.zeros(V, np.float32)},
    }
    state = {"cnn_bn": conv_state, "enc_proj_bn": []}
    return from_jax_numpy(params, state, device)


def encoder_weights(params):
    """The encoder recurrence's weights as K1 takes them, (wx_rest, wh, b,
    packed): the direction-stacked layers and the layout its products
    read (``fused_lstm.pack_encoder_step_weights``; None at a width the
    kernel does not take, which only the plain version runs).  Made once
    per model for decoding (:func:`decode_weights`)."""
    wx_rest, wh, b = pack_encoder_weights(params["enc"]["lstm"])
    packed = None
    if wh.shape[2] % ENCODER_TILE == 0:
        packed = pack_encoder_step_weights(wx_rest, wh)
    return wx_rest, wh, b, packed


def encoder_inputs(params, state, mcfg, X, train=False, enc_w=None):
    """Conv front-end, direction stacking and the hoisted layer-0
    projection: everything of :func:`encode` before the K1 recurrence.

    X: (B, T, D) float32.  Returns the arguments of
    ``fused_stacked_lstm``: (x0_proj (T', 2, B, 4H_e), wx_rest, wh, b),
    the last three stacked here or, with ``enc_w``
    (:func:`encoder_weights`), taken from it together with the packed
    layout; with ``train`` (batch-statistics BatchNorm) also the new BN
    state."""
    require_decode_variant(mcfg)
    rnn = mcfg["rnn_config"]
    h_cnn, cnn_state = conv_frontend(params["cnn"], state["cnn_bn"],
                                     mcfg["cnn_config"], X, train)
    seq = h_cnn.transpose(0, 1)                          # (T', B, C)
    if rnn.get("ref_rev_quirk", False):
        # the reference's reverse stack consumes X[-i]:
        # [X[0], X[T-1], ..., X[1]]
        rev = torch.cat([seq[:1], seq[1:].flip(0)], dim=0)
    else:
        rev = seq.flip(0)
    xs = torch.stack([seq, rev], dim=1)                  # (T', 2, B, C)
    layers = params["enc"]["lstm"]
    # hoisted layer-0 projection: one large matmul for every step
    x0_proj = torch.matmul(xs, layers[0]["wx"]).contiguous()
    out = (x0_proj,) + (pack_encoder_weights(layers) if enc_w is None
                        else tuple(enc_w))
    if train:
        return out + ({"cnn_bn": cnn_state,
                       "enc_proj_bn": state["enc_proj_bn"]},)
    return out


def encoder_outputs(outs, h_fin, c_fin):
    """K1 outputs -> (enc_states (B, T', 2H_e), dec_h0, dec_c0 (L, B, 2H_e)):
    un-flip the reverse direction and concatenate the two."""
    enc_states = torch.cat([outs[:, 0], outs[:, 1].flip(0)], dim=-1)
    dec_h0 = torch.cat([h_fin[:, 0], h_fin[:, 1]], dim=-1)
    dec_c0 = torch.cat([c_fin[:, 0], c_fin[:, 1]], dim=-1)
    return enc_states.transpose(0, 1).contiguous(), dec_h0, dec_c0


def encode(params, state, mcfg, X, w=None):
    """Conv front-end + stacked biLSTM encoder in eval mode.

    X: (B, T, D) float32.  ``w``: :func:`decode_weights` of ``params``,
    whose encoder weights are then not packed again.  Returns (enc_states
    (B, T', 2H_e), dec_h0 (L, B, 2H_e), dec_c0 (L, B, 2H_e))."""
    return encoder_outputs(*fused_stacked_lstm(*encoder_inputs(
        params, state, mcfg, X, enc_w=None if w is None else w["enc"])))


def pack_decoder_weights(params):
    """Decoder + attention params -> the dict the K5/K6 kernels and their
    plain versions take (ast_tpu's fused layout, no vocab padding)."""
    dec, attn = params["dec"], params["attn"]
    lstm = dec["lstm"]
    H = lstm[0]["wh"].shape[0]
    if len(lstm) > 1:
        wx_rest = torch.stack([l["wx"] for l in lstm[1:]])
    else:
        wx_rest = lstm[0]["wh"].new_zeros((0, H, 4 * H))
    w = {
        "embed": dec["embed"], "wx0": lstm[0]["wx"], "wx_rest": wx_rest,
        "wh": torch.stack([l["wh"] for l in lstm]),
        "b": torch.stack([l["b"] for l in lstm]),
        "wa": attn["wa"][0]["w"], "wa_b": attn["wa"][0]["b"],
        "ctx_w": attn["context"]["w"], "ctx_b": attn["context"]["b"],
        "out_w": dec["out_w"], "out_b": dec["out_b"],
    }
    return {k: v.contiguous() for k, v in w.items()}


def decode_weights(params):
    """The weights that greedy and beam decoding take:
    :func:`pack_decoder_weights` plus, under ``"step"``, the decode step
    kernels' layout (``fused_infer.pack_step_weights``) and, under
    ``"enc"``, the encoder's (:func:`encoder_weights`).  Made once per
    model -- a caller decoding many batches with the same params passes
    it to every batch."""
    w = pack_decoder_weights(params)
    w["step"] = pack_step_weights(w)
    w["enc"] = encoder_weights(params)
    return w


def predict_greedy(params, state, mcfg, X, stop_limit, w=None):
    """Batched greedy decode.  Returns (preds (B, stop_limit) int32,
    n_steps 0-d int32): the steps until every row has produced its first EOS,
    capped at stop_limit.  ``w``: :func:`decode_weights` of ``params``,
    made here when not given."""
    if w is None:
        w = decode_weights(params)
    enc_states, dec_h0, dec_c0 = encode(params, state, mcfg, X, w)
    preds = greedy_decode_fused(enc_states, dec_h0, dec_c0, w, stop_limit)
    is_eos = preds == SYMBOLS.EOS_ID
    per_row = torch.where(is_eos.any(dim=1),
                          is_eos.int().argmax(dim=1) + 1, stop_limit)
    return preds, per_row.max().to(torch.int32)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Draws:
    """The random numbers of one training step, made outside the model so
    that a test can hand ``ast_tpu`` and the port the same ones.

    noise: X-shaped ``speech_noise * N(0, 1)`` (None without noise);
    enc_seed / dec_seed: dropout hash seeds, ints in [0, 2**31 - 1);
    coins: (U-1,) int32 on X's device, 1 = teacher-forced, first and
    last steps forced; replace / rand_ids (``random_out``, else None):
    (U-1, B) bool, the draw ``uniform > random_out``, and (U-1, B) int64
    ids uniform in [N_SPECIAL, V) -- a target that is no special symbol
    becomes its random id where the draw holds; spec (``spec_augment``,
    else None): the SpecAugment masks' starts and widths."""
    noise: Optional[torch.Tensor]
    enc_seed: int
    dec_seed: int
    coins: torch.Tensor
    replace: Optional[torch.Tensor] = None
    rand_ids: Optional[torch.Tensor] = None
    spec: Optional[SpecMasks] = None


def make_draws(seed, X, steps, teach_ratio, add_noise, random_out=0.0,
               vocab=0, spec_cfg=None, frame_len=None):
    """Draws for one step from an int ``seed``: the noise from a
    generator on X's device, everything else from one on the host (no
    device sync), so a run is deterministic on one device.  The optional
    draws (``random_out`` with the vocabulary size ``vocab``; SpecAugment
    with its config block and the rows' true frame counts) come after
    the others in the host stream, which is the same without them."""
    host = torch.Generator().manual_seed(seed)
    noise = None
    if add_noise > 0:
        dev = torch.Generator(device=X.device).manual_seed(seed)
        noise = add_noise * torch.randn(X.shape, generator=dev,
                                        device=X.device)
    enc_seed, dec_seed = torch.randint(0, 2 ** 31 - 1, (2,),
                                       generator=host).tolist()
    idx = torch.arange(steps)
    coins = ((idx == 0) | (idx >= steps - 1)
             | (torch.rand(steps, generator=host) < teach_ratio))
    draws = Draws(noise, enc_seed, dec_seed,
                  coins.to(torch.int32).to(X.device))
    if random_out > 0:
        B = X.shape[0]
        draws.replace = (torch.rand((steps, B), generator=host)
                         > random_out).to(X.device)
        draws.rand_ids = torch.randint(SYMBOLS.N_SPECIAL, vocab, (steps, B),
                                       generator=host).to(X.device)
    if spec_cfg:
        draws.spec = draw_spec_masks(host, X.shape, spec_cfg, frame_len, X)
    return draws


def encode_train(params, state, mcfg, X, draws):
    """Conv front-end + stacked biLSTM encoder in train mode: SpecAugment
    masks, then speech noise, batch-statistics BatchNorm, hash dropout
    seeded by ``draws.enc_seed`` (K1 forward, K2 backward).
    Returns (enc_states, dec_h0, dec_c0, new_state)."""
    if draws.spec is not None:
        X = apply_spec_masks(X, draws.spec)
    if draws.noise is not None:
        X = X * (1.0 + draws.noise)
    x0_proj, wx_rest, wh, b, new_state = encoder_inputs(
        params, state, mcfg, X, train=True)
    out = FusedStackedLSTM.apply(x0_proj, wx_rest, wh, b, draws.enc_seed,
                                 True, float(mcfg["dropout"]["rnn"]))
    return encoder_outputs(*out) + (new_state,)


def sequence_loss(ht, out_w, out_b, target, n_real, label_smoothing=0.0,
                  replace=None, rand_ids=None):
    """One (U*B, A) @ (A, V) logits GEMM, log-softmax and the PAD-masked
    cross-entropy summed over steps and rows, divided by ``n_real``.

    ``replace`` / ``rand_ids`` (see :class:`Draws`) corrupt the targets
    first: the PAD weight is the corrupted target's.  ``label_smoothing``
    eps mixes each token's loss as (1 - eps) * nll + eps * mean over the
    vocabulary of -log p."""
    if replace is not None:
        target = torch.where(replace & (target >= SYMBOLS.N_SPECIAL),
                             rand_ids.to(target.dtype), target)
    logp = torch.log_softmax(torch.matmul(ht, out_w) + out_b, dim=-1)
    nll = -logp.gather(-1, target[..., None].long())[..., 0]
    if label_smoothing > 0:
        nll = ((1.0 - label_smoothing) * nll
               + label_smoothing * -logp.mean(dim=-1))
    return (nll * (target != SYMBOLS.PAD_ID)).sum() / n_real


def forward_loss(params, state, mcfg, X, y, n_real, draws=None, train=True,
                 label_smoothing=0.0, enc_w=None):
    """Sequence loss on the fused path (``ast_tpu``'s ``forward_loss``).
    X (B, T, D); y (B, U) int targets with GO / EOS, PAD-padded; n_real
    the true rows.  Returns (loss, new_state).

    ``train``: scheduled sampling, dropout, noise and target corruption
    from ``draws``, batch-statistics BN, ``label_smoothing``.  Without it
    (the dev loss): the eval-mode encoder (K1 eval, running statistics;
    ``enc_w`` = :func:`encoder_weights` saves packing them per call), K3
    teacher-forced at every step with no dropout, the plain
    cross-entropy; ``draws`` is not read and the state comes back as it
    was."""
    drop = mcfg["dropout"]
    yT = y.t()
    y_in = yT[:-1].to(torch.int32).contiguous()
    if train:
        enc, h0, c0, new_state = encode_train(params, state, mcfg, X, draws)
        coins, seed = draws.coins, draws.dec_seed
        rates = float(drop["embed"]), float(drop["rnn"])
        corrupt = dict(label_smoothing=label_smoothing,
                       replace=draws.replace, rand_ids=draws.rand_ids)
    else:
        enc, h0, c0 = encoder_outputs(*fused_stacked_lstm(*encoder_inputs(
            params, state, mcfg, X, enc_w=enc_w)))
        coins = torch.ones(y_in.shape[0], dtype=torch.int32, device=X.device)
        new_state, seed, rates, corrupt = state, 0, (0.0, 0.0), {}
    w = pack_decoder_weights(params)
    ht, _ = FusedDecoder.apply(enc, h0, c0, *(w[k] for k in W_NAMES), y_in,
                               coins, seed, *rates)
    dec = params["dec"]
    loss = sequence_loss(ht, dec["out_w"], dec["out_b"], yT[1:], n_real,
                         **corrupt)
    return loss, new_state


def weight_noise_targets(params):
    """The leaves that weight noise moves (``ast_tpu``'s
    ``add_weight_noise``): the encoder's LSTM leaves, the decoder's, each
    layer's by sorted name (b, wh, wx: the order JAX flattens a dict
    in), then the decoder embedding."""
    out = []
    for lstm in (params["enc"]["lstm"], params["dec"]["lstm"]):
        for layer in lstm:
            out.extend(layer[k] for k in sorted(layer))
    return out + [params["dec"]["embed"]]


def add_weight_noise(params, mean, sigma, noise):
    """Add ``mean + sigma * n`` in place to each leaf of
    :func:`weight_noise_targets`, ``n`` the N(0, 1) tensor of ``noise``
    at its place.  The trainer does it once an epoch from
    ``extras.weight_noise_iter`` on; the noise stays in the weights."""
    targets = weight_noise_targets(params)
    if len(noise) != len(targets):
        raise ValueError(f"weight noise: {len(noise)} noise tensors for "
                         f"{len(targets)} leaves")
    with torch.no_grad():
        for p, n in zip(targets, noise):
            p.copy_(p + mean + sigma * n.to(p.device))
    return params
