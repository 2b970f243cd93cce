"""Speech encoder-decoder with Luong attention: decoding and the training
loss, each stage routed as ``ast_tpu`` routes it.

The counterpart of ``ast_tpu/models/seq2seq.py``: conv front-end ->
direction-stacked (bi)LSTM encoder -> greedy or beam decoding, and for
training the scheduled-sampling decoder with the PAD-masked
cross-entropy.  Parameters are nested dicts of float32 tensors in
ast_tpu's layout (see ``ast_tpu_torch.params``).

Each stage runs its kernel where ``ast_tpu`` runs its Pallas kernel and
``ast_tpu``'s XLA code as plain PyTorch (autograd for training) on the
caller's device where ``ast_tpu`` does, the predicates being the
counterparts of its conditions:

- conv front-end: plain always (``ops.cnn``, im2col or NCHW);
- encoder recurrence: K1 (eval / train) and K2 when
  :func:`use_fused_encoder`, else the scan encoder
  (:func:`scan_encode`: ``ln``, ``rnn_relu``, ``linear_proj``);
- training decoder: K3 / K4 when :func:`use_fused_decoder`, else the
  scan loss (:func:`scan_decoder_loss` over :func:`decode_step`);
- greedy and beam: K5 / K6 when ``fused_infer.infer_variant_ok``, else
  the same loops over :func:`plain_step` (and beam's attention history,
  ``return_attn``, always there).

The ``fused_encoder`` / ``fused_decoder`` / ``fused_infer`` config flags
are ignored: no config turns a kernel off on the card.

Decoding also runs at ``compute_dtype`` bfloat16 (``ast_tpu``'s
``extras.compute_dtype``): :func:`decode_weights` packs the weights in
bf16, the conv front-end's im2col products and the hoisted layer-0
projection round their operands to bf16 and multiply in f32, K1 eval runs
its bf16 mode, and the encoder states are rounded to bf16 before K5 / K6
(``ops.bf16``).  The model variants routed to the scan path are refused
there by name (``fused_infer.require_bf16_variant``).
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from ast_tpu_torch.symbols import SYMBOLS
from ast_tpu_torch.ops.attention import luong_attention
from ast_tpu_torch.ops.bf16 import BF16, rounded
from ast_tpu_torch.ops.cnn import BN_DECAY, BN_EPS, conv_frontend, conv_out_len
from ast_tpu_torch.ops.dropout import drop_mask
from ast_tpu_torch.ops.embedding import embedding_lookup
from ast_tpu_torch.ops.fused_decoder import (
    W_NAMES, FusedDecoder, embed_drop_mask, rnn_drop_mask)
from ast_tpu_torch.ops.fused_infer import (
    greedy_decode_fused, greedy_reference, infer_variant_ok,
    pack_step_weights, require_bf16_variant)
from ast_tpu_torch.ops.fused_lstm import (
    ENCODER_TILE, FusedStackedLSTM, fused_stacked_lstm,
    pack_encoder_step_weights, pack_encoder_weights, stacked_lstm_reference)
from ast_tpu_torch.ops.lstm import dropout, layernorm, lstm_gates
from ast_tpu_torch.ops.specaugment import (
    SpecMasks, apply_spec_masks, draw_spec_masks)
from ast_tpu_torch.params import from_jax_numpy


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def use_fused_encoder(mcfg):
    """Whether the encoder's recurrence runs K1 (eval and train) and K2:
    ``ast_tpu``'s condition in ``encode`` (no LayerNorm, no rnn_relu) and
    its ``linear_proj`` branch, less the TPU's chunk gate.  Otherwise the
    recurrence is ``ast_tpu``'s scan as plain PyTorch on the caller's
    device, a CUDA device included (:func:`scan_encode`): ``ast_tpu``
    has no Pallas kernel for those variants either."""
    rnn = mcfg["rnn_config"]
    return not (rnn.get("ln", False) or rnn.get("rnn_relu", False)
                or rnn.get("linear_proj", False))


def use_fused_decoder(mcfg, enc_mask=None):
    """Whether the training decoder runs K3 / K4: ``ast_tpu``'s
    ``_use_fused_decoder`` less the TPU's chunk gate, i.e. the variant
    of ``fused_infer.infer_variant_ok`` without output dropout.
    ``linear_proj`` is not excluded.  Otherwise the decoder is
    ``ast_tpu``'s scan loss as plain PyTorch with autograd on the
    caller's device, a CUDA device included
    (:func:`scan_decoder_loss`)."""
    return (infer_variant_ok(mcfg, enc_mask)
            and not mcfg["dropout"].get("out", 0) > 0)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_model(mcfg, seed=0, device="cpu"):
    """Seeded (params, state) with the leaves and shapes of ast_tpu's
    ``init_model`` for every variant: a direction axis on the encoder's
    LSTM leaves only when ``bi_rnn``; ``enc.proj`` and its BN state with
    ``linear_proj``; ``enc.ln`` / ``dec.ln`` with ``ln``; ``enc.embed``
    with an ``enc_vocab_size``; ``n_attn`` heads and a ``(n_attn + 1) H``
    context; a decoder input of E (+ A with ``feed_attn``).
    Distributions follow its initialisers (He-normal conv, Glorot-uniform
    input and orthogonal recurrent LSTM weights with forget bias 1,
    LeCun-normal projections, attention and output, N(0, 1)
    embeddings); the draws differ from JAX's, since the generators do."""
    rng = np.random.default_rng(seed)
    rnn, cnn = mcfg["rnn_config"], mcfg["cnn_config"]
    hidden = rnn["hidden_units"]
    bi = rnn["bi_rnn"]
    n_dirs = 2 if bi else 1
    enc_units = hidden // n_dirs
    E, A, V = rnn["embedding_units"], rnn["attn_units"], rnn["dec_vocab_size"]
    proj_mode = rnn.get("linear_proj", False)

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
        in_l = (cnn["cnn_layers"][-1]["out_channels"] if l == 0
                else hidden if proj_mode else enc_units)
        dirs = [lstm(in_l, enc_units) for _ in range(n_dirs)]
        enc.append({k: np.stack([d[k] for d in dirs]) for k in dirs[0]}
                   if bi else dirs[0])
    dec = [lstm(E + (A if rnn.get("feed_attn", True) else 0) if l == 0
                else hidden, hidden)
           for l in range(rnn["dec_layers"])]
    heads = [{"w": normal((hidden, hidden), hidden ** -0.5),
              "b": np.zeros(hidden, np.float32)}
             for _ in range(rnn.get("n_attn", 1))]
    n_ctx = (len(heads) + 1) * hidden
    params = {
        "cnn": conv,
        "enc": {"lstm": enc, "proj": []},
        "attn": {"wa": heads,
                 "context": {"w": normal((n_ctx, A), n_ctx ** -0.5),
                             "b": np.zeros(A, np.float32)}},
        "dec": {"embed": normal((V, E), 1.0), "lstm": dec,
                "out_w": normal((A, V), A ** -0.5),
                "out_b": np.zeros(V, np.float32)},
    }
    state = {"cnn_bn": conv_state, "enc_proj_bn": []}
    if proj_mode:
        for _ in range(rnn["enc_layers"] - 1):
            params["enc"]["proj"].append({
                "w": normal((hidden, hidden), hidden ** -0.5),
                "b": np.zeros(hidden, np.float32),
                "bn_gamma": np.ones(hidden, np.float32),
                "bn_beta": np.zeros(hidden, np.float32)})
            state["enc_proj_bn"].append({
                "bn_mean": np.zeros(hidden, np.float32),
                "bn_var": np.ones(hidden, np.float32)})
    if rnn.get("enc_vocab_size", 0):
        params["enc"]["embed"] = normal((rnn["enc_vocab_size"], E), 1.0)
    if rnn.get("ln", False):
        params["enc"]["ln"] = [{"g": np.ones((n_dirs, enc_units), np.float32),
                                "b": np.zeros((n_dirs, enc_units),
                                              np.float32)}
                               for _ in range(rnn["enc_layers"])]
        params["dec"]["ln"] = [{"g": np.ones(hidden, np.float32),
                                "b": np.zeros(hidden, np.float32)}
                               for _ in range(rnn["dec_layers"])]
    return from_jax_numpy(params, state, device)


def direction_stacked(layers):
    """Encoder LSTM layers with a leading direction axis: a
    unidirectional encoder's leaves have none (ast_tpu's layout)."""
    return [l if l["wh"].dim() == 3 else {k: v[None] for k, v in l.items()}
            for l in layers]


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encoder_weights(params, dtype=torch.float32):
    """The encoder recurrence's weights as K1 takes them, (wx_rest, wh, b,
    packed): the direction-stacked layers and the layout its products
    read (``fused_lstm.pack_encoder_step_weights``; None at a width the
    kernel does not take, which only the plain version runs).  Made once
    per model for decoding (:func:`decode_weights`); None for a
    ``linear_proj`` encoder, whose layers run one by one on the scan
    path.  ``dtype`` bf16: ``wx_rest``, ``wh`` and the pack in bf16, ``b``
    f32 (``ast_tpu`` casts the two matrices only)."""
    if params["enc"]["proj"]:
        return None
    wx_rest, wh, b = pack_encoder_weights(
        direction_stacked(params["enc"]["lstm"]))
    if dtype == BF16:
        wx_rest, wh = wx_rest.to(BF16), wh.to(BF16)
    packed = None
    if wh.shape[2] % ENCODER_TILE == 0:
        packed = pack_encoder_step_weights(wx_rest, wh)
    return wx_rest, wh, b, packed


def _source(params, X):
    """Speech features as they are; in text-encoder mode (integer token
    ids (B, T)) their embedding rows, without noise."""
    if X.is_floating_point():
        return X
    return embedding_lookup(params["enc"]["embed"], X)


def _direction_stack(seq, bi, rev_quirk=False):
    """(T', B, C) -> (T', D2, B, C): the forward sequence and, with
    ``bi``, the reversed one (with ``rev_quirk`` the reference's
    [X[0], X[T-1], ..., X[1]])."""
    if not bi:
        return seq[:, None]
    if rev_quirk:
        rev = torch.cat([seq[:1], seq[1:].flip(0)], dim=0)
    else:
        rev = seq.flip(0)
    return torch.stack([seq, rev], dim=1)


def encoder_inputs(params, state, mcfg, X, train=False, enc_w=None,
                   compute_dtype=torch.float32):
    """Conv front-end, direction stacking and the hoisted layer-0
    projection: everything of :func:`encode` before the recurrence of a
    stacked encoder.

    X: (B, T, D) float32 features or (B, T) token ids.  Returns the
    arguments of ``fused_stacked_lstm``: (x0_proj (T', D2, B, 4H_e),
    wx_rest, wh, b), the last three stacked here or, with ``enc_w``
    (:func:`encoder_weights`), taken from it together with the packed
    layout; with ``train`` (batch-statistics BatchNorm) also the new BN
    state.  ``compute_dtype`` bf16 (eval): the conv products and the
    layer-0 projection round their operands to bf16, x0_proj stays f32,
    and the recurrence's matrices come in bf16."""
    rnn = mcfg["rnn_config"]
    h_cnn, cnn_state = conv_frontend(params["cnn"], state["cnn_bn"],
                                     mcfg["cnn_config"], _source(params, X),
                                     train, compute_dtype)
    xs = _direction_stack(h_cnn.transpose(0, 1), rnn["bi_rnn"],
                          rnn.get("ref_rev_quirk", False))
    layers = direction_stacked(params["enc"]["lstm"])
    # hoisted layer-0 projection: one large matmul for every step
    wx0 = layers[0]["wx"]
    if compute_dtype == BF16:
        xs, wx0 = rounded(xs), rounded(wx0)
    x0_proj = torch.matmul(xs, wx0).contiguous()
    if enc_w is None:
        enc_w = pack_encoder_weights(layers)
        if compute_dtype == BF16:
            enc_w = (enc_w[0].to(BF16), enc_w[1].to(BF16), enc_w[2])
    out = (x0_proj,) + tuple(enc_w)
    if train:
        return out + ({"cnn_bn": cnn_state,
                       "enc_proj_bn": state["enc_proj_bn"]},)
    return out


def _join_directions(outs):
    """(T', D2, B, H) -> (T', B, D2 H): the reverse direction un-flipped
    and concatenated after the forward one."""
    parts = [outs[:, 0]]
    if outs.shape[1] == 2:
        parts.append(outs[:, 1].flip(0))
    return torch.cat(parts, dim=-1)


def encoder_outputs(outs, h_fin, c_fin):
    """Recurrence outputs -> (enc_states (B, T', D2 H_e), dec_h0, dec_c0
    (L, B, D2 H_e)): the directions joined, for one or two."""
    dec_h0 = torch.cat(h_fin.unbind(1), dim=-1)
    dec_c0 = torch.cat(c_fin.unbind(1), dim=-1)
    return (_join_directions(outs).transpose(0, 1).contiguous(), dec_h0,
            dec_c0)


def _encode_proj(params, state, mcfg, h_cnn, cnn_state, train, seed):
    """The ``linear_proj`` encoder (``ast_tpu``'s ``_encode_proj``): one
    (bi)LSTM layer at a time over the full-width sequence, then Linear +
    BatchNorm (decay 0.9, eps 2e-5, running statistics in
    ``enc_proj_bn``) + ReLU between layers; no reversal quirk.  Layer l's
    dropout mask at step t has the seed ``seed + l T' + t``."""
    rnn = mcfg["rnn_config"]
    rate = float(mcfg["dropout"]["rnn"]) if train else 0.0
    seq = h_cnn.transpose(0, 1)                         # (T', B, C)
    Tp = seq.shape[0]
    layers = direction_stacked(params["enc"]["lstm"])
    proj_state, h0s, c0s = [], [], []
    for l, lp in enumerate(layers):
        x0 = torch.matmul(_direction_stack(seq, rnn["bi_rnn"]), lp["wx"])
        outs, h_fin, c_fin = stacked_lstm_reference(
            x0, lp["wh"].new_zeros((0,) + tuple(lp["wh"].shape)),
            lp["wh"][None], lp["b"][None], train, seed + l * Tp, rate)[:3]
        layer_out = _join_directions(outs)              # (T', B, H)
        h0s.append(torch.cat(h_fin[0].unbind(0), dim=-1))
        c0s.append(torch.cat(c_fin[0].unbind(0), dim=-1))
        if l == len(layers) - 1:
            break
        pp, ps = params["enc"]["proj"][l], state["enc_proj_bn"][l]
        flat = layer_out.reshape(-1, layer_out.shape[-1]) @ pp["w"] + pp["b"]
        if train:
            mean, var = flat.mean(dim=0), flat.var(dim=0, correction=0)
            ps = {"bn_mean": (BN_DECAY * ps["bn_mean"]
                              + (1 - BN_DECAY) * mean).detach(),
                  "bn_var": (BN_DECAY * ps["bn_var"]
                             + (1 - BN_DECAY) * var).detach()}
        else:
            mean, var = ps["bn_mean"], ps["bn_var"]
        flat = (flat - mean) * torch.rsqrt(var + BN_EPS)
        flat = flat * pp["bn_gamma"] + pp["bn_beta"]
        seq = torch.relu(flat).reshape(layer_out.shape)
        proj_state.append(ps)
    return (layer_out.transpose(0, 1).contiguous(), torch.stack(h0s),
            torch.stack(c0s), {"cnn_bn": cnn_state, "enc_proj_bn": proj_state})


def scan_encode(params, state, mcfg, X, train=False, seed=0):
    """``ast_tpu``'s scan encoder as plain PyTorch with autograd, on X's
    device: the stacked recurrence with ``ln`` / ``rnn_relu``
    (``fused_lstm.stacked_lstm_reference``, K1's plain version) or the
    ``linear_proj`` layers.  ``train``: batch-statistics BatchNorm and
    hash dropout at ``dropout.rnn`` seeded by ``seed`` -- for the stacked
    encoder the masks K1 draws.  Returns (enc_states, dec_h0, dec_c0,
    new_state)."""
    rnn = mcfg["rnn_config"]
    rate = float(mcfg["dropout"]["rnn"]) if train else 0.0
    if rnn.get("linear_proj", False):
        h_cnn, cnn_state = conv_frontend(
            params["cnn"], state["cnn_bn"], mcfg["cnn_config"],
            _source(params, X), train)
        return _encode_proj(params, state, mcfg, h_cnn, cnn_state, train,
                            seed)
    enc_in = encoder_inputs(params, state, mcfg, X, train=train)
    ln = None
    if rnn.get("ln", False):
        ln = [(p["g"], p["b"]) for p in params["enc"]["ln"]]
    out = stacked_lstm_reference(*enc_in[:4], train, seed, rate, ln,
                                 rnn.get("rnn_relu", False))
    return encoder_outputs(*out[:3]) + (enc_in[4] if train else state,)


def _encode_eval(params, state, mcfg, X, enc_w=None,
                 compute_dtype=torch.float32):
    if not use_fused_encoder(mcfg):
        return scan_encode(params, state, mcfg, X)[:3]
    return encoder_outputs(*fused_stacked_lstm(*encoder_inputs(
        params, state, mcfg, X, enc_w=enc_w, compute_dtype=compute_dtype)))


def encode(params, state, mcfg, X, w=None, compute_dtype=torch.float32):
    """Conv front-end + encoder in eval mode, routed by
    :func:`use_fused_encoder`.

    X: (B, T, D) float32 or (B, T) token ids.  ``w``:
    :func:`decode_weights` of ``params`` at ``compute_dtype``, whose
    encoder weights are then not packed again.  Returns (enc_states (B,
    T', H), dec_h0 (L, B, H), dec_c0 (L, B, H)), all f32."""
    if w is not None:
        _check_weights_dtype(w, compute_dtype)
    return _encode_eval(params, state, mcfg, X,
                        None if w is None else w["enc"], compute_dtype)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def pack_decoder_weights(params, dtype=torch.float32):
    """Decoder + attention params -> the dict the K5/K6 kernels and their
    plain versions take (ast_tpu's fused layout, no vocab padding; the
    first attention head).  ``dtype`` bf16: every leaf cast to bf16,
    biases and the embedding too, as ``ast_tpu``'s
    ``pack_decoder_weights(params, bf16, Vp)``."""
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
    if dtype == BF16:
        return {k: v.to(BF16).contiguous() for k, v in w.items()}
    return {k: v.contiguous() for k, v in w.items()}


def decode_weights(params, dtype=torch.float32):
    """The weights that greedy and beam decoding take:
    :func:`pack_decoder_weights` plus, under ``"step"``, the decode step
    kernels' layout (``fused_infer.pack_step_weights``) and, under
    ``"enc"``, the encoder's (:func:`encoder_weights`), all at the
    compute ``dtype``.  Made once per model -- a caller decoding many
    batches with the same params passes it to every batch."""
    w = pack_decoder_weights(params, dtype)
    w["step"] = pack_step_weights(w)
    w["enc"] = encoder_weights(params, dtype)
    return w


def _check_weights_dtype(w, compute_dtype):
    """Raise unless ``w`` (:func:`decode_weights`) was made at
    ``compute_dtype``: bf16 or not."""
    if (w["wh"].dtype == BF16) != (compute_dtype == BF16):
        raise ValueError(f"decode weights in {w['wh'].dtype}, compute "
                         f"dtype {compute_dtype}: make them with "
                         f"decode_weights(params, {compute_dtype})")


def init_decoder_carry(mcfg, dec_h0, dec_c0):
    """Decoder state from the encoder's final states and a zero
    attentional vector: {"h", "c": (L, B, H), "ht": (B, A)}."""
    return {"h": dec_h0, "c": dec_c0,
            "ht": dec_h0.new_zeros((dec_h0.shape[1],
                                    mcfg["rnn_config"]["attn_units"]))}


def decode_step(params, mcfg, enc_states, carry, token, drop=None,
                enc_mask=None):
    """One decoder step of any variant (``ast_tpu``'s ``decode_step``):
    embedding, input feeding (``feed_attn``), the L-layer LSTM with
    dropout, LayerNorm and ReLU on each layer's output as configured,
    ``n_attn``-head attention (masked, blockwise) and the logits with
    output dropout.

    carry: {"h", "c": (L, B, H), "ht": (B, A)}; token (B,) int.  ``drop``:
    None in eval mode, else ``(draws, t)``: the step's dropout masks are
    K3's hash masks of step t under ``draws.dec_seed`` for the embedding
    and the LSTM outputs, and ``draws.out_seed(t)``'s over (B, V) for the
    logits.  Returns (logits (B, V), new carry, alphas (B, T') of the
    first head)."""
    rnn, rates, dec = mcfg["rnn_config"], mcfg["dropout"], params["dec"]
    B, dev = token.shape[0], enc_states.device
    x = embedding_lookup(dec["embed"], token)
    if drop is not None and rates["embed"] > 0:
        draws, t = drop
        x = dropout(x, embed_drop_mask(rates["embed"], draws.dec_seed, t, B,
                                       x.shape[1], dev), rates["embed"])
    if rnn.get("feed_attn", True):
        x = torch.cat([x, carry["ht"]], dim=-1)
    L, H = len(dec["lstm"]), rnn["hidden_units"]
    new_h, new_c = [], []
    for l, lp in enumerate(dec["lstm"]):
        z = x @ lp["wx"] + carry["h"][l] @ lp["wh"] + lp["b"]
        h, c = lstm_gates(z, carry["c"][l], H)
        x = h
        if drop is not None and rates["rnn"] > 0:
            draws, t = drop
            x = dropout(x, rnn_drop_mask(rates["rnn"], draws.dec_seed, t, l,
                                         L, B, H, dev), rates["rnn"])
        if rnn.get("ln", False):
            x = layernorm(x, dec["ln"][l]["g"], dec["ln"][l]["b"])
        if rnn.get("rnn_relu", False):
            x = torch.relu(x)
        new_h.append(h)
        new_c.append(c)
    attn = params["attn"]
    ht, alphas = luong_attention(
        enc_states, x, [(a["w"], a["b"]) for a in attn["wa"]],
        attn["context"]["w"], attn["context"]["b"], enc_mask,
        rnn.get("attn_block_size", 0))
    logits = ht @ dec["out_w"] + dec["out_b"]
    rate = rates.get("out", 0)
    if drop is not None and rate > 0:
        draws, t = drop
        keep = drop_mask(tuple(logits.shape), rate, draws.out_seed(t),
                         row_axis=0, device=dev)
        logits = dropout(logits, keep, rate)
    return (logits, {"h": torch.stack(new_h), "c": torch.stack(new_c),
                     "ht": ht}, alphas)


def plain_step(params, mcfg, enc_mask=None):
    """:func:`decode_step` in eval mode as the decode loops
    (``fused_infer.greedy_reference`` / ``beam_reference``) take it:
    ``(enc_rows, h, c, ht, tok) -> (logits, h, c, ht, alphas)``.
    ``enc_mask``: (rows, T') for the rows the loop runs."""
    def step(enc, h, c, ht, tok):
        logits, carry, alphas = decode_step(
            params, mcfg, enc, {"h": h, "c": c, "ht": ht}, tok,
            enc_mask=enc_mask)
        return logits, carry["h"], carry["c"], carry["ht"], alphas
    return step


def predict_greedy(params, state, mcfg, X, stop_limit, w=None,
                   enc_mask=None, compute_dtype=torch.float32):
    """Batched greedy decode: K5 when ``infer_variant_ok``, else the same
    loop over :func:`plain_step` (``ast_tpu``'s while loop).  Returns
    (preds (B, stop_limit) int32, n_steps 0-d int32): the steps until
    every row has produced its first EOS, capped at stop_limit.  ``w``:
    :func:`decode_weights` of ``params`` at ``compute_dtype``, made here
    when not given; ``enc_mask`` (B, T') (:func:`make_enc_mask`).  At
    bf16 the encoder states are rounded to bf16 before K5, as in
    ``ast_tpu``."""
    require_bf16_variant(mcfg, compute_dtype,
                         [] if enc_mask is None else ["enc_mask"])
    if w is None:
        w = decode_weights(params, compute_dtype)
    enc_states, dec_h0, dec_c0 = encode(params, state, mcfg, X, w,
                                        compute_dtype)
    if compute_dtype == BF16:
        enc_states = enc_states.to(BF16)
    if infer_variant_ok(mcfg, enc_mask):
        preds = greedy_decode_fused(enc_states, dec_h0, dec_c0, w,
                                    stop_limit)
    else:
        preds = greedy_reference(enc_states, dec_h0, dec_c0, w, stop_limit,
                                 plain_step(params, mcfg, enc_mask))
    is_eos = preds == SYMBOLS.EOS_ID
    per_row = torch.where(is_eos.any(dim=1),
                          is_eos.int().argmax(dim=1) + 1, stop_limit)
    return preds, per_row.max().to(torch.int32)


def make_enc_mask(mcfg, x_len, Tp):
    """(B,) true frame lengths (int tensor) -> (B, Tp) bool encoder mask:
    the frames ``conv_out_len`` keeps, max-pool ceilings included."""
    t = conv_out_len(mcfg["cnn_config"], x_len)
    return torch.arange(Tp, device=x_len.device)[None, :] < t[:, None]


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

    def out_seed(self, t):
        """The hash seed of step t's output-dropout mask over (B, V),
        ``dec_seed + 2 (steps + t)``: an even offset past every
        embedding seed of K3's (``dec_seed + 2t``, t < steps) and never
        one of its odd LSTM seeds, so the stream repeats none of the
        decoder's."""
        return self.dec_seed + 2 * (self.coins.shape[0] + t)


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
    if add_noise > 0 and X.is_floating_point():     # no noise on token ids
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
    """Conv front-end + encoder in train mode: SpecAugment masks, then
    speech noise (speech only), batch-statistics BatchNorm, hash dropout
    seeded by ``draws.enc_seed`` -- K1 forward and K2 backward when
    :func:`use_fused_encoder`, else :func:`scan_encode` with autograd.
    Returns (enc_states, dec_h0, dec_c0, new_state)."""
    if draws.spec is not None:
        X = apply_spec_masks(X, draws.spec)
    if draws.noise is not None:
        X = X * (1.0 + draws.noise)
    if not use_fused_encoder(mcfg):
        return scan_encode(params, state, mcfg, X, True, draws.enc_seed)
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
    return logits_loss(torch.matmul(ht, out_w) + out_b, target, n_real,
                       label_smoothing, replace, rand_ids)


def logits_loss(logits, target, n_real, label_smoothing=0.0, replace=None,
                rand_ids=None):
    """:func:`sequence_loss` from the logits (U, B, V)."""
    if replace is not None:
        target = torch.where(replace & (target >= SYMBOLS.N_SPECIAL),
                             rand_ids.to(target.dtype), target)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, target[..., None].long())[..., 0]
    if label_smoothing > 0:
        nll = ((1.0 - label_smoothing) * nll
               + label_smoothing * -logp.mean(dim=-1))
    return (nll * (target != SYMBOLS.PAD_ID)).sum() / n_real


def scan_decoder_loss(params, mcfg, enc, h0, c0, y, n_real, draws=None,
                      label_smoothing=0.0, enc_mask=None):
    """``ast_tpu``'s scan loss (``forward_loss``'s ``lax.scan``) as plain
    PyTorch with autograd, on enc's device: :func:`decode_step` over the
    U - 1 steps, each step's input the teacher's token where
    ``draws.coins`` holds and else the argmax of the step before's
    logits (after output dropout), then the cross-entropy of
    :func:`logits_loss` with ``draws``' target corruption and
    ``label_smoothing``.  ``draws`` None: eval mode (every step forced,
    no dropout, plain cross-entropy).  Returns the loss."""
    yT = y.t()
    steps = yT.shape[0] - 1
    coins = [1] * steps if draws is None else draws.coins.tolist()
    carry = init_decoder_carry(mcfg, h0, c0)
    prev, logits = None, []
    for t in range(steps):
        tok = yT[t] if coins[t] else prev
        lg, carry, _ = decode_step(params, mcfg, enc, carry, tok,
                                   None if draws is None else (draws, t),
                                   enc_mask)
        if t + 1 < steps and not coins[t + 1]:
            prev = torch.argmax(lg, dim=-1)
        logits.append(lg)
    corrupt = {} if draws is None else dict(
        label_smoothing=label_smoothing, replace=draws.replace,
        rand_ids=draws.rand_ids)
    return logits_loss(torch.stack(logits), yT[1:], n_real, **corrupt)


def forward_loss(params, state, mcfg, X, y, n_real, draws=None, train=True,
                 label_smoothing=0.0, enc_w=None, enc_mask=None):
    """Sequence loss (``ast_tpu``'s ``forward_loss``), each stage routed
    (:func:`use_fused_encoder`, :func:`use_fused_decoder`).  X (B, T, D)
    or (B, T) token ids; y (B, U) int targets with GO / EOS, PAD-padded;
    n_real the true rows; ``enc_mask`` (B, T') (:func:`make_enc_mask`).
    Returns (loss, new_state).

    ``train``: scheduled sampling, dropout, noise and target corruption
    from ``draws``, batch-statistics BN, ``label_smoothing``.  Without it
    (the dev loss): the eval-mode encoder (running statistics; ``enc_w``
    = :func:`encoder_weights` saves packing K1's weights per call), every
    step teacher-forced with no dropout, the plain cross-entropy;
    ``draws`` is not read and the state comes back as it was."""
    drop = mcfg["dropout"]
    yT = y.t()
    if train:
        enc, h0, c0, new_state = encode_train(params, state, mcfg, X, draws)
    else:
        enc, h0, c0 = _encode_eval(params, state, mcfg, X, enc_w)
        new_state = state
    if not use_fused_decoder(mcfg, enc_mask):
        loss = scan_decoder_loss(params, mcfg, enc, h0, c0, y, n_real,
                                 draws if train else None, label_smoothing,
                                 enc_mask)
        return loss, new_state
    y_in = yT[:-1].to(torch.int32).contiguous()
    if train:
        coins, seed = draws.coins, draws.dec_seed
        rates = float(drop["embed"]), float(drop["rnn"])
        corrupt = dict(label_smoothing=label_smoothing,
                       replace=draws.replace, rand_ids=draws.rand_ids)
    else:
        coins = torch.ones(y_in.shape[0], dtype=torch.int32, device=X.device)
        seed, rates, corrupt = 0, (0.0, 0.0), {}
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
