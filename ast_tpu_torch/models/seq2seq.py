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
  (:func:`scan_encode`: ``ln``, ``rnn_relu``, ``linear_proj``, or units
  a direction the kernels do not take);
- training decoder: K3 / K4 when :func:`use_fused_decoder` at the call's
  T', else the scan loss (:func:`scan_decoder_loss` over
  :func:`decode_step`);
- greedy and beam: K5 / K6 when :func:`use_fused_infer` at the call's
  B, T', N and K, else the same loops over :func:`plain_step` (and
  beam's attention history, ``return_attn``, always there).

Each predicate is the variant's condition and, on a CUDA device, the
kernels' shape gate (``fused_lstm.encoder_shapes_ok``,
``fused_decoder.train_shapes_ok``, ``fused_infer.decode_shapes_ok``:
the conditions under which the kernels raise), as ``ast_tpu`` gates its
kernels by variant and chunk size; so a model of any width runs on the
card, and a stage its kernels do not take runs plain, as on
``ast_tpu``'s scan path.  A CPU tensor takes each kernel's plain version
at any shape, as ``ast_tpu``'s interpret mode passes its alignment gate.

The ``fused_encoder`` / ``fused_decoder`` / ``fused_infer`` config flags
are ignored: no config turns a kernel off on the card.

Optional keys beyond ``ast_tpu``'s (their defaults are its model):
``rnn_config.enc_units`` (the encoder's units a direction, default
``hidden_units // directions``), ``rnn_config.enc_stacking``
(``"direction"``, the default: a stack a direction, joined at the top;
``"joint"``: every layer above 0 reads both directions' outputs of the
layer below, as a Listen-Attend-Spell listener), and a first conv layer
of ``in_channels`` planes (``ops.cnn``).  The encoder states are then
He = directions * ``enc_units`` wide, apart from the decoder's H: the
attention's ``wa`` is (H, He) and its context layer reads ``[cv (He a
head); h (H)]``.  The decoder starts from the encoder's final states
where they are its shape (as many layers, He == H), else from zeros.

A jointly stacked encoder (:func:`joint_encode`) runs layer by layer:
the layer's input product over the whole sequence, one time-batched
GEMM a direction, then K1 (train or eval) and, backward, K2 at one
layer over both directions (:class:`JointLayer`).  Layer l's dropout
masks are K1's at the seed ``enc_seed + l T'``: step t's mask over
(directions, rows, units) has the seed ``enc_seed + l T' + t``.  At
bf16 its input product and its gradients' products take bf16 operands
on the tensor cores and give bf16 (``torch.matmul`` of bf16 tensors),
the recurrence K1's / K2's bf16 modes.

Spans and counters (``utils.profiling``): ``train.enc_layer`` around
each joint layer's forward and backward; ``train.plain_stages`` counts a
training step's stages that took their plain route (the encoder's scan,
the decoder's scan loss).

Data parallelism (``ast_tpu_torch.parallel``): a rank's training step
runs on its rows of the global batch.  :func:`make_draws` draws at the
global batch's shape and keeps the rank's rows, and the draws carry the
rows' place (``Draws.row_offset``, ``global_rows``), which every dropout
mask hashes, as ``ast_tpu``'s kernels hash global row ids under
``shard_map``; the ``mesh`` of :func:`forward_loss` makes the conv
front-end's and ``linear_proj``'s batch-statistics BN the global
batch's (``ops.cnn.batch_moments``).  The routing predicates see the
local batch, as ``ast_tpu``'s gates see a shard's (``_n_data_shards``).

Every variant decodes and trains at ``compute_dtype`` bfloat16 too
(``ast_tpu``'s ``extras.compute_dtype``; ``ops.bf16``), each stage with
the rounding points of its route in ``ast_tpu``.  On every route the
conv front-end's im2col products and the hoisted layer-0 projection
round their operands to bf16 and multiply in f32 (under autograd the
rounding also rounds the gradients that reach the operands, as XLA's
transpose of a bf16 product does).  The kernel stages: K1-K6 run their
bf16 modes; the decoder takes its weights in bf16
(:func:`pack_decoder_weights`, :func:`decode_weights`) and the encoder
states rounded to bf16; the loss logits are an f32 product of the
rounded ``ht`` and ``out_w`` plus the f32 ``out_b``.  The scan stages
(``ast_tpu``'s XLA code): the stacked scan encoder multiplies a layer's
rounded input by its rounded ``wx`` and keeps ``h @ wh`` in f32
(``fused_lstm.stacked_lstm_reference``'s ``compute_dtype``);
``linear_proj``'s layers, projections and BN run in f32 after the bf16
conv, as ``ast_tpu``'s ``_encode_proj`` ignores the dtype;
:func:`decode_step` rounds ``[emb; ht]`` and ``wx`` (``h @ wh`` f32), the
attention's rounding points (``ops.attention``) and ``ht`` and
``out_w`` for the logits, each at every step.  A kernel stage's f32
outputs feed a scan stage as they are, and the scan encoder's states
are rounded to bf16 for K3, K5 and K6.  The parameters, the BN state
and the optimizer stay f32.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from ast_tpu_torch.symbols import SYMBOLS
from ast_tpu_torch.ops.attention import luong_attention
from ast_tpu_torch.ops.bf16 import BF16, rounded, scan_dot, widen
from ast_tpu_torch.ops.cnn import (
    BN_DECAY, BN_EPS, batch_moments, conv_frontend, conv_out_dim,
    conv_out_len, input_planes)
from ast_tpu_torch.ops.dropout import drop_mask
from ast_tpu_torch.ops.embedding import embedding_lookup
from ast_tpu_torch.ops.fused_decoder import (
    W_NAMES, FusedDecoder, embed_drop_mask, rnn_drop_mask, train_shapes_ok)
from ast_tpu_torch.ops.fused_infer import (
    decode_shapes_ok, greedy_decode_fused, greedy_reference,
    infer_variant_ok, on_card, pack_decode_step)
from ast_tpu_torch.ops import fused_lstm
from ast_tpu_torch.ops.fused_lstm import (
    FusedStackedLSTM, encoder_shapes_ok, fused_stacked_lstm,
    pack_encoder_step_weights, pack_encoder_weights, stacked_lstm_reference)
from ast_tpu_torch.ops.lstm import dropout, layernorm, lstm_gates
from ast_tpu_torch.ops.specaugment import (
    SpecMasks, apply_spec_masks, draw_spec_masks)
from ast_tpu_torch.params import from_jax_numpy
from ast_tpu_torch.utils.profiling import count, span
from ast_tpu_torch.parallel.tp import gathered_params, vocab_parallel_loss


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def encoder_dims(mcfg):
    """(directions, units a direction, stacking) of the encoder, with the
    optional keys' defaults (module docstring)."""
    rnn = mcfg["rnn_config"]
    n_dirs = 2 if rnn["bi_rnn"] else 1
    stacking = rnn.get("enc_stacking", "direction")
    if stacking not in ("direction", "joint"):
        raise ValueError(f"enc_stacking {stacking!r}: direction | joint")
    if stacking == "joint" and any(rnn.get(k, False) for k in (
            "ln", "rnn_relu", "linear_proj")):
        raise ValueError("enc_stacking joint takes no ln, rnn_relu or "
                         "linear_proj")
    units = rnn.get("enc_units") or rnn["hidden_units"] // n_dirs
    return n_dirs, int(units), stacking


def enc_width(mcfg):
    """He, the width of the encoder states the attention reads:
    directions * ``enc_units`` where the config sets them, else
    ``hidden_units`` (``ast_tpu``'s)."""
    rnn = mcfg["rnn_config"]
    if not rnn.get("enc_units"):
        return rnn["hidden_units"]
    n_dirs, units, _ = encoder_dims(mcfg)
    return n_dirs * units


def use_fused_encoder(mcfg, device):
    """Whether the encoder's recurrence on ``device`` runs K1 (eval and
    train) and K2: ``ast_tpu``'s condition in ``encode`` (no LayerNorm,
    no rnn_relu) and its ``linear_proj`` branch, and on a CUDA device the
    kernels' shape gate (``fused_lstm.encoder_shapes_ok`` of the units a
    direction), as ``ast_tpu`` gates its kernel by ``fused_chunk_size``
    (``fused_infer.on_card``: a CPU tensor takes the kernels' plain
    versions at any width).  Otherwise the recurrence is ``ast_tpu``'s
    scan as plain PyTorch on the caller's device, a CUDA device included
    (:func:`scan_encode`): ``ast_tpu`` takes its scan path there too."""
    rnn = mcfg["rnn_config"]
    units = encoder_dims(mcfg)[1]
    return not (rnn.get("ln", False) or rnn.get("rnn_relu", False)
                or rnn.get("linear_proj", False)
                or on_card(device) and not encoder_shapes_ok(units))


def use_fused_decoder(mcfg, device, enc_mask=None, T=0):
    """Whether the training decoder on ``device`` runs K3 / K4 on a call
    over ``T`` encoder frames: ``ast_tpu``'s ``_use_fused_decoder``,
    i.e. the variant of ``fused_infer.infer_variant_ok`` without output
    dropout, and on a CUDA device the kernels' shape gate
    (``fused_decoder.train_shapes_ok``; ``T`` 0 gates the widths alone)
    in the place of its chunk gate.  ``linear_proj`` is not excluded.
    Otherwise the decoder is ``ast_tpu``'s scan loss as plain PyTorch
    with autograd on the caller's device, a CUDA device included
    (:func:`scan_decoder_loss`)."""
    rnn = mcfg["rnn_config"]
    return (infer_variant_ok(mcfg, enc_mask)
            and not mcfg["dropout"].get("out", 0) > 0
            and not (on_card(device) and not train_shapes_ok(
                T, rnn["hidden_units"], rnn["embedding_units"],
                rnn["attn_units"], enc_width(mcfg))))


def use_fused_infer(mcfg, device, B, T, N=1, K=1, enc_mask=None):
    """Whether greedy (N = 1) or beam decoding of B utterances of T
    encoder frames on ``device`` runs K5 / K6:
    ``fused_infer.infer_variant_ok`` and on a CUDA device the kernels'
    shape gate at this call's B, T, N and K
    (``fused_infer.decode_shapes_ok``: ``ast_tpu``'s
    ``_fused_infer_chunk`` and its beam's ``fused_chunk``).  Otherwise
    the same loop runs over :func:`plain_step`."""
    rnn = mcfg["rnn_config"]
    return (infer_variant_ok(mcfg, enc_mask)
            and not (on_card(device) and not decode_shapes_ok(
                B, T, rnn["hidden_units"], rnn["embedding_units"],
                rnn["attn_units"], N, K, enc_width(mcfg))))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_model(mcfg, seed=0, device="cpu"):
    """Seeded (params, state) with the leaves and shapes of ast_tpu's
    ``init_model`` for every variant: a direction axis on the encoder's
    LSTM leaves only when ``bi_rnn``; ``enc.proj`` and its BN state with
    ``linear_proj``; ``enc.ln`` / ``dec.ln`` with ``ln``; ``enc.embed``
    with an ``enc_vocab_size``; ``n_attn`` heads (H, He) and an
    ``n_attn He + H`` context; a decoder input of E (+ A with
    ``feed_attn``); a first conv layer of ``in_channels`` planes; a
    jointly stacked encoder's layers above 0 reading directions *
    ``enc_units`` (module docstring).
    Distributions follow its initialisers (He-normal conv, Glorot-uniform
    input and orthogonal recurrent LSTM weights with forget bias 1,
    LeCun-normal projections, attention and output, N(0, 1)
    embeddings); the draws differ from JAX's, since the generators do."""
    rng = np.random.default_rng(seed)
    rnn, cnn = mcfg["rnn_config"], mcfg["cnn_config"]
    hidden = rnn["hidden_units"]
    bi = rnn["bi_rnn"]
    n_dirs, enc_units, stacking = encoder_dims(mcfg)
    He = enc_width(mcfg)
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

    conv, conv_state, in_ch = [], [], input_planes(cnn)
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
        in_l = (conv_out_dim(cnn) if l == 0
                else n_dirs * enc_units if stacking == "joint"
                else hidden if proj_mode else enc_units)
        dirs = [lstm(in_l, enc_units) for _ in range(n_dirs)]
        enc.append({k: np.stack([d[k] for d in dirs]) for k in dirs[0]}
                   if bi else dirs[0])
    dec = [lstm(E + (A if rnn.get("feed_attn", True) else 0) if l == 0
                else hidden, hidden)
           for l in range(rnn["dec_layers"])]
    heads = [{"w": normal((hidden, He), hidden ** -0.5),
              "b": np.zeros(He, np.float32)}
             for _ in range(rnn.get("n_attn", 1))]
    n_ctx = len(heads) * He + hidden
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

def encoder_weights(params, dtype=torch.float32, mcfg=None):
    """The encoder recurrence's weights as K1 takes them, (wx_rest, wh, b,
    packed): the direction-stacked layers and the layout its products
    read (``fused_lstm.pack_encoder_step_weights``; None at a width the
    kernel does not take, which only the plain version runs).  Made once
    per model for decoding (:func:`decode_weights`); None for a
    ``linear_proj`` encoder, whose layers run one by one on the scan
    path.  ``dtype`` bf16: ``wx_rest``, ``wh`` and the pack in bf16 (the
    pack in the tensor cores' tile order), ``b`` f32 (``ast_tpu`` casts the
    two matrices only).  None too where ``mcfg`` stacks the encoder
    jointly (:func:`encoder_dims`; None: the default stacking), whose
    layers :func:`joint_encode` runs one by one."""
    if params["enc"]["proj"] or (mcfg is not None
                                 and encoder_dims(mcfg)[2] == "joint"):
        return None
    wx_rest, wh, b = pack_encoder_weights(
        direction_stacked(params["enc"]["lstm"]))
    if dtype == BF16:
        wx_rest, wh = wx_rest.to(BF16), wh.to(BF16)
    packed = None
    if encoder_shapes_ok(wh.shape[2]):
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
                   compute_dtype=torch.float32, mesh=None):
    """Conv front-end, direction stacking and the hoisted layer-0
    projection: everything of :func:`encode` before the recurrence of a
    stacked encoder.

    X: (B, T, D) float32 features or (B, T) token ids.  Returns the
    arguments of ``fused_stacked_lstm``: (x0_proj (T', D2, B, 4H_e),
    wx_rest, wh, b), the last three stacked here or, with ``enc_w``
    (:func:`encoder_weights`), taken from it together with the packed
    layout; with ``train`` (batch-statistics BatchNorm) also the new BN
    state.  ``compute_dtype`` bf16: the conv products and the layer-0
    projection round their operands to bf16, x0_proj stays f32, and the
    recurrence's matrices come in bf16 -- in eval mode; with ``train``
    they stay f32, for ``FusedStackedLSTM`` to cast (its ``dtype``), so
    that their gradients are not rounded.  ``mesh``: the data axis whose
    global batch the BN statistics are (train mode)."""
    rnn = mcfg["rnn_config"]
    h_cnn, cnn_state = conv_frontend(params["cnn"], state["cnn_bn"],
                                     mcfg["cnn_config"], _source(params, X),
                                     train, compute_dtype, mesh)
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
        if compute_dtype == BF16 and not train:
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


def decoder_start(mcfg, h0, c0):
    """The decoder's initial (h, c), (L_dec, B, H): the encoder's final
    states (L_enc, B, He) where they are that shape, else zeros (a
    listener of other depth or width than its speller)."""
    rnn = mcfg["rnn_config"]
    L, H = rnn["dec_layers"], rnn["hidden_units"]
    if h0.shape[0] == L and h0.shape[2] == H:
        return h0, c0
    shape = (L, h0.shape[1], H)
    return h0.new_zeros(shape), c0.new_zeros(shape)


def encoder_outputs(outs, h_fin, c_fin):
    """Recurrence outputs -> (enc_states (B, T', D2 H_e), dec_h0, dec_c0
    (L, B, D2 H_e)): the directions joined, for one or two."""
    dec_h0 = torch.cat(h_fin.unbind(1), dim=-1)
    dec_c0 = torch.cat(c_fin.unbind(1), dim=-1)
    return (_join_directions(outs).transpose(0, 1).contiguous(), dec_h0,
            dec_c0)


def _encode_proj(params, state, mcfg, h_cnn, cnn_state, train, seed,
                 rows=(0, None), mesh=None):
    """The ``linear_proj`` encoder (``ast_tpu``'s ``_encode_proj``): one
    (bi)LSTM layer at a time over the full-width sequence, then Linear +
    BatchNorm (decay 0.9, eps 2e-5, running statistics in
    ``enc_proj_bn``; the global batch's under ``mesh``) + ReLU between
    layers; no reversal quirk.  Layer l's dropout mask at step t has the
    seed ``seed + l T' + t``, over the global rows ``rows`` (row_offset,
    global_rows).  f32 at either compute dtype: ``ast_tpu``'s takes
    ``compute_dtype`` and reads none of it (only the conv front-end
    before it runs at bf16)."""
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
            lp["wh"][None], lp["b"][None], train, seed + l * Tp, rate,
            row_offset=rows[0], global_rows=rows[1])[:3]
        layer_out = _join_directions(outs)              # (T', B, H)
        h0s.append(torch.cat(h_fin[0].unbind(0), dim=-1))
        c0s.append(torch.cat(c_fin[0].unbind(0), dim=-1))
        if l == len(layers) - 1:
            break
        pp, ps = params["enc"]["proj"][l], state["enc_proj_bn"][l]
        flat = layer_out.reshape(-1, layer_out.shape[-1]) @ pp["w"] + pp["b"]
        if train:
            mean, var = batch_moments(flat, (0,), mesh)
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


def _layer_operands(seq, wx, bi, dtype):
    """A joint layer's input product's operands: its input by direction,
    (D2, T' B, C) -- the sequence and, with ``bi``, the reversed one --
    and ``wx`` (D2, C, 4He), both in bf16 at ``dtype`` bf16."""
    Tp, B, C = seq.shape
    xs = torch.stack([seq, seq.flip(0)] if bi else [seq]).reshape(
        -1, Tp * B, C)
    if dtype == BF16:
        return xs.to(BF16), wx.to(BF16)
    return xs, wx


def _layer_proj(xs, wx_c, Tp):
    """The input product, one GEMM a direction: (D2, T' B, C) @ (D2, C,
    4He) -> (T', D2, B, 4He) f32, as K1 takes it."""
    proj = torch.bmm(xs, wx_c).float()
    return proj.unflatten(1, (Tp, -1)).transpose(0, 1).contiguous()


def _undirection(dxs, Tp):
    """The gradient of :func:`_layer_operands`' input: (D2, T' B, C) ->
    (T', B, C), the reverse direction's flipped back and added."""
    dxs = dxs.unflatten(1, (Tp, -1))
    out = dxs[0]
    if dxs.shape[0] == 2:
        out = out + dxs[1].flip(0)
    return out


def _split_directions(d_y, D2):
    """The gradient of :func:`_join_directions`: (T', B, D2 He) -> (T',
    D2, B, He)."""
    parts = d_y.chunk(D2, dim=-1)
    if D2 == 2:
        parts = (parts[0], parts[1].flip(0))
    return torch.stack(parts, dim=1).contiguous()


class JointLayer(torch.autograd.Function):
    """One layer of a jointly stacked encoder in train mode, on K1 train
    and K2 (their plain versions on the CPU).  ``apply(seq, wx, wh, b,
    seed, rate, bi, dtype, row_offset, global_rows)``: ``seq`` (T', B, C)
    the layer's input, ``wx`` (D2, C, 4He), ``wh`` (D2, He, 4He), ``b``
    (D2, 4He) -> (y (T', B, D2 He), h_fin, c_fin (D2, B, He)).  Forward:
    one input product (T' B, C) @ (C, 4He) a direction, then K1 train at
    one layer over both directions (dropout at ``rate``, step t's mask
    seed ``seed + t``).  Backward: K2, then the weight gradients and the
    input's gradient as time-batched products.  ``dtype`` bf16: the
    products' operands in bf16 (module docstring), K1 / K2 in their bf16
    modes.  Each direction of work runs inside a ``train.enc_layer``
    span."""

    @staticmethod
    def forward(ctx, seq, wx, wh, b, seed, rate, bi, dtype, row_offset=0,
                global_rows=None):
        with span("train.enc_layer"):
            xs, wx_c = _layer_operands(seq, wx, bi, dtype)
            proj = _layer_proj(xs, wx_c, seq.shape[0])
            wh_k = wh[None].to(BF16 if dtype == BF16 else wh.dtype
                               ).contiguous()
            wx_rest = wh_k.new_zeros((0,) + tuple(wh_k.shape[1:]))
            (outs, h_fin, c_fin, acts, c_all, h_pre,
             x_drop) = fused_lstm.fused_stacked_lstm_train(
                 proj, wx_rest, wh_k, b[None], seed, rate,
                 row_offset=row_offset, global_rows=global_rows)
        ctx.save_for_backward(seq, wx, wh_k, acts, c_all, h_pre)
        ctx.hyper = (seed, rate, bi, dtype, row_offset, global_rows)
        return _join_directions(outs), h_fin[0], c_fin[0]

    @staticmethod
    def backward(ctx, d_y, dh_fin, dc_fin):
        seq, wx, wh_k, acts, c_all, h_pre = ctx.saved_tensors
        seed, rate, bi, dtype, row_offset, global_rows = ctx.hyper
        with span("train.enc_layer"):
            D2, He = wh_k.shape[1], wh_k.shape[2]
            like = widen(c_all[-1, 0])
            dh = torch.zeros_like(like) if dh_fin is None else dh_fin
            dc = torch.zeros_like(like) if dc_fin is None else dc_fin
            douts = (torch.zeros(acts.shape[:1] + like.shape,
                                 device=like.device) if d_y is None
                     else _split_directions(d_y, D2))
            dz = fused_lstm.encoder_backward(
                acts, c_all, wh_k.new_zeros((0,) + tuple(wh_k.shape[1:])),
                wh_k, douts, dh[None].contiguous(), dc[None].contiguous(),
                seed, rate, row_offset=row_offset, global_rows=global_rows)
            dz = dz[:, 0]                                # (T', D2, B, 4He)
            h_prev = torch.cat([torch.zeros_like(h_pre[:1, 0]),
                                h_pre[:-1, 0]])
            xs, wx_c = _layer_operands(seq, wx, bi, dtype)
            Tp = seq.shape[0]
            # (D2, T' B, ...): a direction's steps and rows as one axis
            by_dir = (lambda t: t.transpose(0, 1).flatten(1, 2).to(
                xs.dtype))
            dz_d, h_d = by_dir(dz), by_dir(h_prev)
            dwh = torch.bmm(h_d.transpose(1, 2), dz_d)
            dwx = torch.bmm(xs.transpose(1, 2), dz_d)
            d_seq = _undirection(torch.bmm(dz_d, wx_c.transpose(1, 2))
                                 .float(), Tp)
            db = dz.sum(dim=(0, 2), dtype=torch.float32)
        return (d_seq, dwx.float(), dwh.float(), db) + (None,) * 6


def joint_encode(params, state, mcfg, X, train=False, seed=0,
                 rows=(0, None), mesh=None, compute_dtype=torch.float32):
    """A jointly stacked encoder (module docstring): the conv front-end,
    then each layer's input product and recurrence over both directions
    of the layer below's joined output.  Train mode: batch-statistics BN
    (the global batch's under ``mesh``) and layer l's dropout at
    ``dropout.rnn`` under the seed ``seed + l T'``, over the global rows
    ``rows``.  On the kernels' route (:func:`use_fused_encoder`) train
    mode runs :class:`JointLayer`, eval mode the input product and K1
    eval; off it, :func:`stacked_lstm_reference` with autograd at the
    scan path's rounding points.  Returns (enc_states (B, T', D2 He),
    h_fin, c_fin (L, B, D2 He), new_state)."""
    rnn = mcfg["rnn_config"]
    bi = rnn["bi_rnn"]
    rate = float(mcfg["dropout"]["rnn"]) if train else 0.0
    h_cnn, cnn_state = conv_frontend(params["cnn"], state["cnn_bn"],
                                     mcfg["cnn_config"], _source(params, X),
                                     train, compute_dtype, mesh)
    seq = h_cnn.transpose(0, 1)                         # (T', B, C)
    Tp = seq.shape[0]
    fused = use_fused_encoder(mcfg, X.device)
    h0s, c0s = [], []
    for l, lp in enumerate(direction_stacked(params["enc"]["lstm"])):
        seed_l = seed + l * Tp
        if train and fused:
            seq, h_fin, c_fin = JointLayer.apply(
                seq, lp["wx"], lp["wh"], lp["b"], seed_l, rate, bi,
                compute_dtype, *rows)
        else:
            xs, wx_c = _layer_operands(seq, lp["wx"], bi, compute_dtype)
            proj = _layer_proj(xs, wx_c, Tp)
            wh = lp["wh"][None]
            if fused:
                wh = (wh.to(BF16) if compute_dtype == BF16 else wh
                      ).contiguous()
                outs, h_fin, c_fin = fused_stacked_lstm(
                    proj, wh.new_zeros((0,) + tuple(wh.shape[1:])), wh,
                    lp["b"][None])
            else:
                outs, h_fin, c_fin = stacked_lstm_reference(
                    proj, wh.new_zeros((0,) + tuple(wh.shape[1:])), wh,
                    lp["b"][None], train, seed_l, rate, row_offset=rows[0],
                    global_rows=rows[1], compute_dtype=compute_dtype)[:3]
            seq, h_fin, c_fin = _join_directions(outs), h_fin[0], c_fin[0]
        h0s.append(torch.cat(h_fin.unbind(0), dim=-1))
        c0s.append(torch.cat(c_fin.unbind(0), dim=-1))
    new_state = ({"cnn_bn": cnn_state, "enc_proj_bn": state["enc_proj_bn"]}
                 if train else state)
    return (seq.transpose(0, 1).contiguous(), torch.stack(h0s),
            torch.stack(c0s), new_state)


def scan_encode(params, state, mcfg, X, train=False, seed=0,
                rows=(0, None), mesh=None, compute_dtype=torch.float32):
    """``ast_tpu``'s scan encoder as plain PyTorch with autograd, on X's
    device: the stacked recurrence with ``ln`` / ``rnn_relu``
    (``fused_lstm.stacked_lstm_reference``, K1's plain version, at the
    scan's rounding points) or the ``linear_proj`` layers.  ``train``:
    batch-statistics BatchNorm (the global batch's under ``mesh``) and
    hash dropout at ``dropout.rnn`` seeded by ``seed`` over the global
    rows ``rows`` (row_offset, global_rows) -- for the stacked encoder
    the masks K1 draws.  ``compute_dtype`` bf16: the scan path's rounding
    points (module docstring).  Returns (enc_states, dec_h0, dec_c0,
    new_state), the states f32."""
    rnn = mcfg["rnn_config"]
    rate = float(mcfg["dropout"]["rnn"]) if train else 0.0
    if rnn.get("linear_proj", False):
        h_cnn, cnn_state = conv_frontend(
            params["cnn"], state["cnn_bn"], mcfg["cnn_config"],
            _source(params, X), train, compute_dtype, mesh)
        return _encode_proj(params, state, mcfg, h_cnn, cnn_state, train,
                            seed, rows, mesh)
    enc_w = pack_encoder_weights(direction_stacked(params["enc"]["lstm"]))
    enc_in = encoder_inputs(params, state, mcfg, X, train, enc_w,
                            compute_dtype, mesh)
    ln = None
    if rnn.get("ln", False):
        ln = [(p["g"], p["b"]) for p in params["enc"]["ln"]]
    out = stacked_lstm_reference(*enc_in[:4], train, seed, rate, ln,
                                 rnn.get("rnn_relu", False), *rows,
                                 compute_dtype)
    return encoder_outputs(*out[:3]) + (enc_in[4] if train else state,)


def _encode_eval(params, state, mcfg, X, enc_w=None,
                 compute_dtype=torch.float32):
    if encoder_dims(mcfg)[2] == "joint":
        out = joint_encode(params, state, mcfg, X,
                           compute_dtype=compute_dtype)[:3]
    elif not use_fused_encoder(mcfg, X.device):
        out = scan_encode(params, state, mcfg, X,
                          compute_dtype=compute_dtype)[:3]
    else:
        out = encoder_outputs(*fused_stacked_lstm(*encoder_inputs(
            params, state, mcfg, X, enc_w=enc_w,
            compute_dtype=compute_dtype)))
    return (out[0],) + decoder_start(mcfg, *out[1:])


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


def decode_weights(params, dtype=torch.float32, mcfg=None):
    """The weights that greedy and beam decoding take:
    :func:`pack_decoder_weights` plus, under ``"step"``, the decode step
    kernels' layout (``fused_infer.pack_decode_step``: at bf16 the
    tensor-core tiles of ``pack_step_weights_mma``) and, under ``"enc"``,
    the encoder's (:func:`encoder_weights` of ``mcfg``), all at the
    compute ``dtype``.  Made once per model -- a caller decoding many batches
    with the same params passes it to every batch."""
    w = pack_decoder_weights(params, dtype)
    w["step"] = pack_decode_step(w)
    w["enc"] = encoder_weights(params, dtype, mcfg)
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
                enc_mask=None, compute_dtype=torch.float32):
    """One decoder step of any variant (``ast_tpu``'s ``decode_step``):
    embedding, input feeding (``feed_attn``), the L-layer LSTM with
    dropout, LayerNorm and ReLU on each layer's output as configured,
    ``n_attn``-head attention (masked, blockwise) and the logits with
    output dropout.

    carry: {"h", "c": (L, B, H), "ht": (B, A)}; token (B,) int.  ``drop``:
    None in eval mode, else ``(draws, t)``: the step's dropout masks are
    K3's hash masks of step t under ``draws.dec_seed`` for the embedding
    and the LSTM outputs, and ``draws.out_seed(t)``'s over (B, V) for the
    logits, each over the global rows from ``draws.row_offset``.
    ``compute_dtype`` bf16: ``ast_tpu``'s scan-path rounding points (the
    module docstring; ``enc_states`` f32 or bf16).  Returns (logits (B,
    V), new carry, alphas (B, T') of the first head), f32."""
    rnn, rates, dec = mcfg["rnn_config"], mcfg["dropout"], params["dec"]
    B, dev = token.shape[0], enc_states.device
    x = embedding_lookup(dec["embed"], token)
    if drop is not None and rates["embed"] > 0:
        draws, t = drop
        x = dropout(x, embed_drop_mask(rates["embed"], draws.dec_seed, t, B,
                                       x.shape[1], dev, draws.row_offset),
                    rates["embed"])
    if rnn.get("feed_attn", True):
        x = torch.cat([x, carry["ht"]], dim=-1)
    L, H = len(dec["lstm"]), rnn["hidden_units"]
    new_h, new_c = [], []
    for l, lp in enumerate(dec["lstm"]):
        z = (scan_dot(x, lp["wx"], compute_dtype) + carry["h"][l] @ lp["wh"]
             + lp["b"])
        h, c = lstm_gates(z, carry["c"][l], H)
        x = h
        if drop is not None and rates["rnn"] > 0:
            draws, t = drop
            x = dropout(x, rnn_drop_mask(rates["rnn"], draws.dec_seed, t, l,
                                         L, B, H, dev, draws.row_offset),
                        rates["rnn"])
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
        rnn.get("attn_block_size", 0), compute_dtype)
    logits = scan_dot(ht, dec["out_w"], compute_dtype) + dec["out_b"]
    rate = rates.get("out", 0)
    if drop is not None and rate > 0:
        draws, t = drop
        keep = drop_mask(tuple(logits.shape), rate, draws.out_seed(t),
                         row_axis=0, row_offset=draws.row_offset,
                         device=dev)
        logits = dropout(logits, keep, rate)
    return (logits, {"h": torch.stack(new_h), "c": torch.stack(new_c),
                     "ht": ht}, alphas)


def plain_step(params, mcfg, enc_mask=None, compute_dtype=torch.float32):
    """:func:`decode_step` in eval mode as the decode loops
    (``fused_infer.greedy_reference`` / ``beam_reference``) take it:
    ``(enc_rows, h, c, ht, tok) -> (logits, h, c, ht, alphas)``.
    ``enc_mask``: (rows, T') for the rows the loop runs;
    ``compute_dtype``: the step's."""
    def step(enc, h, c, ht, tok):
        logits, carry, alphas = decode_step(
            params, mcfg, enc, {"h": h, "c": c, "ht": ht}, tok,
            enc_mask=enc_mask, compute_dtype=compute_dtype)
        return logits, carry["h"], carry["c"], carry["ht"], alphas
    return step


def predict_greedy(params, state, mcfg, X, stop_limit, w=None,
                   enc_mask=None, compute_dtype=torch.float32):
    """Batched greedy decode: K5 when :func:`use_fused_infer`, else the
    same loop over :func:`plain_step` (``ast_tpu``'s while loop), at
    either compute dtype.  Returns (preds (B, stop_limit) int32, n_steps
    0-d int32): the steps until every row has produced its first EOS,
    capped at stop_limit.  ``w``: :func:`decode_weights` of ``params`` at
    ``compute_dtype``, made here when not given; ``enc_mask`` (B, T')
    (:func:`make_enc_mask`).  At bf16 the encoder states are rounded to
    bf16 before K5, and the plain loop's attention rounds them, as in
    ``ast_tpu``."""
    if w is None:
        w = decode_weights(params, compute_dtype, mcfg)
    _check_weights_dtype(w, compute_dtype)
    enc_states, dec_h0, dec_c0 = encode(params, state, mcfg, X, w,
                                        compute_dtype)
    if use_fused_infer(mcfg, X.device, *enc_states.shape[:2],
                       enc_mask=enc_mask):
        preds = greedy_decode_fused(enc_states.to(w["wh"].dtype), dec_h0,
                                    dec_c0, w, stop_limit)
    else:
        preds = greedy_reference(enc_states, dec_h0, dec_c0, w, stop_limit,
                                 plain_step(params, mcfg, enc_mask,
                                            compute_dtype))
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
    else None): the SpecAugment masks' starts and widths.  Per-row
    draws are a data-parallel rank's rows of the global batch's, which
    are rows ``row_offset .. row_offset + B - 1`` of ``global_rows``
    (None: B, a whole batch); the dropout masks hash those global
    rows."""
    noise: Optional[torch.Tensor]
    enc_seed: int
    dec_seed: int
    coins: torch.Tensor
    replace: Optional[torch.Tensor] = None
    rand_ids: Optional[torch.Tensor] = None
    spec: Optional[SpecMasks] = None
    row_offset: int = 0
    global_rows: Optional[int] = None

    @property
    def rows(self):
        """(row_offset, global_rows), as the encoder's masks take them."""
        return self.row_offset, self.global_rows

    def out_seed(self, t):
        """The hash seed of step t's output-dropout mask over (B, V),
        ``dec_seed + 2 (steps + t)``: an even offset past every
        embedding seed of K3's (``dec_seed + 2t``, t < steps) and never
        one of its odd LSTM seeds, so the stream repeats none of the
        decoder's."""
        return self.dec_seed + 2 * (self.coins.shape[0] + t)


def make_draws(seed, X, steps, teach_ratio, add_noise, random_out=0.0,
               vocab=0, spec_cfg=None, frame_len=None, mesh=None, planes=1):
    """Draws for one step from an int ``seed``: the noise from a
    generator on X's device, everything else from one on the host (no
    device sync), so a run is deterministic on one device.  The optional
    draws (``random_out`` with the vocabulary size ``vocab``; SpecAugment
    with its config block and the rows' true frame counts) come after
    the others in the host stream, which is the same without them.

    ``mesh`` (``parallel.make_mesh``): X holds this rank's rows of a
    global batch of ``mesh.data`` times as many, at its data index;
    every per-row draw is made at the global batch's shape and this
    rank's rows are kept, so the data ranks' draws together are one
    process's (``frame_len`` then the global batch's), and the ranks of
    a model group draw alike.  The coins and seeds are shared; the
    random target ids are drawn over the whole vocabulary.  ``planes``:
    the planes of a feature row, over whose bins the frequency masks
    lie (``ops.specaugment``)."""
    host = torch.Generator().manual_seed(seed)
    B = X.shape[0]
    row_offset, rows = (0, B) if mesh is None else (mesh.data_index * B,
                                                      mesh.data * B)
    shape = (rows,) + tuple(X.shape[1:])
    mine = slice(row_offset, row_offset + B)
    noise = None
    if add_noise > 0 and X.is_floating_point():     # no noise on token ids
        dev = torch.Generator(device=X.device).manual_seed(seed)
        noise = add_noise * torch.randn(shape, generator=dev,
                                        device=X.device)[mine]
    enc_seed, dec_seed = torch.randint(0, 2 ** 31 - 1, (2,),
                                       generator=host).tolist()
    idx = torch.arange(steps)
    coins = ((idx == 0) | (idx >= steps - 1)
             | (torch.rand(steps, generator=host) < teach_ratio))
    draws = Draws(noise, enc_seed, dec_seed,
                  coins.to(torch.int32).to(X.device), row_offset=row_offset,
                  global_rows=None if mesh is None else rows)
    if random_out > 0:
        draws.replace = (torch.rand((steps, rows), generator=host)
                         > random_out)[:, mine].to(X.device)
        draws.rand_ids = torch.randint(
            SYMBOLS.N_SPECIAL, vocab, (steps, rows),
            generator=host)[:, mine].to(X.device)
    if spec_cfg:
        if mesh is not None and frame_len is None:
            raise ValueError("make_draws under a mesh takes the global "
                             "batch's frame_len for SpecAugment")
        spec = draw_spec_masks(host, shape, spec_cfg, frame_len, X, planes)
        draws.spec = SpecMasks(*([(s[mine], w[mine]) for s, w in masks]
                                 for masks in (spec.freq, spec.time)),
                               planes)
    return draws


def encode_train(params, state, mcfg, X, draws, compute_dtype=torch.float32,
                 mesh=None):
    """Conv front-end + encoder in train mode: SpecAugment masks, then
    speech noise (speech only), batch-statistics BatchNorm (the global
    batch's under ``mesh``), hash dropout seeded by ``draws.enc_seed``
    over the global rows ``draws.rows`` -- K1 forward and K2 backward
    when :func:`use_fused_encoder`, else :func:`scan_encode` with
    autograd, each at ``compute_dtype``.  Returns (enc_states, dec_h0,
    dec_c0, new_state), the states f32 at either ``compute_dtype``."""
    if draws.spec is not None:
        X = apply_spec_masks(X, draws.spec)
    if draws.noise is not None:
        X = X * (1.0 + draws.noise)
    if encoder_dims(mcfg)[2] == "joint":
        enc, h0, c0, new_state = joint_encode(
            params, state, mcfg, X, True, draws.enc_seed, draws.rows, mesh,
            compute_dtype)
    elif not use_fused_encoder(mcfg, X.device):
        enc, h0, c0, new_state = scan_encode(
            params, state, mcfg, X, True, draws.enc_seed, draws.rows, mesh,
            compute_dtype)
    else:
        x0_proj, wx_rest, wh, b, new_state = encoder_inputs(
            params, state, mcfg, X, train=True, compute_dtype=compute_dtype,
            mesh=mesh)
        enc, h0, c0 = encoder_outputs(*FusedStackedLSTM.apply(
            x0_proj, wx_rest, wh, b, draws.enc_seed, True,
            float(mcfg["dropout"]["rnn"]), compute_dtype, *draws.rows))
    return (enc,) + decoder_start(mcfg, h0, c0) + (new_state,)


def sequence_loss(ht, out_w, out_b, target, n_real, label_smoothing=0.0,
                  replace=None, rand_ids=None, compute_dtype=torch.float32):
    """One (U*B, A) @ (A, V) logits GEMM, log-softmax and the PAD-masked
    cross-entropy summed over steps and rows, divided by ``n_real``.

    ``replace`` / ``rand_ids`` (see :class:`Draws`) corrupt the targets
    first: the PAD weight is the corrupted target's.  ``label_smoothing``
    eps mixes each token's loss as (1 - eps) * nll + eps * mean over the
    vocabulary of -log p.  ``compute_dtype`` bf16: ``ht`` and ``out_w``
    rounded to bf16 (their gradients too), ``out_b`` not."""
    if compute_dtype == BF16:
        ht, out_w = rounded(ht), rounded(out_w)
    return logits_loss(torch.matmul(ht, out_w) + out_b, target, n_real,
                       label_smoothing, replace, rand_ids)


def sharded_sequence_loss(ht, out_w, out_b, target, n_real, mesh=None,
                          **kw):
    """:func:`sequence_loss` with ``out_w`` and ``out_b`` this rank's
    vocab shards on ``mesh``: ``parallel.tp.vocab_parallel_loss`` under a
    model axis, else (no mesh, or a model axis of 1) :func:`sequence_loss`
    itself, the one-process code.  ``kw``: :func:`sequence_loss`'s."""
    if mesh is None or mesh.model == 1:
        return sequence_loss(ht, out_w, out_b, target, n_real, **kw)
    return vocab_parallel_loss(ht, out_w, out_b, target, n_real, mesh, **kw)


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
                      label_smoothing=0.0, enc_mask=None,
                      compute_dtype=torch.float32):
    """``ast_tpu``'s scan loss (``forward_loss``'s ``lax.scan``) as plain
    PyTorch with autograd, on enc's device: :func:`decode_step` over the
    U - 1 steps, each step's input the teacher's token where
    ``draws.coins`` holds and else the argmax of the step before's
    logits (after output dropout), then the cross-entropy of
    :func:`logits_loss` with ``draws``' target corruption and
    ``label_smoothing``.  ``draws`` None: eval mode (every step forced,
    no dropout, plain cross-entropy).  ``compute_dtype``: each step's
    (:func:`decode_step`); the log-softmax and the cross-entropy f32.
    Returns the loss."""
    yT = y.t()
    steps = yT.shape[0] - 1
    coins = [1] * steps if draws is None else draws.coins.tolist()
    carry = init_decoder_carry(mcfg, h0, c0)
    prev, logits = None, []
    for t in range(steps):
        tok = yT[t] if coins[t] else prev
        lg, carry, _ = decode_step(params, mcfg, enc, carry, tok,
                                   None if draws is None else (draws, t),
                                   enc_mask, compute_dtype)
        if t + 1 < steps and not coins[t + 1]:
            prev = torch.argmax(lg, dim=-1)
        logits.append(lg)
    corrupt = {} if draws is None else dict(
        label_smoothing=label_smoothing, replace=draws.replace,
        rand_ids=draws.rand_ids)
    return logits_loss(torch.stack(logits), yT[1:], n_real, **corrupt)


def forward_loss(params, state, mcfg, X, y, n_real, draws=None, train=True,
                 label_smoothing=0.0, enc_w=None, enc_mask=None,
                 compute_dtype=torch.float32, mesh=None):
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
    ``draws`` is not read and the state comes back as it was.

    ``compute_dtype`` bf16: each stage at its route's rounding points
    (the module docstring); ``enc_w`` then at bf16.

    Data parallelism: X and y are a rank's rows, ``draws`` its draws
    (:func:`make_draws` with the ``mesh``), ``n_real`` the global
    batch's real rows, so the loss is the rank's share of the global
    loss and the ranks' gradients sum to one process's; ``mesh`` makes
    the train-mode BN statistics the global batch's.

    Vocab tensor parallelism (a ``mesh`` with a model axis; train mode):
    ``params``' ``dec/embed``, ``dec/out_w`` and ``dec/out_b`` are this
    rank's vocab shards (``parallel.mesh.shard_params``).  The stages
    take them gathered whole (``parallel.tp.gathered_params``, whose
    backward keeps this rank's slice of the whole gradient): K3 / K4
    (``d_embed`` over the whole vocabulary) or the scan loss, which then
    runs its logits and cross-entropy whole on every rank.  After K3 the
    loss logits stay sharded: ``parallel.tp.vocab_parallel_loss``.  The
    loss is the whole one on every rank of the model group."""
    drop = mcfg["dropout"]
    yT = y.t()
    shards = params["dec"]
    if train:
        params = gathered_params(params, mesh)
        enc, h0, c0, new_state = encode_train(params, state, mcfg, X, draws,
                                              compute_dtype, mesh)
    else:
        enc, h0, c0 = _encode_eval(params, state, mcfg, X, enc_w,
                                   compute_dtype)
        new_state = state
    fused_dec = use_fused_decoder(mcfg, X.device, enc_mask, enc.shape[1])
    if train:
        plain = (not use_fused_encoder(mcfg, X.device)) + (not fused_dec)
        count("train.plain_stages", plain)
    if not fused_dec:
        loss = scan_decoder_loss(params, mcfg, enc, h0, c0, y, n_real,
                                 draws if train else None, label_smoothing,
                                 enc_mask, compute_dtype)
        return loss, new_state
    y_in = yT[:-1].to(torch.int32).contiguous()
    if train:
        coins, seed, row0 = draws.coins, draws.dec_seed, draws.row_offset
        rates = float(drop["embed"]), float(drop["rnn"])
        corrupt = dict(label_smoothing=label_smoothing,
                       replace=draws.replace, rand_ids=draws.rand_ids)
    else:
        coins = torch.ones(y_in.shape[0], dtype=torch.int32, device=X.device)
        seed, row0, rates, corrupt = 0, 0, (0.0, 0.0), {}
    w = pack_decoder_weights(params, compute_dtype)
    ht, _ = FusedDecoder.apply(enc.to(w["wh"].dtype), h0, c0,
                               *(w[k] for k in W_NAMES), y_in, coins, seed,
                               *rates, row0)
    loss = sharded_sequence_loss(
        ht, shards["out_w"], shards["out_b"], yT[1:], n_real,
        mesh if train else None, compute_dtype=compute_dtype, **corrupt)
    return loss, new_state


def weight_noise_targets(params):
    """The leaves that weight noise moves (``ast_tpu``'s
    ``add_weight_noise``), as (path, leaf) pairs: the encoder's LSTM
    leaves, the decoder's, each layer's by sorted name (b, wh, wx: the
    order JAX flattens a dict in), then the decoder embedding."""
    out = []
    for part in ("enc", "dec"):
        for i, layer in enumerate(params[part]["lstm"]):
            out.extend((f"{part}/lstm/{i}/{k}", layer[k])
                       for k in sorted(layer))
    return out + [("dec/embed", params["dec"]["embed"])]


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
        for (_, p), n in zip(targets, noise):
            p.copy_(p + mean + sigma * n.to(p.device))
    return params
