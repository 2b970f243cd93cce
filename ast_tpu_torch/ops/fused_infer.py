"""K5 and K6: fused greedy and beam decoding.

The counterparts of ``ast_tpu/ops/fused_infer.py`` ``greedy_decode_fused``
and ``beam_decode_fused``.  A CUDA tensor runs the hand kernels
(``kernels/csrc/k5_greedy.cu``, ``k6_beam.cu``, both on the step kernels
of ``decode_step.cu``); a CPU tensor runs the
plain versions :func:`greedy_reference` and :func:`beam_reference`,
written from ast_tpu's XLA decode loops (``seq2seq.predict_greedy``'s
``lax.while_loop`` and ``ops/beam.py``'s frontier loop).  The same two
loops, given ``models.seq2seq.plain_step``, are the decoders of every
variant the kernels do not take (:func:`infer_variant_ok`), on any
device, and ``beam_reference`` alone keeps attention histories.

``w`` is the packed decoder weight dict of
``models.seq2seq.pack_decoder_weights``: ast_tpu's layout without the
TPU's vocab padding.  The kernels take it with the decode step's own
layout under ``"step"`` (:func:`pack_step_weights`), which
``models.seq2seq.decode_weights`` adds once per model.

bfloat16 (``extras.compute_dtype: "bfloat16"``): every leaf of ``w`` in
bf16, biases and the embedding too, and the encoder states in bf16
(``ast_tpu``'s ``pack_decoder_weights(params, bf16)`` and
``enc.astype(bf16)``).  The step rounds to bf16 what ``ast_tpu``'s
kernels round: ``[emb; ht_prev]``, each layer's h, the input of ``wa``,
``[cv; x]`` and ``ht`` where the products read them, and the attention
weights before the context sum; the query, scores, softmax,
log-softmax, top-K and the beam scores stay f32, as do h, c and ht.  A
CUDA tensor launches the bf16 entries (``k5_greedy_decode_bf16``,
``k6_beam_decode_bf16``) or raises; nothing is widened to f32 quietly.
"""

import torch

from ast_tpu_torch.symbols import SYMBOLS
from ast_tpu_torch.kernels import build
from ast_tpu_torch.ops.attention import luong_attention
from ast_tpu_torch.ops.bf16 import BF16, dot, rounded, widen
from ast_tpu_torch.ops.lstm import lstm_gates

NEG_INF = -1e30
# the decode step's tiles (decode_step.cu): the input axis in tiles of 32
_DECODE_TILE = 32
# shared memory a block may use on the H100
_SMEM_BYTES = 227 * 1024


def infer_variant_ok(mcfg, enc_mask=None):
    """Whether greedy and beam decoding run K5 / K6 (``ast_tpu``'s
    ``infer_variant_ok``, less its TPU-only switches): one attention
    head with input feeding, no LayerNorm, no rnn_relu, no blockwise
    attention, no encoder mask.  For any other model both decoders run
    ``ast_tpu``'s XLA loops as plain PyTorch on the caller's device,
    a CUDA device included: ``ast_tpu`` has no Pallas kernel for those
    variants either.  With ``models.seq2seq.use_fused_encoder`` and
    ``use_fused_decoder`` these are the only places where a CUDA tensor
    takes a plain version.  One predicate for both decoders, so they
    cannot part on a variant."""
    rnn = mcfg["rnn_config"]
    return (enc_mask is None and rnn.get("n_attn", 1) == 1
            and rnn.get("feed_attn", True) and not rnn.get("ln", False)
            and not rnn.get("rnn_relu", False)
            and not rnn.get("attn_block_size", 0))


def require_bf16_variant(mcfg, dtype, what=()):
    """Raise NotImplementedError naming the model variant, or ``what``
    (further options of the caller, e.g. an encoder mask), when
    ``dtype`` is bf16 and the path is one ``ast_tpu`` runs on its scan
    path (the stages ``models.seq2seq`` routes to plain PyTorch), whose
    bf16 mode is not ported: decoding at bf16 covers the variant the
    kernels take."""
    if dtype != BF16:
        return
    rnn = mcfg["rnn_config"]
    refused = [name for name, on in (
        ("ln", rnn.get("ln", False)),
        ("rnn_relu", rnn.get("rnn_relu", False)),
        ("linear_proj", rnn.get("linear_proj", False)),
        ("n_attn", rnn.get("n_attn", 1) != 1),
        ("feed_attn", not rnn.get("feed_attn", True)),
        ("attn_block_size", bool(rnn.get("attn_block_size", 0))),
    ) if on] + list(what)
    if refused:
        raise NotImplementedError(
            f"compute_dtype bfloat16 decodes the model the kernels take; "
            f"not ported at bfloat16: {', '.join(refused)} (see ROADMAP.md "
            f"queue 1, bf16 on the scan path)")


def require_train_dtype(train_cfg):
    """Raise NotImplementedError naming ``compute_dtype`` unless it is
    float32: the port decodes at bf16 but does not train at it.  Called
    where training starts (``NN.train_epoch``, ``NN.eval_loss``,
    ``cli.train``)."""
    if train_cfg["extras"].get("compute_dtype", "float32") != "float32":
        raise NotImplementedError(
            "ast_tpu_torch does not train these options; not ported: "
            "compute_dtype (bfloat16 decodes; see ROADMAP.md queue 1, "
            "bf16 training)")


def require_train_variant(train_cfg):
    """The options the ported trainer refuses: several steps a dispatch,
    the device feature cache and narrow transfer dtypes
    (``compute_dtype`` is refused where training starts,
    :func:`require_train_dtype`).  Every model variant trains (the
    routing of ``models.seq2seq``).  ``train_cfg`` is
    ``Config(...).train``.  Raises NotImplementedError naming what is
    refused, on every device, and ``ast_tpu``'s ValueError for
    ``hbm_cache`` over audio or text."""
    extras, data = train_cfg["extras"], train_cfg["data"]
    if extras.get("hbm_cache", False):
        if data.get("features", "precomputed") == "wav":
            raise ValueError(
                "extras.hbm_cache needs precomputed features "
                "(data.features='wav' ships raw audio; the MFCC "
                "already runs on device in that mode)")
        if data.get("enc_key", "sp") != "sp":
            raise ValueError("extras.hbm_cache: text-encoder mode "
                             "has no feature block to cache")
    refused = [name for name, bad in (
        ("steps_per_dispatch", int(extras.get("steps_per_dispatch", 1))
         != 1),
        ("hbm_cache", bool(extras.get("hbm_cache", False))),
        ("transfer_dtype", extras.get("transfer_dtype",
                                      "float32") != "float32"),
    ) if bad]
    if refused:
        raise NotImplementedError(
            f"ast_tpu_torch does not train these options; "
            f"not ported: {', '.join(refused)} (see ROADMAP.md queue 1, "
            f"the feed options)")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def decode_step_reference(w, enc_rows, h, c, ht, tok):
    """One decoder step for R rows (``seq2seq.decode_step`` in eval
    mode, for the variant K5 / K6 take).  enc_rows (R, T, H), h/c (L, R,
    H), ht (R, A), tok (R,).  Returns (logits (R, V), h, c, ht, alphas
    (R, T)) -- the contract of the ``step`` that :func:`greedy_reference`
    and :func:`beam_reference` take.  With ``w`` and ``enc_rows`` in
    bf16, the rounding points of the module docstring."""
    if w["wh"].dtype == BF16:
        return _decode_step_bf16(w, enc_rows, h, c, ht, tok)
    L, _, H = h.shape
    x = torch.cat([w["embed"][tok], ht], dim=-1)
    new_h, new_c = [], []
    for l in range(L):
        wx = w["wx0"] if l == 0 else w["wx_rest"][l - 1]
        z = x @ wx + h[l] @ w["wh"][l] + w["b"][l]
        x, c_l = lstm_gates(z, c[l], H)
        new_h.append(x)
        new_c.append(c_l)
    ht, alphas = luong_attention(enc_rows, x, [(w["wa"], w["wa_b"])],
                                 w["ctx_w"], w["ctx_b"])
    logits = ht @ w["out_w"] + w["out_b"]
    return logits, torch.stack(new_h), torch.stack(new_c), ht, alphas


def _decode_step_bf16(w, enc_rows, h, c, ht, tok):
    """:func:`decode_step_reference` at bf16 (``ast_tpu``'s
    ``_lstm_stack``, ``_step_core`` and ``_context_out``): each product's
    left operand rounded to bf16 and multiplied in f32 (``ops.bf16.dot``),
    biases bf16, the scores against the bf16 encoder rows with the f32
    query, the softmax weights rounded before the context sum."""
    L, _, H = h.shape
    x = torch.cat([w["embed"][tok].float(), ht], dim=-1)
    new_h, new_c = [], []
    for l in range(L):
        wx = w["wx0"] if l == 0 else w["wx_rest"][l - 1]
        z = dot(x, wx) + dot(h[l], w["wh"][l]) + w["b"][l].float()
        x, c_l = lstm_gates(z, c[l], H)
        new_h.append(x)
        new_c.append(c_l)
    enc = enc_rows.float()
    q = dot(x, w["wa"]) + w["wa_b"].float()
    alphas = torch.softmax(torch.bmm(enc, q.unsqueeze(-1))[..., 0], dim=-1)
    cv = torch.bmm(rounded(alphas).unsqueeze(1), enc)[:, 0]
    ht = torch.tanh(dot(torch.cat([cv, x], dim=-1), w["ctx_w"])
                    + w["ctx_b"].float())
    logits = dot(ht, w["out_w"]) + w["out_b"].float()
    return logits, torch.stack(new_h), torch.stack(new_c), ht, alphas


def _state_zeros(enc, shape):
    """Zeros for decoder state beside ``enc``: f32 when the encoder
    states are bf16 (the state stays f32), else in their dtype."""
    return torch.zeros(shape, device=enc.device,
                       dtype=torch.float32 if enc.dtype == BF16
                       else enc.dtype)


def _plain_step(w, step):
    """``step``, or the K5 / K6 variant's step over ``w`` (looked up at
    call time)."""
    if step is not None:
        return step
    return lambda *args: decode_step_reference(w, *args)


def greedy_reference(enc, h0, c0, w, stop_limit, step=None):
    """Greedy decode with early exit once every row has produced EOS;
    unvisited steps stay PAD (``ast_tpu``'s ``predict_greedy`` while
    loop).  ``step``: the decoder step (see
    :func:`decode_step_reference`; ``models.seq2seq.plain_step`` for any
    variant), by default the one over ``w``.  Returns preds (B,
    stop_limit) int32."""
    step = _plain_step(w, step)
    B = enc.shape[0]
    out = torch.full((B, stop_limit), SYMBOLS.PAD_ID, dtype=torch.int32,
                     device=enc.device)
    word = torch.full((B,), SYMBOLS.GO_ID, dtype=torch.long,
                      device=enc.device)
    fin = torch.zeros(B, dtype=torch.bool, device=enc.device)
    h, c = h0, c0
    ht = _state_zeros(enc, (B, w["ctx_w"].shape[1]))
    for t in range(stop_limit):
        if bool(fin.all()):
            break
        logits, h, c, ht, _ = step(enc, h, c, ht, word)
        word = torch.argmax(logits, dim=-1)
        out[:, t] = word.to(torch.int32)
        fin |= word == SYMBOLS.EOS_ID
    return out


def greedy_follow(enc, h0, c0, w, preds, step=None):
    """The plain decoder stepped along a given greedy decode ``preds``
    (B, stop_limit), e.g. a kernel's: each row is fed its own given
    tokens; ``step`` as in :func:`greedy_reference`.  Returns (short (B,
    stop_limit): how far each given token's logit falls below the step's
    largest, 0 for the argmax; n_run: the steps a greedy decode runs on
    this path, after which every given token must be PAD)."""
    step_fn = _plain_step(w, step)
    B, stop_limit = preds.shape
    short = torch.zeros((B, stop_limit), device=enc.device)
    word = torch.full((B,), SYMBOLS.GO_ID, dtype=torch.long,
                      device=enc.device)
    fin = torch.zeros(B, dtype=torch.bool, device=enc.device)
    h, c = h0, c0
    ht = _state_zeros(enc, (B, w["ctx_w"].shape[1]))
    for t in range(stop_limit):
        if bool(fin.all()):
            return short, t
        logits, h, c, ht, _ = step_fn(enc, h, c, ht, word)
        word = preds[:, t].long()
        short[:, t] = (logits.amax(dim=-1)
                          - logits.gather(1, word[:, None])[:, 0])
        fin |= word == SYMBOLS.EOS_ID
    return short, stop_limit


def _topk(x, k):
    """Top-k along the last axis ordered by (value desc, index asc), the
    ``lax.top_k`` contract."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class _BeamState:
    """The frontier of a batched beam search over B utterances x N slots:
    decoder state of the R = B * N rows, scores, finished flags and the
    last tokens, with the plain decoder step and the candidate scores."""

    def __init__(self, enc, h0, c0, w, N, K, step=None):
        B = enc.shape[0]
        dev = enc.device
        self.step, self.N, self.K = _plain_step(w, step), N, K
        self.enc = enc.repeat_interleave(N, dim=0)
        self.h = h0.repeat_interleave(N, dim=1)
        self.c = c0.repeat_interleave(N, dim=1)
        self.ht = _state_zeros(enc, (B * N, w["ctx_w"].shape[1]))
        self.scores = torch.full((B, N), NEG_INF, device=dev)
        self.scores[:, 0] = 0.0
        self.finished = torch.zeros((B, N), dtype=torch.bool, device=dev)
        self.last = torch.full((B, N), SYMBOLS.GO_ID, dtype=torch.long,
                               device=dev)
        self.k0 = torch.arange(K, device=dev) == 0

    def candidates(self):
        """Run the decoder step; returns (logp (B, N, V), the top-K
        log-probs and tokens of each slot (B, N, K) -- one EOS candidate
        with the score unchanged for a finished slot -- and the N * K
        candidate scores (B, N * K))."""
        B, N = self.scores.shape
        logits, self.h2, self.c2, self.ht2, self.alphas = self.step(
            self.enc, self.h, self.c, self.ht, self.last.reshape(B * N))
        logp = torch.log_softmax(logits, dim=-1).reshape(B, N, -1)
        top_logp, top_tok = _topk(logp, self.K)
        fin = self.finished[..., None]
        cand_logp = torch.where(
            fin, torch.where(self.k0, 0.0, NEG_INF).to(top_logp.dtype),
            top_logp)
        top_tok = torch.where(fin, SYMBOLS.EOS_ID, top_tok)
        cand = (self.scores[..., None] + cand_logp).reshape(B, -1)
        return logp, top_logp, top_tok, cand

    def advance(self, parent, tok, new_scores):
        """Take the selected (parent slot, token, score) of every slot
        (B, N); returns the parents' finished flags."""
        B, N = parent.shape
        p_fin = self.finished.gather(1, parent)
        rows = (torch.arange(B, device=parent.device)[:, None] * N
                + parent).reshape(B * N)
        self.h, self.c, self.ht = (self.h2[:, rows], self.c2[:, rows],
                                   self.ht2[rows])
        self.finished = p_fin | (tok == SYMBOLS.EOS_ID)
        self.last = tok
        self.scores = new_scores
        return p_fin


def beam_reference(enc, h0, c0, w, N, K, stop_limit, trace=False,
                   step=None, return_attn=False):
    """Batched beam search (``ops/beam.py``'s frontier loop).

    Returns (hyps (B, N, stop_limit+1) int32 starting with GO, scores
    (B, N), lengths (B, N) int32).  With ``trace`` also returns the
    per-step chosen tokens, parent slots and validity (stop_limit, B, N)
    -- EOS, identity and 0 after the loop ends, as the kernel streams
    them.  ``step`` as in :func:`greedy_reference`.  With
    ``return_attn`` also returns each hypothesis's attention history
    (B, N, stop_limit+1, T): at a token's position the first head's
    alphas of the step that produced it, gathered through the parents
    as the tokens are; the GO position and those past the length 0."""
    B, T = enc.shape[:2]
    dev = enc.device
    max_len = stop_limit + 1
    st = _BeamState(enc, h0, c0, w, N, K, step)
    attn = (torch.zeros((B, N, max_len, T), device=dev) if return_attn
            else None)
    tokens = torch.full((B, N, max_len), SYMBOLS.PAD_ID, dtype=torch.int32,
                        device=dev)
    tokens[:, :, 0] = SYMBOLS.GO_ID
    lengths = torch.ones((B, N), dtype=torch.int32, device=dev)
    pos = torch.arange(max_len, device=dev)
    slot = torch.arange(N, device=dev)
    tok_tr = torch.full((stop_limit, B, N), SYMBOLS.EOS_ID, dtype=torch.int32,
                        device=dev)
    par_tr = slot.to(torch.int32).expand(stop_limit, B, N).clone()
    val_tr = torch.zeros((stop_limit, B, N), dtype=torch.int32, device=dev)
    for t in range(stop_limit):
        if bool(st.finished.all()):
            break
        _, _, top_tok, cand = st.candidates()
        new_scores, flat_idx = _topk(cand, N)
        parent = flat_idx // K
        tok = top_tok.reshape(B, N * K).gather(1, flat_idx)
        p_len = lengths.gather(1, parent)
        p_tokens = tokens.gather(1, parent[..., None].expand(-1, -1, max_len))
        p_fin = st.advance(parent, tok, new_scores)
        write = (pos == p_len[..., None]) & ~p_fin[..., None]
        tokens = torch.where(write, tok[..., None].to(torch.int32), p_tokens)
        lengths = p_len + (~p_fin).to(torch.int32)
        if return_attn:
            sel = st.alphas.reshape(B, N, T).gather(
                1, parent[..., None].expand(-1, -1, T))
            p_attn = attn.gather(
                1, parent[..., None, None].expand(-1, -1, max_len, T))
            attn = torch.where(write[..., None], sel[:, :, None, :], p_attn)
        if trace:
            tok_tr[t] = tok.to(torch.int32)
            par_tr[t] = parent.to(torch.int32)
            val_tr[t] = (~p_fin).to(torch.int32)
    if trace:
        return tokens, st.scores, lengths, tok_tr, par_tr, val_tr
    if return_attn:
        return tokens, st.scores, lengths, attn
    return tokens, st.scores, lengths


def beam_follow(enc, h0, c0, w, N, K, tok, par, val, step=None):
    """The plain beam step along a given search's per-step streams tok,
    par (parent slot) and val (stop_limit, B, N), e.g. a kernel's: each
    step recomputes the candidates of the given frontier and holds the
    given selection against them; ``step`` as in
    :func:`greedy_reference`.

    Returns (scores (B, N): the given hypotheses' summed log-probs under
    the plain step; topk_short (stop_limit, B): how far a chosen token's
    log-prob falls below its slot's K-th best, 0 inside the top K;
    sel_err (stop_limit, B): the largest difference between the chosen
    scores and the best N candidates, both sorted; bad (stop_limit, B):
    a frozen slot not continued by EOS with valid 0, a live slot with
    valid 0, a candidate chosen twice, or -- once every slot has
    finished -- anything but EOS, the identity parent and valid 0)."""
    stop_limit, B, _ = tok.shape
    dev = enc.device
    st = _BeamState(enc, h0, c0, w, N, K, step)
    slot = torch.arange(N, device=dev)
    topk_short = torch.zeros((stop_limit, B), device=dev)
    sel_err = torch.zeros((stop_limit, B), device=dev)
    bad = torch.zeros((stop_limit, B), dtype=torch.bool, device=dev)
    for t in range(stop_limit):
        if bool(st.finished.all()):
            bad[t:] = ((tok[t:] != SYMBOLS.EOS_ID) | (par[t:] != slot)
                       | (val[t:] != 0)).any(dim=-1)
            break
        logp, top_logp, _, cand = st.candidates()
        best = _topk(cand, N)[0]
        parent, tk, v = par[t].long(), tok[t].long(), val[t]
        p_fin = st.finished.gather(1, parent)
        lp = logp.gather(1, parent[..., None].expand(-1, -1, logp.shape[-1]))
        lp = lp.gather(2, tk[..., None])[..., 0]
        # earlier slots holding the same parent (and the same token); a
        # frozen parent's first pick is its k = 0 candidate, later picks
        # its NEG_INF ones
        same = ((parent[:, :, None] == parent[:, None, :])
                & (slot[:, None] > slot[None, :]))
        rank = same.sum(dim=-1)
        twice = (same & (tk[:, :, None] == tk[:, None, :])).any(dim=-1)
        frozen_lp = torch.where(rank == 0, 0.0, NEG_INF)
        chosen = st.scores.gather(1, parent) + torch.where(p_fin, frozen_lp,
                                                           lp)
        kth = top_logp[..., -1].gather(1, parent)
        topk_short[t] = torch.where(p_fin, 0.0, kth - lp).clamp(
            min=0).amax(dim=1)
        sel_err[t] = (torch.sort(chosen, dim=1, descending=True).values
                      - best).abs().amax(dim=1)
        bad[t] = torch.where(
            p_fin, (tk != SYMBOLS.EOS_ID) | (v != 0) | (rank >= K),
            (v != 1) | twice).any(dim=1)
        st.advance(parent, tk, chosen)
    return st.scores, topk_short, sel_err, bad


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_WEIGHT_ORDER = ("embed", "wx0", "wx_rest", "wh", "b", "wa", "wa_b",
                 "ctx_w", "ctx_b", "out_w", "out_b")


def check_decoder_inputs(enc, h0, c0, w):
    """Validate the kernel inputs: ``w``'s leaves and ``enc`` in one
    dtype (f32, or bf16), the state f32.  Returns (B, T, H, L, E, A, V,
    dtype)."""
    B, T, H = enc.shape
    L = h0.shape[0]
    V, E = w["embed"].shape
    A = w["ctx_w"].shape[1]
    dt = BF16 if w["wh"].dtype == BF16 else torch.float32
    build.check_tensor(enc, "enc_states", None, dt)
    build.check_tensor(h0, "dec_h0", (L, B, H))
    build.check_tensor(c0, "dec_c0", (L, B, H))
    shapes = {"embed": (V, E), "wx0": (E + A, 4 * H),
              "wx_rest": (L - 1, H, 4 * H), "wh": (L, H, 4 * H),
              "b": (L, 4 * H), "wa": (H, H), "wa_b": (H,),
              "ctx_w": (2 * H, A), "ctx_b": (A,), "out_w": (A, V),
              "out_b": (V,)}
    for k in _WEIGHT_ORDER:
        build.check_tensor(w[k], k, shapes[k], dt)
    return B, T, H, L, E, A, V, dt


def _pack_columns(w, block):
    """(K, N) -> (ceil(N / block), K, block): column block c of w, its
    rows contiguous, zero columns past N."""
    K, N = w.shape
    nb = -(-N // block)
    if nb * block != N:
        w = torch.cat([w, w.new_zeros((K, nb * block - N))], dim=1)
    return w.view(K, nb, block).permute(1, 0, 2).contiguous()


def put_transposed(out, n0, m):
    """Write m^T into packed columns n0 .. n0 + n - 1 of ``out`` (...,
    column blocks, K, 64), m (..., n, K) with the same leading dims: whole
    blocks in one strided copy, a ragged head or tail in one more each."""
    n, i = m.shape[-2], 0
    while i < n:
        blk, c = divmod(n0 + i, 64)
        if c == 0 and n - i >= 64:
            nb = (n - i) // 64
            out[..., blk:blk + nb, :, :].copy_(
                m[..., i:i + nb * 64, :].unflatten(-2, (nb, 64))
                .transpose(-1, -2))
            i += nb * 64
        else:
            take = min(64 - c, n - i)
            out[..., blk, :, c:c + take].copy_(
                m[..., i:i + take, :].transpose(-1, -2))
            i += take


def pack_step_weights(w):
    """The decode step kernels' weights (``ast::StepWeights``): each
    product's matrix as (column blocks, K, 64), so a block's tile of
    input rows is one contiguous copy.  A cell's [wx; wh] (K, 4H) is
    packed by hidden unit: column q * 16 + u of block c is gate q of
    unit 16 c + u, so a block holds all four gates of its units.  A
    layout copy of the decoder weights (two strided copies a cell, no
    intermediate), made once per model for decoding
    (``models.seq2seq.decode_weights``) and once per forward call in
    training, where the weights change every step.  The matrices keep
    ``w``'s dtype (bf16: a 32-row tile is 4 KB); the embedding and the
    biases, read a few rows a step, go to f32 (at bf16 holding the
    rounded values)."""
    L, H = w["wh"].shape[0], w["wh"].shape[1]
    wxs = [w["wx0"]] + [w["wx_rest"][l] for l in range(L - 1)]
    cell = w["wh"].new_empty((4 * H * sum(wx.shape[0] + H for wx in wxs),))
    off = 0
    for wx, wh in zip(wxs, w["wh"]):
        Kx = wx.shape[0]
        n = (Kx + H) * 4 * H
        blk = cell[off:off + n].view(H // 16, Kx + H, 4, 16)
        blk[:, :Kx].copy_(wx.view(Kx, 4, H // 16, 16).permute(2, 0, 1, 3))
        blk[:, Kx:].copy_(wh.view(H, 4, H // 16, 16).permute(2, 0, 1, 3))
        off += n
    return {"embed": widen(w["embed"]), "cell": cell, "b": widen(w["b"]),
            "wa": _pack_columns(w["wa"], 64), "wa_b": widen(w["wa_b"]),
            "ctx_w": _pack_columns(w["ctx_w"], 64),
            "ctx_b": widen(w["ctx_b"]),
            "out_w": _pack_columns(w["out_w"], 64),
            "out_b": widen(w["out_b"])}


STEP_ORDER = ("embed", "cell", "b", "wa", "wa_b", "ctx_w", "ctx_b",
               "out_w", "out_b")
# the packed products' matrices: in the compute dtype (the rest f32)
_STEP_MATRICES = ("cell", "wa", "ctx_w", "out_w")


def step_weights(w, H, L, E, A, V, dtype=torch.float32):
    """``w["step"]``, the packed form the decode step kernels take,
    checked against the decoder's dims and ``dtype`` (its matrices').
    Raises ValueError if ``w`` lacks it (make ``w`` with
    ``models.seq2seq.decode_weights``)."""
    if "step" not in w:
        raise ValueError("the decode kernels take the weights of "
                         "seq2seq.decode_weights (packed once per model, "
                         "under 'step')")
    shapes = {"embed": (V, E),
              "cell": (4 * H * (E + A + H + (L - 1) * 2 * H),),
              "b": (L, 4 * H), "wa": (-(-H // 64), H, 64), "wa_b": (H,),
              "ctx_w": (-(-A // 64), 2 * H, 64), "ctx_b": (A,),
              "out_w": (-(-V // 64), A, 64), "out_b": (V,)}
    step = w["step"]
    for k in STEP_ORDER:
        build.check_tensor(step[k], f"step {k}", shapes[k],
                           dtype if k in _STEP_MATRICES else torch.float32)
    return step


def check_decode_shapes(B, T, H, E, A, N, K=1):
    """Raise unless the decode step's kernels take these shapes: E, A, H
    multiples of its 32-wide input tiles, attention's and the beam
    selection's shared memory within a block's."""
    if E % _DECODE_TILE or A % _DECODE_TILE or H % _DECODE_TILE:
        raise ValueError(f"decode kernels take E, A, H that are multiples "
                         f"of {_DECODE_TILE} (got {E}, {A}, {H})")
    # attention: 2 N H + N T floats at most (one block per utterance)
    attn = 4 * (2 * N * H + N * T + 2 * N)
    if attn > _SMEM_BYTES:
        raise ValueError(f"decode attention needs {attn} bytes of shared "
                         f"memory at N={N}, T={T}, H={H}")
    if 8 * N * K > 48 * 1024:
        raise ValueError(f"beam selection keeps N * K = {N * K} candidates "
                         f"in 48 KB of shared memory")


def greedy_decode_fused(enc, dec_h0, dec_c0, w, stop_limit):
    """Greedy decode.  enc (B, T, H), dec_h0/c0 (L, B, H).  Returns preds
    (B, stop_limit) int32: each row's argmax chain, continued past its own
    EOS, and PAD after the step where every row has finished.  ``w`` and
    ``enc`` in bf16 run the bf16 mode; its launches count in
    ``launches_bf16``."""
    if not enc.is_cuda:
        return greedy_reference(enc, dec_h0, dec_c0, w, stop_limit)
    B, T, H, L, E, A, V, dt = check_decoder_inputs(enc, dec_h0, dec_c0, w)
    check_decode_shapes(B, T, H, E, A, 1)
    dev = enc.device
    i32 = dict(dtype=torch.int32, device=dev)
    # state ping-pongs between two slots a step
    hbuf = torch.empty((2, L, B, H), device=dev)
    hbuf[0] = dec_h0
    cbuf = torch.empty((2, L, B, H), device=dev)
    cbuf[0] = dec_c0
    htbuf = torch.zeros((2, B, A), device=dev)
    tok_in = torch.full((B,), SYMBOLS.GO_ID, **i32)
    fin = torch.zeros((B,), **i32)
    done = torch.zeros((1,), **i32)
    q = torch.empty((B, H), device=dev)
    cv = torch.empty((B, H), device=dev)
    logits = torch.empty((B, V), device=dev)
    tok_out = torch.empty((stop_limit, B), **i32)
    packed = step_weights(w, H, L, E, A, V, dt)
    lib = build.library()
    if dt == BF16:
        name, entry = "k5_greedy_decode_bf16", lib.k5_greedy_decode_bf16
        greedy_decode_fused.launches_bf16 += 1
    else:
        name, entry = "k5_greedy_decode", lib.k5_greedy_decode
        greedy_decode_fused.launches += 1
    build.check_launch(name, entry(
        enc.data_ptr(), *(packed[k].data_ptr() for k in STEP_ORDER),
        hbuf.data_ptr(), cbuf.data_ptr(), htbuf.data_ptr(),
        tok_in.data_ptr(), fin.data_ptr(), done.data_ptr(), q.data_ptr(),
        cv.data_ptr(), logits.data_ptr(), tok_out.data_ptr(),
        B, T, H, L, E, A, V, stop_limit,
        torch.cuda.current_stream(dev).cuda_stream))
    return tok_out.t().contiguous()


greedy_decode_fused.launches = 0
greedy_decode_fused.launches_bf16 = 0


def beam_search_streams(enc, dec_h0, dec_c0, w, N, K, stop_limit):
    """Run the K6 kernel (its bf16 entry for ``w`` and ``enc`` in bf16,
    counted in ``launches_bf16``).  Returns its per-step streams tok,
    parent slot and valid (stop_limit, B, N) int32, and the final scores
    (B, N)."""
    B, T, H, L, E, A, V, dt = check_decoder_inputs(enc, dec_h0, dec_c0, w)
    if not 1 <= N <= 32 or not 1 <= K <= V:
        raise ValueError(f"beam kernel takes 1 <= N <= 32 and 1 <= K <= V "
                         f"(got N={N}, K={K}, V={V})")
    check_decode_shapes(B, T, H, E, A, N, K)
    dev = enc.device
    R = B * N
    i32 = dict(dtype=torch.int32, device=dev)
    # state ping-pongs between two slots a step; row r of a step continues
    # row parent[r] of the step before
    hbuf = torch.empty((2, L, R, H), device=dev)
    hbuf[0] = dec_h0.repeat_interleave(N, dim=1)
    cbuf = torch.empty((2, L, R, H), device=dev)
    cbuf[0] = dec_c0.repeat_interleave(N, dim=1)
    htbuf = torch.zeros((2, R, A), device=dev)
    tok_in = torch.full((R,), SYMBOLS.GO_ID, **i32)
    score = torch.full((B, N), NEG_INF, device=dev)
    score[:, 0] = 0.0
    fin = torch.zeros((R,), **i32)
    done = torch.zeros((1,), **i32)
    parent = torch.arange(R, **i32)
    count = torch.zeros((2,), **i32)
    q = torch.empty((R, H), device=dev)
    cv = torch.empty((R, H), device=dev)
    logits = torch.empty((R, V), device=dev)
    tok = torch.empty((stop_limit, R), **i32)
    par = torch.empty((stop_limit, R), **i32)
    valid = torch.empty((stop_limit, R), **i32)
    packed = step_weights(w, H, L, E, A, V, dt)
    lib = build.library()
    if dt == BF16:
        name, entry = "k6_beam_decode_bf16", lib.k6_beam_decode_bf16
        beam_search_streams.launches_bf16 += 1
    else:
        name, entry = "k6_beam_decode", lib.k6_beam_decode
        beam_search_streams.launches += 1
    build.check_launch(name, entry(
        enc.data_ptr(), *(packed[k].data_ptr() for k in STEP_ORDER),
        hbuf.data_ptr(), cbuf.data_ptr(), htbuf.data_ptr(),
        tok_in.data_ptr(), score.data_ptr(), fin.data_ptr(),
        done.data_ptr(), parent.data_ptr(), count.data_ptr(), q.data_ptr(),
        cv.data_ptr(), logits.data_ptr(), tok.data_ptr(), par.data_ptr(),
        valid.data_ptr(), B, N, K, T, H, L, E, A, V, stop_limit,
        torch.cuda.current_stream(dev).cuda_stream))
    shape = (stop_limit, B, N)
    return tok.view(shape), par.view(shape), valid.view(shape), score


beam_search_streams.launches = 0
beam_search_streams.launches_bf16 = 0


def backtrack(tok, par, valid):
    """Follow parent pointers back from the final slots and left-compact
    the valid tokens behind a leading GO (``beam_decode_fused``'s
    outside-the-kernel bookkeeping).  Returns (hyps, lengths)."""
    U, B, N = tok.shape
    slot = torch.arange(N, device=tok.device).expand(B, N)
    toks, valids = [], []
    for t in reversed(range(U)):
        toks.append(tok[t].gather(1, slot))
        valids.append(valid[t].gather(1, slot))
        slot = par[t].gather(1, slot).long()
    toks = torch.stack(toks[::-1])                       # (U, B, N)
    valids = torch.stack(valids[::-1])
    pos = torch.cumsum(valids, dim=0) - valids + 1       # target columns
    # invalid steps write into a spare column that is cut off below
    pos = torch.where(valids > 0, pos, U + 1).long()
    hyps = torch.full((B, N, U + 2), SYMBOLS.PAD_ID, dtype=torch.int32,
                      device=tok.device)
    hyps[:, :, 0] = SYMBOLS.GO_ID
    hyps.scatter_(2, pos.permute(1, 2, 0), toks.permute(1, 2, 0))
    lengths = (1 + valids.sum(dim=0)).to(torch.int32)
    return hyps[:, :, :U + 1], lengths


def beam_decode_fused(enc, dec_h0, dec_c0, w, N, K, stop_limit):
    """Beam search.  Returns (hyps (B, N, stop_limit+1) int32 starting
    with GO, scores (B, N) summed log-probs, lengths (B, N) int32) -- the
    contract of ``ast_tpu.ops.beam.make_beam_decoder``."""
    if not enc.is_cuda:
        return beam_reference(enc, dec_h0, dec_c0, w, N, K, stop_limit)
    tok, par, valid, scores = beam_search_streams(enc, dec_h0, dec_c0, w,
                                                  N, K, stop_limit)
    hyps, lengths = backtrack(tok, par, valid)
    return hyps, scores, lengths
