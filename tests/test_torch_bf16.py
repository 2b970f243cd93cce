"""ast_tpu_torch's bfloat16 decoding (``extras.compute_dtype:
"bfloat16"``; plain versions on the CPU) against ast_tpu's bf16 pieces.

On XLA:CPU ``ast_tpu``'s ``encode`` cannot run at bf16 (its hoisted
layer-0 einsum ``"tdbi,dih->tdbh"`` of two bf16 operands into f32 is not
implemented there), so the reference is composed from the pieces that
do run: ``conv_frontend(..., compute_dtype=bf16)``, the layer-0
projection computed here as ``ast_tpu`` writes it (an f32 product of
bf16-rounded operands), ``fused_stacked_lstm`` with bf16 ``wx`` / ``wh``
in interpret mode, then ``seq2seq._fused_greedy`` and
``ops.fused_infer.beam_decode_fused`` (interpret mode) over
``pack_decoder_weights(params, bf16, Vp)`` and the encoder states cast
to bf16.  The same numpy inputs and parameters go through both packages.

Tolerances: both packages round the same values to bf16 at the same
points and accumulate in f32, so at these sizes only the f32 summation
order differs: conv outputs and encoder states within 1e-5 absolute (a
few recurrent steps of O(1) values in f32), beam scores within 1e-4 (sums
of a dozen log-probs of O(10)); tokens, lengths and ``n_steps`` exactly.
Dropping any one rounding point (the attention weights, the biases, the
products' left operands, the encoder states) moves the beam scores by
more than 1e-4 (``test_each_rounding_point_matters``).
"""

import copy
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ast_tpu.models import seq2seq as jax_seq2seq
from ast_tpu.ops import attention as jax_attention
from ast_tpu.ops import beam as jax_beam
from ast_tpu.ops.cnn import conv_frontend as jax_conv_frontend
from ast_tpu.ops.fused_decoder import round_up
from ast_tpu.ops.fused_infer import beam_decode_fused as jax_beam_fused
from ast_tpu.ops.fused_lstm import fused_stacked_lstm as jax_fused_lstm
from ast_tpu.ops.fused_lstm import pack_encoder_weights as jax_pack_encoder
from ast_tpu.symbols import SYMBOLS
from ast_tpu.train import checkpoint as jax_ckpt
from ast_tpu_torch import serving
from ast_tpu_torch.cli import beam as beam_cli
from ast_tpu_torch.cli import export_model, infer, serve
from ast_tpu_torch.cli import train as train_cli
from ast_tpu_torch.config import Config
from ast_tpu_torch.detok import dec_i2w, get_hyps
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.ops import beam as beam_ops
from ast_tpu_torch.ops import bf16 as bf16_ops
from ast_tpu_torch.ops import fused_infer, fused_lstm
from ast_tpu_torch.ops.cnn import conv_frontend
from ast_tpu_torch.params import from_jax_numpy
from ast_tpu_torch.train.trainer import NN
from tests.conftest import TINY_MODEL_CFG, make_tiny_experiment
from tests.test_torch_bf16_scan import _ExactBf16, torch_threads

BF = torch.bfloat16
V = 12
STOP = 14
N_BEAM, K_BEAM = 3, 3
ATOL = 1e-5
SCORE_TOL = 1e-4


def _mcfg(**rnn):
    m = copy.deepcopy(TINY_MODEL_CFG)
    m["rnn_config"] = dict(m["rnn_config"], dec_vocab_size=V,
                           fused_encoder=True, fused_decoder=True,
                           fused_interpret=True, **rnn)
    m["dropout"] = {"embed": 0.0, "rnn": 0.0, "out": 0}
    return m


def _bf16_np(a):
    """numpy f32 -> rounded to bf16 -> f32 (JAX's astype round trip)."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


# ---------------------------------------------------------------------------
# the composed ast_tpu reference
# ---------------------------------------------------------------------------

def jax_encode_bf16(params, state, mcfg, X):
    """``ast_tpu``'s encode at bf16 from its pieces: (enc_states (B, T',
    H) f32, dec_h0, dec_c0) as numpy."""
    h_cnn, _ = jax_conv_frontend(params["cnn"], state["cnn_bn"],
                                 mcfg["cnn_config"], jnp.asarray(X), False,
                                 jnp.bfloat16)
    seq = np.transpose(np.asarray(h_cnn), (1, 0, 2))
    xs = np.stack([seq, seq[::-1]], axis=1)              # (T', 2, B, C)
    layers = params["enc"]["lstm"]
    x0 = np.einsum("tdbi,dih->tdbh", _bf16_np(xs),
                   _bf16_np(layers[0]["wx"])).astype(np.float32)
    wx_rest, wh, b = jax_pack_encoder(layers)
    outs, h_fin, c_fin = jax_fused_lstm(
        jnp.asarray(x0), wx_rest.astype(jnp.bfloat16),
        wh.astype(jnp.bfloat16), b, 0, False, 0.0, True)
    outs, h_fin, c_fin = (np.asarray(a) for a in (outs, h_fin, c_fin))
    enc = np.concatenate([outs[:, 0], outs[:, 1][::-1]], axis=-1)
    return (np.ascontiguousarray(np.transpose(enc, (1, 0, 2))),
            np.concatenate([h_fin[:, 0], h_fin[:, 1]], axis=-1),
            np.concatenate([c_fin[:, 0], c_fin[:, 1]], axis=-1))


def jax_greedy_bf16(params, mcfg, enc, h0, c0, stop):
    """(preds (B, stop), n_steps) of ``ast_tpu``'s fused greedy at bf16."""
    preds = np.asarray(jax_seq2seq._fused_greedy(
        params, mcfg, jnp.asarray(enc), jnp.asarray(h0), jnp.asarray(c0),
        stop, jnp.bfloat16, enc.shape[0], None))
    is_eos = preds == SYMBOLS.EOS_ID
    per_row = np.where(is_eos.any(axis=1), is_eos.argmax(axis=1) + 1, stop)
    return preds, int(per_row.max())


def jax_beam_bf16(params, mcfg, enc, h0, c0, N, K, stop):
    """(hyps, scores, lengths) of ``ast_tpu``'s fused beam at bf16."""
    Vp = round_up(mcfg["rnn_config"]["dec_vocab_size"], 128)
    w = jax_seq2seq.pack_decoder_weights(params, jnp.bfloat16, Vp)
    out = jax_beam_fused(jnp.asarray(enc).astype(jnp.bfloat16),
                         jnp.asarray(h0), jnp.asarray(c0), w, N, K, stop,
                         True)
    return tuple(np.asarray(a) for a in out)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    mcfg = _mcfg()
    # a tiny random model whose rows decode different tokens and finish
    # at staggered steps (the last at step 9 of 14)
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(6), mcfg)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    # non-zero biases everywhere, so that their rounding shows
    rng = np.random.RandomState(8)
    for lp in params["dec"]["lstm"]:
        lp["b"] = lp["b"] + rng.randn(*lp["b"].shape).astype(
            np.float32) * 0.1
    for leaf in (params["attn"]["wa"][0], params["attn"]["context"]):
        leaf["b"] = rng.randn(*leaf["b"].shape).astype(np.float32) * 0.1
    X = np.random.RandomState(4).randn(4, 44, 13).astype(np.float32)
    tp, ts = from_jax_numpy(params, state)
    return params, state, X, tp, ts, mcfg


@pytest.fixture(scope="module")
def reference(model):
    """The composed ast_tpu pipeline on the model's batch."""
    params, state, X, _, _, mcfg = model
    enc, h0, c0 = jax_encode_bf16(params, state, mcfg, X)
    return dict(enc=enc, h0=h0, c0=c0,
                greedy=jax_greedy_bf16(params, mcfg, enc, h0, c0, STOP),
                beam=jax_beam_bf16(params, mcfg, enc, h0, c0, N_BEAM,
                                   K_BEAM, STOP))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_conv_frontend_bf16_matches_jax(model):
    params, state, X, tp, ts, mcfg = model
    ref, _ = jax_conv_frontend(params["cnn"], state["cnn_bn"],
                               mcfg["cnn_config"], jnp.asarray(X), False,
                               jnp.bfloat16)
    got, _ = conv_frontend(tp["cnn"], ts["cnn_bn"], mcfg["cnn_config"],
                           torch.from_numpy(X), compute_dtype=BF)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    # the rounding is real: the f32 front-end is further away than that
    f32, _ = conv_frontend(tp["cnn"], ts["cnn_bn"], mcfg["cnn_config"],
                           torch.from_numpy(X))
    assert float(np.abs(f32.numpy() - np.asarray(ref)).max()) > 10 * ATOL


def test_stacked_lstm_bf16_matches_interpret_kernel():
    rng = np.random.RandomState(0)
    T, L, D2, B, H = 7, 3, 2, 3, 16
    x0 = rng.randn(T, D2, B, 4 * H).astype(np.float32)
    wx = (rng.randn(L - 1, D2, H, 4 * H) * 0.3).astype(np.float32)
    wh = (rng.randn(L, D2, H, 4 * H) * 0.3).astype(np.float32)
    b = (rng.randn(L, D2, 4 * H) * 0.1).astype(np.float32)
    ref = jax_fused_lstm(jnp.asarray(x0), jnp.asarray(wx).astype(
        jnp.bfloat16), jnp.asarray(wh).astype(jnp.bfloat16),
        jnp.asarray(b), 0, False, 0.0, True)
    t = [torch.from_numpy(a) for a in (x0, wx, wh, b)]
    got = fused_lstm.fused_stacked_lstm(t[0], t[1].to(BF), t[2].to(BF), t[3])
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=ATOL)
    # and the bf16 pack keeps the weights' dtype: the f32 pack's column
    # blocks of the same values, each (layer, direction)'s in the tensor
    # cores' tile order, at a width the kernels take (H = 16 is refused)
    with pytest.raises(ValueError, match="multiple of 32"):
        fused_lstm.pack_encoder_step_weights(t[1].to(BF), t[2].to(BF))
    H = 32
    wx, wh = (torch.from_numpy((rng.randn(*shape) * 0.3).astype(
        np.float32)).to(BF) for shape in ((L - 1, D2, H, 4 * H),
                                           (L, D2, H, 4 * H)))
    packed = fused_lstm.pack_encoder_step_weights(wx, wh)
    assert packed.dtype == BF
    blocks = fused_lstm.pack_encoder_step_weights(wx.float(), wh.float())
    assert packed.numel() == blocks.numel()
    off = 0
    for K in [H] * D2 + [2 * H] * (L - 1) * D2:
        n = K * 4 * H
        assert torch.equal(packed[off:off + n].float(), fused_infer.mma_tiles(
            blocks[off:off + n].view(H // 16, K, 64)).view(-1))
        off += n


def test_encode_bf16_matches_composed_jax(model, reference):
    params, state, X, tp, ts, mcfg = model
    w = seq2seq.decode_weights(tp, BF)
    got = seq2seq.encode(tp, ts, mcfg, torch.from_numpy(X), w, BF)
    for r, g in zip((reference["enc"], reference["h0"], reference["c0"]),
                    got):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=ATOL)


def test_greedy_bf16_matches_jax_kernel(model, reference):
    """K5's plain version at bf16 against ``_fused_greedy`` at bf16, given
    the same f32 encoder states."""
    _, _, _, tp, _, mcfg = model
    enc = torch.from_numpy(reference["enc"]).to(BF)
    h0, c0 = (torch.from_numpy(reference[k]) for k in ("h0", "c0"))
    w = seq2seq.decode_weights(tp, BF)
    got = fused_infer.greedy_decode_fused(enc, h0, c0, w, STOP)
    want, n_steps = reference["greedy"]
    np.testing.assert_array_equal(got.numpy(), want)
    assert 1 < n_steps < STOP   # rows finish at staggered steps


def test_beam_bf16_matches_jax_kernel(model, reference):
    _, _, _, tp, _, mcfg = model
    enc = torch.from_numpy(reference["enc"]).to(BF)
    h0, c0 = (torch.from_numpy(reference[k]) for k in ("h0", "c0"))
    w = seq2seq.decode_weights(tp, BF)
    hyps, scores, lengths = fused_infer.beam_decode_fused(
        enc, h0, c0, w, N_BEAM, K_BEAM, STOP)
    r_hyps, r_scores, r_lens = reference["beam"]
    np.testing.assert_array_equal(hyps.numpy(), r_hyps)
    np.testing.assert_array_equal(lengths.numpy(), r_lens)
    np.testing.assert_allclose(scores.numpy(), r_scores, rtol=0,
                               atol=SCORE_TOL)


def test_decode_slice_bf16_matches_composed_jax(model, reference):
    """The slice end to end: ``predict_greedy`` and the beam decoder at
    ``compute_dtype`` bf16 from the features, against the composed
    ast_tpu pieces."""
    _, _, X, tp, ts, mcfg = model
    Xt = torch.from_numpy(X)
    preds, n_steps = seq2seq.predict_greedy(tp, ts, mcfg, Xt, STOP,
                                            compute_dtype=BF)
    want, want_steps = reference["greedy"]
    np.testing.assert_array_equal(preds.numpy(), want)
    assert int(n_steps) == want_steps
    hyps, scores, lengths = beam_ops.make_beam_decoder(
        mcfg, N_BEAM, K_BEAM, STOP, compute_dtype=BF)(tp, ts, Xt)
    r_hyps, r_scores, r_lens = reference["beam"]
    np.testing.assert_array_equal(hyps.numpy(), r_hyps)
    np.testing.assert_array_equal(lengths.numpy(), r_lens)
    np.testing.assert_allclose(scores.numpy(), r_scores, rtol=0,
                               atol=SCORE_TOL)
    # the f32 decode of the same model is another function
    f32_scores = beam_ops.make_beam_decoder(mcfg, N_BEAM, K_BEAM, STOP)(
        tp, ts, Xt)[1]
    assert float((f32_scores - scores).abs().max()) > 10 * SCORE_TOL


def test_decode_weights_bf16_layouts(model):
    """Every leaf of the bf16 decode pack is bf16; the step pack keeps
    its matrices in bf16, in the tensor-core tiles of
    pack_step_weights_mma, and its embedding and biases in f32 holding
    the rounded values; the encoder's matrices are bf16, its bias f32."""
    _, _, _, tp, _, _ = model
    w = seq2seq.decode_weights(tp, BF)
    assert all(w[k].dtype == BF for k in fused_infer._WEIGHT_ORDER)
    step = w["step"]
    for k in fused_infer.STEP_ORDER:
        want = BF if k in ("cell", "wa", "ctx_w", "out_w") else torch.float32
        assert step[k].dtype == want, k
    assert torch.equal(step["out_b"], w["out_b"].float())
    w32 = seq2seq.decode_weights(tp)
    assert step["cell"].dim() == 2
    assert torch.equal(step["cell"].float(),
                       fused_infer.pack_step_weights_mma(
                           {k: v.float() if torch.is_tensor(v) else v
                            for k, v in w.items()})["cell"])
    assert w32["step"]["cell"].dtype == torch.float32
    wx_rest, wh, b, packed = w["enc"]
    # 8 units a direction: no K1 pack at this width (the plain version)
    assert (wx_rest.dtype, wh.dtype, b.dtype, packed) == (
        BF, BF, torch.float32, None)
    with pytest.raises(ValueError, match="compute dtype"):
        seq2seq.predict_greedy(tp, None, _mcfg(), None, STOP, w32,
                               compute_dtype=BF)


def test_bf16_decodes_from_mma_pack_as_before(model, reference):
    """Greedy and beam on the CPU from the bf16 decode_weights (the
    tensor-core step pack) give the tokens, lengths and scores they gave
    with the column-block step pack, which are ast_tpu's."""
    _, _, _, tp, _, _ = model
    enc = torch.from_numpy(reference["enc"]).to(BF)
    h0, c0 = (torch.from_numpy(reference[k]) for k in ("h0", "c0"))
    w = seq2seq.decode_weights(tp, BF)
    w_old = dict(w, step=fused_infer.pack_step_weights(w))
    got = fused_infer.greedy_decode_fused(enc, h0, c0, w, STOP)
    assert torch.equal(got, fused_infer.greedy_decode_fused(
        enc, h0, c0, w_old, STOP))
    np.testing.assert_array_equal(got.numpy(), reference["greedy"][0])
    beam = fused_infer.beam_decode_fused(enc, h0, c0, w, N_BEAM, K_BEAM,
                                         STOP)
    old = fused_infer.beam_decode_fused(enc, h0, c0, w_old, N_BEAM, K_BEAM,
                                        STOP)
    assert all(torch.equal(a, b) for a, b in zip(beam, old))
    np.testing.assert_array_equal(beam[0].numpy(), reference["beam"][0])


@pytest.mark.parametrize("point", ["alphas", "biases", "operands", "enc"])
def test_each_rounding_point_matters(model, reference, monkeypatch, point):
    """Leaving out one of ``ast_tpu``'s rounding points moves the beam
    scores beyond SCORE_TOL, so the tests above hold each of them."""
    _, _, _, tp, _, mcfg = model
    enc = torch.from_numpy(reference["enc"])
    h0, c0 = (torch.from_numpy(reference[k]) for k in ("h0", "c0"))
    w = seq2seq.decode_weights(tp, BF)
    if point == "alphas":
        # the softmax weights into the context sum left in f32
        monkeypatch.setattr(fused_infer, "rounded", lambda x: x)
    elif point == "biases":
        w = dict(w, **{k: seq2seq.pack_decoder_weights(tp)[k]
                       for k in ("b", "wa_b", "ctx_b", "out_b")})
    elif point == "operands":
        monkeypatch.setattr(fused_infer, "dot",
                            lambda a, m: a @ bf16_ops.widen(m))
    enc = enc if point == "enc" else enc.to(BF)
    scores = fused_infer.beam_reference(enc, h0, c0, w, N_BEAM, K_BEAM,
                                        STOP)[1]
    r_scores = reference["beam"][1]
    assert float(np.abs(scores.numpy() - r_scores).max()) > SCORE_TOL


def test_bf16_refuses_scan_path_variants_by_name(model, monkeypatch):
    """Once refused by name at bf16, the scan-path variants (``ln``, two
    attention heads, blockwise attention) decode at bf16 equal to
    ast_tpu's bf16 decode of the same model (its scan path, its einsums
    widened as tests/test_torch_bf16_scan.py runs them): greedy ids
    exactly, beam hyps exactly and scores within SCORE_TOL; so does
    ``return_attn`` on the kernels' model, with its histories within
    ATOL."""
    _, _, X, _, _, _ = model
    for mod in (jax_seq2seq, jax_attention):
        monkeypatch.setattr(mod, "jnp", _ExactBf16())
    x = jnp.asarray(X)
    for edit, seed in (({"ln": True}, 1), ({"n_attn": 2}, 2),
                       ({"attn_block_size": 8}, 3), ({}, 4)):
        mcfg = _mcfg(**edit)
        params, state = jax_seq2seq.init_model(jax.random.PRNGKey(seed),
                                               mcfg)
        tp, ts = from_jax_numpy(*(jax.tree.map(np.asarray, t)
                                  for t in (params, state)))
        return_attn = not edit
        if edit:
            want = jax_seq2seq.predict_greedy(params, state, mcfg, x, STOP,
                                              compute_dtype=jnp.bfloat16)
            got = seq2seq.predict_greedy(tp, ts, mcfg, torch.from_numpy(X),
                                         STOP, compute_dtype=BF)
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(want[0]))
            assert int(got[1]) == int(want[1])
        want = jax_beam.make_beam_decoder(
            mcfg, 2, 2, STOP, compute_dtype=jnp.bfloat16,
            return_attn=return_attn)(params, state, x)
        got = beam_ops.make_beam_decoder(
            mcfg, 2, 2, STOP, return_attn, compute_dtype=BF)(
                tp, ts, torch.from_numpy(X))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=0, atol=SCORE_TOL)
        if return_attn:
            np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                                       rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _set_bf16(exp):
    path = os.path.join(exp, "train_cfg.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["extras"]["compute_dtype"] = "bfloat16"
    with open(path, "w") as f:
        json.dump(cfg, f)


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A tiny experiment at compute_dtype bfloat16 with an ast_tpu
    checkpoint (EOS held back so reranked beams are not all empty)."""
    root = tmp_path_factory.mktemp("torch_bf16")
    exp = make_tiny_experiment(str(root))
    _set_bf16(exp)
    from ast_tpu.config import Config as JaxConfig
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(11),
                                           JaxConfig(exp).model)
    params["dec"]["out_b"] = params["dec"]["out_b"].at[2].add(-2.0)
    jax_ckpt.save_checkpoint(os.path.join(exp, "seq2seq_2.model.npz"),
                             params, state)
    speech = os.path.join(str(root), "speech", "tiny_dev")
    paths = [os.path.join(speech, f) for f in sorted(os.listdir(speech))]
    mcfg = dict(Config(exp).model)
    mcfg["rnn_config"] = dict(mcfg["rnn_config"], fused_interpret=True)
    return dict(exp=exp, paths=paths, mcfg=mcfg, root=str(root),
                params=jax.tree.map(np.asarray, params),
                state=jax.tree.map(np.asarray, state))


def _jax_decode(e, X, stop, beam_nk=None, params=None):
    """The composed ast_tpu reference on a batch X (B, T, 13)."""
    p = e["params"] if params is None else params
    enc, h0, c0 = jax_encode_bf16(p, e["state"], e["mcfg"], X)
    if beam_nk is None:
        return jax_greedy_bf16(p, e["mcfg"], enc, h0, c0, stop)[0]
    return jax_beam_bf16(p, e["mcfg"], enc, h0, c0, *beam_nk, stop)


def test_cli_infer_bf16_matches_composed_jax(experiment):
    """cli.infer at the experiment's compute_dtype bfloat16, greedy and
    beam, gives the text of the composed reference on the same padded
    batches (cli.infer's buckets, batch 3; two files of one bucket keep
    the interpret-mode compiles to one shape)."""
    e = experiment
    cfg = Config(e["exp"])
    data = cfg.train["data"]
    stop, width = int(data["max_pred"]), int(data["buckets_width"])
    paths = [e["paths"][1], e["paths"][3]]      # one bucket: T = 200
    feats = [(os.path.splitext(os.path.basename(p))[0], np.load(p))
             for p in paths]
    groups = {}
    for utt, x in feats:
        groups.setdefault(max(width, -(-len(x) // width) * width),
                          []).append((utt, x))
    for beam_nk in (None, (3, 3)):
        want = {}
        for T, items in sorted(groups.items()):
            for i in range(0, len(items), 3):
                chunk = items[i:i + 3]
                X = np.zeros((len(chunk), T, 13), np.float32)
                for j, (_, x) in enumerate(chunk):
                    X[j, :len(x)] = x
                out = _jax_decode(e, X, stop, beam_nk)
                for j, (utt, _) in enumerate(chunk):
                    if beam_nk is None:
                        p = out[j]
                        eos = np.nonzero(p == SYMBOLS.EOS_ID)[0]
                        want[utt] = (p[:eos[0]] if eos.size else p).tolist()
                    else:
                        hyps, scores, lens = out
                        want[utt] = beam_ops.get_best_hyps({utt: [
                            (hyps[j, n, :lens[j, n]].tolist(),
                             float(scores[j, n]))
                            for n in range(beam_nk[0])]}, 0.6)[utt]
        text = get_hyps(want.items(), dec_i2w(cfg.train), data["dec_key"])
        extra = [] if beam_nk is None else ["--beam", "3,3", "-w", "0.6"]
        got = infer.main(["-m", e["exp"], "--batch", "3", "--device", "cpu"]
                         + extra + paths)
        assert got == {u: " ".join(text[u]) for u, _ in feats}
        assert any(got.values())


def test_cli_beam_bf16_matches_composed_jax(experiment, monkeypatch):
    """cli.beam at compute_dtype bfloat16: every pickled beam of the dev
    split equals the composed reference on the batch the decoder saw
    (ids exactly, scores within SCORE_TOL)."""
    e = experiment
    seen = []
    features = NN.features

    def record(self, batch):
        X = features(self, batch)
        seen.append((list(batch["utts"]), X.numpy().copy()))
        return X

    monkeypatch.setattr(NN, "features", record)
    beam_cli.main(["-m", e["exp"], "-n", "3", "-k", "3", "-s", "tiny_dev",
                   "-w", "0.6", "--device", "cpu"])
    with open(os.path.join(e["exp"], "tiny_dev_beam_N-3_K-3.p"), "rb") as f:
        got = pickle.load(f)
    stop = int(Config(e["exp"]).train["data"]["max_pred"])
    assert seen and sum(len(u) for u, _ in seen) == len(got)
    for utts, X in seen:
        hyps, scores, lens = _jax_decode(e, X, stop, (3, 3))
        for j, utt in enumerate(utts):
            for n, (ids, score) in enumerate(got[utt]):
                assert ids == hyps[j, n, :lens[j, n]].tolist()
                assert abs(score - float(scores[j, n])) <= SCORE_TOL


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "bf16_q8"])
def test_export_and_serve_bf16(experiment, tmp_path, quantize):
    """export_model --dtype bfloat16 (and, from the bf16 experiment's own
    compute_dtype, with --quantize int8) writes compute_dtype bfloat16;
    cli.serve's handler decodes the composed reference's tokens on the
    CPU, int8 weights dequantized to f32 before the bf16 rounding."""
    e = experiment
    out = str(tmp_path / "serving")
    argv = ["-m", e["exp"], "--batch", "2", "--frames", "60", "--beam",
            "2,2", "-o", out]
    argv += ["--quantize", "int8", "--quantize-min-size", "64"] if quantize \
        else ["--dtype", "bfloat16"]
    export_model.main(argv)
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f)["compute_dtype"] == "bfloat16"
    params = e["params"]
    if quantize:
        with np.load(os.path.join(out, serving.WEIGHTS)) as z:
            tree = serving.unflatten({k: z[k] for k in z.files})
        params = jax.tree.map(lambda t: t.numpy(), serving.dequantize_params(
            tree["params"]))
    server = serve.ArtifactServer(out, device="cpu")
    stop = int(server.manifest["stop_limit"])
    x = np.load(e["paths"][0]).astype(np.float32)[:60]
    X = np.zeros((1, 60, 13), np.float32)
    X[0, :len(x)] = x
    got = server.decode({"features": x, "mode": "greedy"})
    p = _jax_decode(e, X, stop, params=params)[0]
    eos = np.nonzero(p == SYMBOLS.EOS_ID)[0]
    assert got["ids"] == (p[:eos[0]] if eos.size else p).tolist()
    got_b = server.decode({"features": x, "mode": "beam"})
    hyps, scores, lens = _jax_decode(e, X, stop, (2, 2), params=params)
    best = beam_ops.rerank_hypothesis(
        [(hyps[0, n, :lens[0, n]].tolist(), float(scores[0, n]))
         for n in range(2)], 0.6)[0]
    ids = best[0][1:]
    if ids and ids[-1] == SYMBOLS.EOS_ID:
        ids = ids[:-1]
    assert got_b["ids"] == ids
    assert abs(got_b["score"] - best[1]) <= SCORE_TOL


def test_training_refuses_bf16_by_name(tmp_path, monkeypatch):
    """compute_dtype bfloat16 trains the model the kernels take
    (tests/test_torch_bf16_train.py holds it to ast_tpu): NN builds,
    train_epoch and eval_loss give finite losses and cli.train writes its
    log.  A scan-path variant (``rnn_relu``), once refused by name, now
    builds, evaluates to ast_tpu's NN's bf16 dev loss on the same
    checkpoint (its einsums widened as tests/test_torch_bf16_scan.py runs
    them) within 1e-5 relative, and exports a bf16 serving directory
    whose server decodes as ``predict_greedy`` at bf16."""
    exp = make_tiny_experiment(str(tmp_path))
    _set_bf16(exp)
    nn = NN(exp, "cpu")
    assert nn.compute_dtype == BF
    assert np.isfinite(nn.train_epoch("tiny_train", epoch=1))
    assert np.isfinite(nn.eval_loss("tiny_dev"))
    train_cli.main(["-m", exp, "-e", "1", "--device", "cpu"])
    with open(os.path.join(exp, "train.log")) as f:
        assert len(f.read().split()) >= 2
    path = os.path.join(exp, "model_cfg.json")
    with open(path) as f:
        mcfg = json.load(f)
    mcfg["rnn_config"]["rnn_relu"] = True
    with open(path, "w") as f:
        json.dump(mcfg, f)
    with torch_threads(1):
        _rnn_relu_bf16_matches_ast_tpu(exp, tmp_path, monkeypatch)


def _rnn_relu_bf16_matches_ast_tpu(exp, tmp_path, monkeypatch):
    nn = NN(exp, "cpu")
    assert nn.compute_dtype == BF and nn.max_epoch == 1
    for mod in (jax_seq2seq, jax_attention):
        monkeypatch.setattr(mod, "jnp", _ExactBf16())
    from ast_tpu.train.trainer import NN as JaxNN
    ref = JaxNN(exp)
    assert ref.max_epoch == 1 and ref.compute_dtype == jnp.bfloat16
    want = ref.eval_loss("tiny_dev")
    got = nn.eval_loss("tiny_dev")
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    out = str(tmp_path / "s")
    export_model.main(["-m", exp, "-o", out, "--batch", "1",
                       "--frames", "400"])
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f)["compute_dtype"] == "bfloat16"
    server = serve.ArtifactServer(out, device="cpu")
    speech = os.path.join(str(tmp_path), "speech", "tiny_dev")
    x = np.load(os.path.join(speech, sorted(os.listdir(speech))[0]))
    X = np.zeros((1, 400, 13), np.float32)
    X[0, :len(x)] = x[:400]
    ids = seq2seq.predict_greedy(
        nn.params, nn.state, nn.mcfg, torch.from_numpy(X),
        int(server.manifest["stop_limit"]), compute_dtype=BF)[0][0].tolist()
    eos = ids.index(SYMBOLS.EOS_ID) if SYMBOLS.EOS_ID in ids else len(ids)
    got = server.decode({"features": x.astype(np.float32), "mode": "greedy"})
    assert got["ids"] == ids[:eos]
