"""ast_tpu_torch's decode path (plain PyTorch versions on the CPU) vs
ast_tpu with its Pallas kernels in interpret mode.

Same parameters (through the weight bridge) and the same numpy inputs go
through both packages, in float32.  Tolerances: 1e-5 absolute on
float outputs (a few recurrent steps in f32, where summation order is the
only difference); decoded tokens, lengths and n_steps exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ast_tpu.models import seq2seq as jax_seq2seq
from ast_tpu.ops import beam as jax_beam
from ast_tpu.ops.cnn import conv_frontend as jax_conv_frontend
from ast_tpu.ops.fused_lstm import fused_stacked_lstm as jax_fused_lstm
from ast_tpu.symbols import SYMBOLS
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.ops import beam as beam_ops
from ast_tpu_torch.ops import fused_infer, fused_lstm
from ast_tpu_torch.ops.cnn import conv_frontend
from ast_tpu_torch.params import from_jax_numpy
from tests.conftest import TINY_MODEL_CFG

V = 12
STOP = 14
ATOL = 1e-5


def _mcfg(**rnn):
    m = jax.tree.map(lambda x: x, TINY_MODEL_CFG)
    m["rnn_config"] = dict(m["rnn_config"], dec_vocab_size=V,
                           fused_encoder=True, fused_decoder=True,
                           fused_interpret=True, **rnn)
    m["dropout"] = {"embed": 0.0, "rnn": 0.0, "out": 0}
    return m


@pytest.fixture(scope="module")
def model():
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(3), _mcfg())
    # EOS bias staggers sentence-finish steps (as tests/test_fused_infer)
    params["dec"]["out_b"] = params["dec"]["out_b"].at[
        SYMBOLS.EOS_ID].add(2.0)
    # non-trivial BatchNorm running statistics
    rng = np.random.RandomState(7)
    state = jax.tree.map(np.asarray, state)
    for s in state["cnn_bn"]:
        s["bn_mean"] = rng.randn(*s["bn_mean"].shape).astype(np.float32)
        s["bn_var"] = rng.uniform(0.5, 2.0, s["bn_var"].shape).astype(
            np.float32)
    X = (np.random.RandomState(4).randn(4, 44, 13) * 0.5).astype(np.float32)
    params = jax.tree.map(np.asarray, params)
    tp, ts = from_jax_numpy(params, state)
    return params, state, X, tp, ts


def test_conv_frontend_matches_jax(model):
    params, state, X, tp, ts = model
    ref, _ = jax_conv_frontend(params["cnn"], state["cnn_bn"],
                               _mcfg()["cnn_config"], jnp.asarray(X), False)
    got, _ = conv_frontend(tp["cnn"], ts["cnn_bn"], _mcfg()["cnn_config"],
                           torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    # bn: false -- a bias in BatchNorm's place and an empty state a layer
    mcfg = _mcfg()
    mcfg["cnn_config"] = dict(mcfg["cnn_config"], bn=False)
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(3), mcfg)
    rng = np.random.RandomState(2)
    cnn = [dict(jax.tree.map(np.asarray, p),
                b=rng.randn(*p["b"].shape).astype(np.float32))
           for p in params["cnn"]]
    assert state["cnn_bn"] == [{}, {}] and "bn_gamma" not in cnn[0]
    tp, ts = from_jax_numpy({"cnn": cnn}, state)
    for train in (False, True):
        ref, ref_state = jax_conv_frontend(cnn, state["cnn_bn"],
                                           mcfg["cnn_config"],
                                           jnp.asarray(X), train)
        got, got_state = conv_frontend(tp["cnn"], ts["cnn_bn"],
                                       mcfg["cnn_config"],
                                       torch.from_numpy(X), train)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)
        assert got_state == list(ref_state) == [{}, {}]


def test_stacked_lstm_reference_matches_interpret_kernel():
    rng = np.random.RandomState(0)
    T, L, D2, B, H = 7, 3, 2, 3, 8
    x0 = rng.randn(T, D2, B, 4 * H).astype(np.float32)
    wx = (rng.randn(L - 1, D2, H, 4 * H) * 0.3).astype(np.float32)
    wh = (rng.randn(L, D2, H, 4 * H) * 0.3).astype(np.float32)
    b = (rng.randn(L, D2, 4 * H) * 0.1).astype(np.float32)
    ref = jax_fused_lstm(jnp.asarray(x0), jnp.asarray(wx), jnp.asarray(wh),
                         jnp.asarray(b), 0, False, 0.0, True)
    got = fused_lstm.fused_stacked_lstm(*(torch.from_numpy(a) for a in
                                          (x0, wx, wh, b)))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("quirk", [False, True])
def test_encode_matches_jax(model, quirk):
    params, state, X, tp, ts = model
    mcfg = _mcfg(ref_rev_quirk=quirk)
    ref = jax_seq2seq.encode(params, state, mcfg, jnp.asarray(X),
                             jax.random.PRNGKey(0), False)[:3]
    got = seq2seq.encode(tp, ts, mcfg, torch.from_numpy(X))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("stop", [STOP, 40])
def test_greedy_matches_jax_kernel(model, stop):
    """Tokens and n_steps exactly, including post-EOS tokens of rows that
    finished early and the PAD tail once every row has finished."""
    params, state, X, tp, ts = model
    ref, n_ref = jax_seq2seq.predict_greedy(params, state, _mcfg(),
                                            jnp.asarray(X), stop)
    got, n_got = seq2seq.predict_greedy(tp, ts, _mcfg(), torch.from_numpy(X),
                                        stop)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(n_got) == int(n_ref)


@pytest.mark.parametrize("N,K", [(3, 3), (4, 2)])
def test_beam_matches_jax_kernel(model, N, K):
    """(4, 2) pins distinct-candidate selection when N > K."""
    params, state, X, tp, ts = model
    r_hyps, r_scores, r_lens = (np.asarray(a) for a in
                                jax_beam.make_beam_decoder(
                                    _mcfg(), N=N, K=K, stop_limit=STOP)(
                                    params, state, jnp.asarray(X)))
    g_hyps, g_scores, g_lens = (a.numpy() for a in
                                beam_ops.make_beam_decoder(
                                    _mcfg(), N=N, K=K, stop_limit=STOP)(
                                    tp, ts, torch.from_numpy(X)))
    np.testing.assert_array_equal(g_lens, r_lens)
    np.testing.assert_allclose(g_scores, r_scores, rtol=1e-5, atol=1e-5)
    for b in range(r_hyps.shape[0]):
        for n in range(N):
            L = r_lens[b, n]
            np.testing.assert_array_equal(
                g_hyps[b, n, :L], r_hyps[b, n, :L],
                err_msg=f"hyp mismatch at utt {b} slot {n}")


@pytest.mark.parametrize("N,K", [(3, 3), (4, 2)])
def test_backtrack_rebuilds_reference_hyps(model, N, K):
    """The kernel path's outside-the-kernel bookkeeping: backtracking the
    per-step token / parent / valid streams (as K6 emits them) rebuilds
    the frontier loop's hypotheses and lengths."""
    _, _, X, tp, ts = model
    enc, h0, c0 = seq2seq.encode(tp, ts, _mcfg(), torch.from_numpy(X))
    w = seq2seq.pack_decoder_weights(tp)
    hyps, _, lens, tok, par, val = fused_infer.beam_reference(
        enc, h0, c0, w, N, K, STOP, trace=True)
    b_hyps, b_lens = fused_infer.backtrack(tok, par, val)
    np.testing.assert_array_equal(b_lens.numpy(), lens.numpy())
    for b in range(hyps.shape[0]):
        for n in range(N):
            L = int(lens[b, n])
            np.testing.assert_array_equal(b_hyps[b, n, :L].numpy(),
                                          hyps[b, n, :L].numpy())
    # the EOS bias ends every search before STOP: the streams' tail
    assert (val[-1] == 0).all() and (tok[-1] == SYMBOLS.EOS_ID).all()


def _decoder_inputs(model):
    _, _, X, tp, ts = model
    enc, h0, c0 = seq2seq.encode(tp, ts, _mcfg(), torch.from_numpy(X))
    return enc, h0, c0, seq2seq.pack_decoder_weights(tp)


def test_greedy_follow_scores_decodes(model):
    """greedy_follow (chip_smoke's check of K5 on its own path) passes the
    plain decode with zero shortfall and PAD after it, and measures a
    token that is not the argmax."""
    enc, h0, c0, w = _decoder_inputs(model)
    preds = fused_infer.greedy_reference(enc, h0, c0, w, 40)
    short, n_run = fused_infer.greedy_follow(enc, h0, c0, w, preds)
    assert int(short.abs().max()) == 0 and 0 < n_run < 40
    assert (preds[:, n_run:] == SYMBOLS.PAD_ID).all()
    bad = preds.clone()
    bad[1, 0] = (int(bad[1, 0]) + 1) % V
    short, _ = fused_infer.greedy_follow(enc, h0, c0, w, bad)
    assert float(short[1, 0]) > 0 and int(short[0, 0]) == 0


@pytest.mark.parametrize("N,K", [(3, 3), (4, 2)])
def test_beam_follow_scores_searches(model, N, K):
    """beam_follow (chip_smoke's check of K6 on its own path) passes the
    plain search's streams exactly, and flags a token outside the top K
    and a candidate chosen twice."""
    enc, h0, c0, w = _decoder_inputs(model)
    _, scores, _, tok, par, val = fused_infer.beam_reference(
        enc, h0, c0, w, N, K, STOP, trace=True)
    f_scores, topk_short, sel_err, bad = fused_infer.beam_follow(
        enc, h0, c0, w, N, K, tok, par, val)
    assert torch.equal(f_scores, scores)
    assert not bad.any() and float(topk_short.max()) == 0
    assert float(sel_err.max()) == 0
    # step 1: slot 0 continues its parent with the lowest-ranked token
    worst = tok.clone()
    logits = fused_infer.decode_step_reference(
        w, enc, h0, c0, enc.new_zeros((enc.shape[0], w["ctx_w"].shape[1])),
        torch.full((enc.shape[0],), SYMBOLS.GO_ID))[0]
    worst[0, :, 0] = torch.argmin(logits, dim=-1).to(torch.int32)
    _, topk_short, sel_err, _ = fused_infer.beam_follow(
        enc, h0, c0, w, N, K, worst, par, val)
    assert (topk_short[0] > 0).all() and (sel_err[0] > 0).all()
    twice = tok.clone(), par.clone()
    for a in twice:
        a[0, :, 1] = a[0, :, 0]
    assert fused_infer.beam_follow(enc, h0, c0, w, N, K, *twice,
                                   val)[3][0].all()


def test_cpu_tensors_take_the_plain_versions(model):
    """On CPU tensors the wrappers run their plain versions: no kernel is
    built or launched."""
    _, _, X, tp, ts = model
    counters = (fused_lstm.fused_stacked_lstm,
                fused_infer.greedy_decode_fused,
                fused_infer.beam_search_streams)
    before = [f.launches for f in counters]
    seq2seq.predict_greedy(tp, ts, _mcfg(), torch.from_numpy(X), STOP)
    beam_ops.make_beam_decoder(_mcfg(), 2, 2, STOP)(tp, ts,
                                                    torch.from_numpy(X))
    assert [f.launches for f in counters] == before == [0, 0, 0]


@pytest.mark.parametrize("variant", [{"ln": True}, {"n_attn": 2},
                                     {"feed_attn": False},
                                     {"attn_block_size": 8},
                                     {"bi_rnn": False}])
def test_gate_refuses_unported_variants(model, variant):
    """The variants the decode gate once refused now decode, greedy and
    beam, equal to ast_tpu (its Pallas kernels in interpret mode where it
    runs them, its XLA loops elsewhere): tokens, lengths and n_steps
    exactly, scores within 1e-5."""
    X = model[2]
    mcfg = _mcfg(**variant)
    params, state = jax_seq2seq.init_model(jax.random.PRNGKey(3), mcfg)
    params["dec"]["out_b"] = params["dec"]["out_b"].at[
        SYMBOLS.EOS_ID].add(2.0)
    tp, ts = from_jax_numpy(jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, state))
    x = torch.from_numpy(X)
    ref, n_ref = jax_seq2seq.predict_greedy(params, state, mcfg,
                                            jnp.asarray(X), STOP)
    got, n_got = seq2seq.predict_greedy(tp, ts, mcfg, x, STOP)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(n_got) == int(n_ref)
    ref = jax_beam.make_beam_decoder(mcfg, 2, 2, STOP)(params, state,
                                                       jnp.asarray(X))
    got = beam_ops.make_beam_decoder(mcfg, 2, 2, STOP)(tp, ts, x)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_beam_rejects_k_above_vocab():
    with pytest.raises(ValueError, match="exceeds the decoder vocabulary"):
        beam_ops.make_beam_decoder(_mcfg(), 2, V + 1, STOP)


def test_decode_weights_are_packed_once(model):
    """decode_weights adds the decode step's layout to the packed dict;
    decoding with it given (as the infer CLI and the dev decode pass it
    to every batch) equals decoding with it made per call."""
    _, _, X, tp, ts = model
    w = seq2seq.decode_weights(tp)
    step = fused_infer.pack_step_weights(seq2seq.pack_decoder_weights(tp))
    assert set(w["step"]) == set(step)
    for k, v in step.items():
        assert torch.equal(w["step"][k], v), k
    x = torch.from_numpy(X)
    got = seq2seq.predict_greedy(tp, ts, _mcfg(), x, STOP, w)
    ref = seq2seq.predict_greedy(tp, ts, _mcfg(), x, STOP)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    decode = beam_ops.make_beam_decoder(_mcfg(), 3, 3, STOP)
    got, ref = decode(tp, ts, x, w), decode(tp, ts, x)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_decode_weights_hold_the_encoder_pack(model):
    """decode_weights carries the encoder's stacked weights and, at a
    width K1 takes (32 units a direction here), its packed layout, so
    encode does not pack them again per batch; encoding with it given
    equals encoding without.  The tiny model's 8 units get no pack."""
    _, _, X, tp, ts = model
    assert seq2seq.decode_weights(tp)["enc"][3] is None
    mcfg = _mcfg(hidden_units=64)
    tp, ts = seq2seq.init_model(mcfg, seed=1)
    w = seq2seq.decode_weights(tp)
    stacked = fused_lstm.pack_encoder_weights(tp["enc"]["lstm"])
    assert len(w["enc"]) == 4
    for a, b in zip(w["enc"], stacked):
        assert torch.equal(a, b)
    assert torch.equal(w["enc"][3], fused_lstm.pack_encoder_step_weights(
        stacked[0], stacked[1]))
    x = torch.from_numpy(X)
    enc_in = seq2seq.encoder_inputs(tp, ts, mcfg, x, enc_w=w["enc"])
    assert len(enc_in) == 5 and enc_in[4] is w["enc"][3]
    got = seq2seq.encode(tp, ts, mcfg, x, w)
    ref = seq2seq.encode(tp, ts, mcfg, x)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_kernel_wrappers_refuse_weights_without_step_layout(model):
    """The kernels take only decode_weights' dict: the step layout is not
    rebuilt per call."""
    _, _, _, tp, _ = model
    with pytest.raises(ValueError, match="decode_weights"):
        fused_infer.step_weights(seq2seq.pack_decoder_weights(tp),
                                 8, 2, 8, 8, V)
