#!/usr/bin/env python3
"""Smoke test of ast_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing a line:
1. device: the card's name and power limit (nvidia-smi); TF32 off, so
   the plain PyTorch versions run in full float32;
2. build: the hand-written CUDA kernels, compiled from the sources in
   this checkout;
3. each kernel against its plain PyTorch version on the card, at the
   full width of experiments/es_en_20h (B=32, 640 frames, stop 175,
   float32, seeded random weights): K1 outputs within 1e-4.  K5 and K6
   are compared twice: free-running (rows or utterances whose tokens
   agree with the plain decode must agree exactly, scores within 1e-3),
   and with the plain decoder step run along the kernel's own tokens, so
   every step of every row is checked even after a near-tie has sent the
   two apart: each K5 token within 1e-4 of the step's largest logit and
   PAD once every row has ended; each K6 token within 1e-4 of its
   slot's top K, the chosen scores within 1e-3 of the best N candidates
   (beam scores are sums of ~1e3 in magnitude: an f32 ulp is 6e-5), the
   beam's rules for frozen slots, distinct candidates and the ended
   search, and final scores within 1e-3.  Both run again with an EOS
   logit bias picked so that rows end at staggered steps before the
   stop limit, which drives the kernels' early exit;
4. the serving path through its entry point, ast_tpu_torch.cli.infer,
   on a synthetic es_en_20h experiment (seeded checkpoint, 1098-entry
   BPE vocab, 64 feature files of mixed lengths): after a warm-up call,
   greedy, then beam 5,5, each timed over the whole CLI call (checkpoint
   and file loading included); one output line per input, and every
   kernel's count above 0.

Then a JSON line with each kernel's count, error and times, and last
{"ok": true, "device": {...}}.  A kernel's count ("launches") is the
number of calls of its wrapper during the greedy and beam passes of
phase 4 (not the warm-up): each call runs the whole kernel -- every
step and layer, many CUDA launches.  "max_abs_err" is K1's largest
state difference, K5's largest shortfall of a chosen token's logit
below the plain step's best, and K6's largest score difference.  Any
failure raises (exit code 1, no result line); with no CUDA device it
exits 2.  Of ast_tpu, the port loads only its JAX-free config and
symbols modules; the script checks that JAX was not imported.
"""

import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
B, FRAMES, STOP = 32, 640, 175
N_BEAM, K_BEAM = 5, 5
N_UTTS = 64
VOCAB = 1098
TOK_TOL, ENC_TOL, SCORE_TOL = 1e-4, 1e-4, 1e-3


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def make_experiment(root, seed=0):
    """Synthetic es_en_20h experiment: model_cfg.json from the repo, a
    generated BPE vocab, a seeded checkpoint and feature files."""
    from ast_tpu_torch import SYMBOLS, Config
    from ast_tpu_torch.checkpoint import save_checkpoint, unflatten
    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.params import to_flat

    exp = os.path.join(root, "exp")
    feats = os.path.join(root, "feats")
    os.makedirs(exp)
    os.makedirs(feats)
    with open(os.path.join(REPO, "experiments", "es_en_20h",
                           "model_cfg.json")) as f:
        model_cfg = json.load(f)
    with open(os.path.join(exp, "model_cfg.json"), "w") as f:
        json.dump(model_cfg, f)
    words = [(f"w{i}@@" if i % 3 == 0 else f"w{i}").encode()
             for i in range(VOCAB - SYMBOLS.N_SPECIAL)]
    w2i = {w: i for i, w in enumerate(SYMBOLS.START_VOCAB + words)}
    vocab = {"bpe_w": {"w2i": w2i, "i2w": {i: w for w, i in w2i.items()},
                       "freq": {w: 1 for w in words}}}
    vocab_path = os.path.join(root, "fisher.vocab")
    with open(vocab_path, "wb") as f:
        pickle.dump(vocab, f)
    train_cfg = {"seed": "chip-smoke", "batch_size": B,
                 "data": {"enc_key": "sp", "dec_key": "bpe_w",
                          "vocab_path": vocab_path, "max_pred": STOP,
                          "buckets_num": 20, "buckets_width": 80}}
    with open(os.path.join(exp, "train_cfg.json"), "w") as f:
        json.dump(train_cfg, f)
    cfg = Config(exp)
    params, state = seq2seq.init_model(cfg.model, seed=seed)
    tree = unflatten(to_flat(params, state))
    save_checkpoint(os.path.join(exp, "seq2seq_1.model.npz"),
                    tree["params"], tree["state"])
    rng = np.random.default_rng(seed + 1)
    paths = []
    for i in range(N_UTTS):
        T = int(rng.integers(100, 1200))
        path = os.path.join(feats, f"utt{i:03d}.npy")
        np.save(path, rng.standard_normal((T, 13)).astype(np.float32))
        paths.append(path)
    return exp, cfg, paths


def eos_bias(enc, h0, c0, w):
    """An EOS logit bias under which the rows' greedy decodes end at
    staggered steps, all within 3/4 of STOP.  A row's decode is unchanged
    up to the first step where its EOS logit comes within the bias of the
    largest, so one unbiased plain decode gives every row's finishing step
    under any bias; of the biases 1e-3 above a gap on that path, the one
    with the most distinct finishing steps is taken (None if none ends
    every row in time)."""
    import torch

    from ast_tpu_torch import SYMBOLS
    from ast_tpu_torch.ops import fused_infer

    nb = enc.shape[0]
    word = torch.full((nb,), SYMBOLS.GO_ID, device=enc.device)
    h, c, ht = h0, c0, enc.new_zeros((nb, w["ctx_w"].shape[1]))
    gaps = []
    for _ in range(STOP):
        logits, h, c, ht = fused_infer.decode_step_reference(
            w, enc, h, c, ht, word)
        word = logits.argmax(dim=-1)
        gaps.append(logits.amax(dim=-1) - logits[:, SYMBOLS.EOS_ID])
    least = torch.stack(gaps, 1).cummin(dim=1).values.cpu().numpy()
    last = STOP * 3 // 4
    best, best_n = None, 1
    for beta in np.unique(least[:, :last]) + 1e-3:
        ended = least[:, :last] < beta
        n = len(np.unique(ended.argmax(axis=1)))
        if ended[:, -1].all() and n > best_n:
            best, best_n = float(beta), n
    return best


def beam_ends(val):
    """(steps run, steps where some utterance has ended and another has
    not) of a beam search's valid stream (stop, B, N)."""
    live = val != 0
    return (int(live.any(dim=(1, 2)).sum()),
            int(((~live).all(dim=2).any(dim=1) & live.any(dim=(1, 2))).sum()))


def with_eos_bias(w, beta):
    """The decoder weights with ``beta`` added to the EOS logit."""
    from ast_tpu_torch import SYMBOLS

    w = dict(w)
    w["out_b"] = w["out_b"].clone()
    w["out_b"][SYMBOLS.EOS_ID] += beta
    return w


def check_greedy(enc, h0, c0, w):
    """K5 against its plain version, both free-running and stepped along
    the kernel's own tokens: every kernel token within TOK_TOL of the
    plain step's largest logit, and PAD from the step after which every
    row has emitted EOS.  Returns (preds, numbers)."""
    from ast_tpu_torch import SYMBOLS
    from ast_tpu_torch.ops import fused_infer

    tok = fused_infer.greedy_decode_fused(enc, h0, c0, w, STOP)
    ref = fused_infer.greedy_reference(enc, h0, c0, w, STOP)
    short, n_run = fused_infer.greedy_follow(enc, h0, c0, w, tok)
    short = float(short.max())
    assert short <= TOK_TOL, (
        f"K5 chose a token whose logit is {short} below the plain step's "
        f"largest")
    assert (tok[:, n_run:] == SYMBOLS.PAD_ID).all(), (
        f"K5 wrote other than PAD after step {n_run}, where every row has "
        f"finished")
    return tok, dict(shortfall=short, steps=n_run,
                     rows_equal=int((tok == ref).all(dim=1).sum()))


def check_beam(enc, h0, c0, w):
    """K6 against its plain version, free-running (utterances whose
    streams are equal must give equal hypotheses, lengths and scores) and
    stepped along the kernel's own streams, where every step of every
    utterance is held to the beam's rules: chosen tokens within TOK_TOL of
    their slot's top K, the chosen scores within SCORE_TOL of the best N
    candidates, frozen slots continued by EOS with valid 0, no candidate
    twice, and EOS / identity parents / valid 0 once every slot has
    finished; final scores within SCORE_TOL.  Returns (valid stream,
    numbers)."""
    from ast_tpu_torch.ops import fused_infer

    k_tok, k_par, k_val, k_scores = fused_infer.beam_search_streams(
        enc, h0, c0, w, N_BEAM, K_BEAM, STOP)
    f_scores, topk_short, sel_err, bad = fused_infer.beam_follow(
        enc, h0, c0, w, N_BEAM, K_BEAM, k_tok, k_par, k_val)
    assert not bad.any(), (
        f"K6 streams break the beam's rules at (step, utterance) "
        f"{bad.nonzero().tolist()[:8]}")
    topk_short, sel_err = float(topk_short.max()), float(sel_err.max())
    assert topk_short <= TOK_TOL, (
        f"K6 chose a token {topk_short} below its slot's top K")
    assert sel_err <= SCORE_TOL, (
        f"K6's selection is {sel_err} off the best N candidates")
    live = f_scores > fused_infer.NEG_INF / 2
    s_err = float((k_scores - f_scores).abs()[live].max())
    assert s_err <= SCORE_TOL, f"K6 scores disagree: {s_err}"

    r_hyps, r_scores, r_lens, r_tok, r_par, r_val = \
        fused_infer.beam_reference(enc, h0, c0, w, N_BEAM, K_BEAM, STOP,
                                   trace=True)
    pair_eq = ((k_tok == r_tok) & (k_par == r_par)
               & (k_val == r_val)).all(dim=2)          # (step, utterance)
    same = pair_eq.all(dim=0)
    k_hyps, k_lens = fused_infer.backtrack(k_tok, k_par, k_val)
    assert (k_lens[same] == r_lens[same]).all(), "K6 lengths disagree"
    assert (k_hyps[same] == r_hyps[same]).all(), "K6 hypotheses disagree"
    free_err = float((k_scores - r_scores).abs()[same].max())
    assert free_err <= SCORE_TOL, f"K6 scores disagree: {free_err}"
    return k_val, dict(
        score_err=max(s_err, free_err), topk_short=topk_short,
        sel_err=sel_err, utts_equal=int(same.sum()),
        pairs_equal=int(pair_eq.sum()), pairs=pair_eq.numel(),
        steps=beam_ends(k_val)[0])


def check_kernels(cfg, device):
    """Phase 3: each kernel vs its plain version at es_en_20h width, and
    K5 / K6 again with an EOS bias, so that rows finish at staggered
    steps and the early exit (post-EOS tokens, PAD tail; frozen slots,
    EOS placeholders, identity parents, valid 0) runs on the card."""
    import torch

    from ast_tpu_torch import SYMBOLS
    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_infer, fused_lstm

    mcfg = cfg.model
    params, state = seq2seq.init_model(mcfg, seed=0, device=device)
    X = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, FRAMES, 13)).astype(np.float32)).to(device)
    results = {}

    enc_in = seq2seq.encoder_inputs(params, state, mcfg, X)
    got = fused_lstm.fused_stacked_lstm(*enc_in)
    ref = fused_lstm.stacked_lstm_reference(*enc_in)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    print(f"K1 encoder: x0_proj {tuple(enc_in[0].shape)}, max abs err "
          f"{err:.3e} (tol {ENC_TOL})", flush=True)
    assert err <= ENC_TOL, f"K1 disagrees with its plain version: {err}"
    results["k1"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: fused_lstm.fused_stacked_lstm(*enc_in), 5),
        plain_ms=cuda_ms(lambda: fused_lstm.stacked_lstm_reference(*enc_in),
                         2))

    enc, h0, c0 = seq2seq.encoder_outputs(*ref)
    w = seq2seq.pack_decoder_weights(params)
    beta = eos_bias(enc, h0, c0, w)
    assert beta is not None, "no EOS bias staggers the greedy decode"
    w_eos = with_eos_bias(w, beta)

    _, g = check_greedy(enc, h0, c0, w)
    tok, g_eos = check_greedy(enc, h0, c0, w_eos)
    is_eos = tok == SYMBOLS.EOS_ID
    first_eos = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1),
                            STOP)
    n_finish = len(set(first_eos.tolist()))
    assert g_eos["steps"] < STOP and n_finish > 1, (
        f"the EOS-biased greedy pass ended at step {g_eos['steps']} with "
        f"{n_finish} distinct finishing steps: no staggered early exit")
    for name, r in (("K5 greedy", g), ("K5 greedy, EOS bias", g_eos)):
        print(f"{name}: {B} rows, {r['steps']} of {STOP} steps run, "
              f"{r['rows_equal']} rows equal to the free-running plain "
              f"decode; on the kernel's path every token within "
              f"{r['shortfall']:.3e} of the plain step's best logit (tol "
              f"{TOK_TOL})", flush=True)
    print(f"  EOS bias {beta:.4f}: rows finish at {n_finish} distinct "
          f"steps from {int(first_eos.min())} to {int(first_eos.max())}, "
          f"PAD after step {g_eos['steps']}", flush=True)
    results["k5"] = dict(
        max_abs_err=max(g["shortfall"], g_eos["shortfall"]),
        rows_equal=g["rows_equal"], rows_equal_eos_bias=g_eos["rows_equal"],
        ms=cuda_ms(lambda: fused_infer.greedy_decode_fused(
            enc, h0, c0, w, STOP), 3),
        plain_ms=cuda_ms(lambda: fused_infer.greedy_reference(
            enc, h0, c0, w, STOP), 2))

    _, bm = check_beam(enc, h0, c0, w)
    # the beam ends early only once every slot of every utterance is
    # frozen: the first of these biases under which the plain search does
    for scale in (1, 1.5, 2, 3, 4, 6, 8):
        w_eos = with_eos_bias(w, beta * scale)
        val = fused_infer.beam_reference(enc, h0, c0, w_eos, N_BEAM, K_BEAM,
                                         STOP, trace=True)[5]
        steps, mixed = beam_ends(val)
        if steps < STOP and mixed > 0:
            break
    val, bm_eos = check_beam(enc, h0, c0, w_eos)
    steps, mixed = beam_ends(val)
    assert steps < STOP and mixed > 0, (
        f"the EOS-biased beam pass ran {steps} steps with {mixed} steps "
        f"holding an utterance already ended: no staggered early exit")
    for name, r in (("K6 beam", bm), ("K6 beam, EOS bias", bm_eos)):
        print(f"{name} {N_BEAM},{K_BEAM}: {B} utterances, {r['steps']} of "
              f"{STOP} steps run; {r['utts_equal']} utterances and "
              f"{r['pairs_equal']} of {r['pairs']} (step, utterance) pairs "
              f"equal to the free-running plain search; on the kernel's "
              f"path every step of every utterance checked: top-K "
              f"shortfall {r['topk_short']:.3e} (tol {TOK_TOL}), selection "
              f"{r['sel_err']:.3e} and score {r['score_err']:.3e} max abs "
              f"err (tol {SCORE_TOL})", flush=True)
    print(f"  EOS bias {beta * scale:.4f}: {mixed} steps hold an utterance "
          f"already ended, valid 0 for all after step {steps}", flush=True)
    results["k6"] = dict(
        max_abs_err=max(bm["score_err"], bm_eos["score_err"]),
        utts_equal=bm["utts_equal"], utts_equal_eos_bias=bm_eos["utts_equal"],
        ms=cuda_ms(lambda: fused_infer.beam_decode_fused(
            enc, h0, c0, w, N_BEAM, K_BEAM, STOP), 3),
        plain_ms=cuda_ms(lambda: fused_infer.beam_reference(
            enc, h0, c0, w, N_BEAM, K_BEAM, STOP), 1))
    return results


def run_slice(exp, paths, out_dir):
    """Phase 4: greedy then beam through the CLI, with launch counts."""
    import torch

    from ast_tpu_torch.cli import infer
    from ast_tpu_torch.ops import fused_infer, fused_lstm

    counters = {"k1": fused_lstm.fused_stacked_lstm,
                "k5": fused_infer.greedy_decode_fused,
                "k6": fused_infer.beam_search_streams}
    # first call: CUDA context, library and cuBLAS start-up stay out of
    # the timed passes and out of the counts
    infer.main(["-m", exp, "--device", "cuda", "-o",
                os.path.join(out_dir, "warmup.txt")] + paths[:2])
    for fn in counters.values():
        fn.launches = 0
    rates = {}
    for name, extra in (("greedy", []),
                        ("beam", ["--beam", f"{N_BEAM},{K_BEAM}"])):
        out = os.path.join(out_dir, f"{name}.txt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hyps = infer.main(["-m", exp, "--device", "cuda", "-o", out]
                          + extra + paths)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        with open(out) as f:
            lines = f.read().splitlines()
        assert len(hyps) == len(paths) == len(lines), (name, len(lines))
        assert [ln.split("\t")[0] for ln in lines] == [
            os.path.splitext(os.path.basename(p))[0] for p in paths]
        assert any(hyps.values()), f"{name}: every hypothesis is empty"
        rates[name] = len(paths) / dt
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, n in launches.items():
        assert n > 0, f"the main path never launched {k}"
    return rates, launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from ast_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    build.library()
    built = build.last_build
    print(f"build: {time.perf_counter() - t0:.1f} s"
          + (f" (nvcc {built['seconds']:.1f} s, {built['path']})"
             if built else " (library already built)"), flush=True)
    if built:
        with open(built["log"]) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print("  " + line.strip())

    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as root:
        exp, cfg, paths = make_experiment(root)
        with torch.inference_mode():
            results = check_kernels(cfg, device)
        rates, launches = run_slice(exp, paths, root)
    print(f"slice ({N_UTTS} utts, {smi}): greedy {rates['greedy']:.1f} "
          f"utts/s, beam {N_BEAM},{K_BEAM} {rates['beam']:.1f} utts/s",
          flush=True)

    meta = {
        "k1": ("K1 fused biLSTM encoder", "k1_encoder.cu",
               "ast_tpu/ops/fused_lstm.py:275"),
        "k5": ("K5 fused greedy decode", "k5_greedy.cu",
               "ast_tpu/ops/fused_infer.py:251"),
        "k6": ("K6 fused beam decode", "k6_beam.cu",
               "ast_tpu/ops/fused_infer.py:537"),
    }
    kernels = []
    for key, (name, src, replaces) in meta.items():
        r = results[key]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"ast_tpu_torch/kernels/csrc/{src}", replaces=replaces,
            launches=launches[key], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"]))
    assert not [m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib")], "JAX was imported"
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
