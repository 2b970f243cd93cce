#!/usr/bin/env python3
"""Time the port's kernels, one train step and its decode slice in two
checkouts on one NVIDIA GPU, in turns.

    python3 ab_kernels.py PARENT_DIR [CHANGE_DIR]

Runs ``python3 ab_kernels.py --tree DIR`` as a fresh process for the
parent, the change, the change again and the parent again (CHANGE_DIR
defaults to this script's checkout), and prints each number per run and
the change's mean against the parent's.  One run, in the checkout it is
given, at chip_smoke.py's shapes and with its timer (this script's own
chip_smoke.py, so both checkouts run the same shapes): K1 (eval and
train mode), K2, K3, K4, K5 and K6 (es_en_20h width, B=32, 640 frames ->
T'=160, U=64 targets, stop 175, beam 5,5, seeded random weights and
inputs; dropout 0.3), and K1 train, K2, K3 and K4 again on the first 8
and 16 rows of that batch (the sizes of the trainer's shrunk tail
batches), each timed
with CUDA events, mean of several calls
after a warm-up, float32 with TF32 off; every kernel's bf16 mode
(compute_dtype bfloat16: K1 eval and train, K2, K3, K4, K5, K6) on the
same inputs, and one K5 and one K6 call at bf16 split by kernel under
torch.profiler (chip_smoke.decode_split: cells, q, ctx, logits,
attention, selection, the rest, launch gaps), one K3 and one K4 call at
bf16 by launch kind (chip_smoke.train_split: train cells, linears,
d_top, layer backward, attention, select / head, the rest, launch gaps);
then one train step, the
trainer's ``NN.train_step`` on chip_smoke's phase 5 batch (B=32, 640
frames, U=64) of its synthetic es_en_20h training experiment, as the
host's clock sees it around 10 steps that end in a synchronize, after two
warm-up steps, and the same at compute_dtype bfloat16 (a second NN on
that experiment with extras.compute_dtype set), each NN's steps also as
the device sees them (chip_smoke.step_profile: 10 more steps under
torch.profiler, the device's busy ms a step and the encoder kernels'
share of it, which a busy host does not stretch); then that experiment's
two first epochs through
``NN.train_epoch`` (96 utterances, the trainer's own utts/s) and its dev
split through ``NN.predict`` (32 utterances, the median of three passes
after a warm-up); then chip_smoke's phase 4, the
infer CLI on 64 files, greedy and beam 5,5, three times, in utts/s (the
median).  Only the port's public entry points are called, so any two
checkouts of the port compare.  Each checkout builds its kernels into
its own build/.  Needs a CUDA device; exits 2 without one.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile

import chip_smoke as cs

# the parts of chip_smoke.decode_split, as keys
SPLIT = ("cells", "q", "ctx", "logits", "attention", "selection", "other",
         "launch_gaps")
# and of chip_smoke.train_split
TRAIN_SPLIT = ("train_cells", "linears", "d_top", "layer_backward",
               "attention", "select_head", "other", "launch_gaps")
ORDER = ("k1", "k1t", "k2", "k3", "k4", "k1t_b8", "k2_b8", "k3_b8", "k4_b8",
         "k1t_b16", "k2_b16", "k3_b16", "k4_b16", "k5", "k6", "k1_bf16",
         "k1t_bf16", "k2_bf16", "k3_bf16", "k4_bf16", "k5_bf16", "k6_bf16",
         *(f"{k}_bf16_{p}" for k in ("k5", "k6") for p in SPLIT),
         *(f"{k}_bf16_{p}" for k in ("k3", "k4") for p in TRAIN_SPLIT),
         "train_step", "train_step_bf16", "train_step_busy",
         "train_step_bf16_busy", "train_step_encoder",
         "train_step_bf16_encoder", "epoch1_utts_s", "epoch2_utts_s",
         "predict_utts_s",
         "greedy_utts_s", "beam_utts_s")
SLICE_PASSES = 3
TRAIN_STEPS = 10


def time_bf16(params, state, mcfg, X, enc, h0, c0, y_in, coins):
    """The bf16 kernels (compute_dtype bfloat16) at the f32 kernels'
    shapes and inputs, one K5 and one K6 call at bf16 split by kernel
    (chip_smoke.decode_split) and one K3 and one K4 call by launch kind
    (chip_smoke.train_split): {key: ms}."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_decoder as fd
    from ast_tpu_torch.ops import fused_infer as fi
    from ast_tpu_torch.ops import fused_lstm as fl

    bf = torch.bfloat16
    out = {}
    w = seq2seq.decode_weights(params, bf)
    enc_in = seq2seq.encoder_inputs(params, state, mcfg, X, enc_w=w["enc"],
                                    compute_dtype=bf)
    out["k1_bf16"] = cs.cuda_ms(lambda: fl.fused_stacked_lstm(*enc_in), 20)
    x0, wxr, wh, b, _ = seq2seq.encoder_inputs(params, state, mcfg, X,
                                               train=True, compute_dtype=bf)
    tr = (x0, wxr.to(bf), wh.to(bf), b, 12345, cs.DROP)
    res = fl.fused_stacked_lstm_train(*tr)
    out["k1t_bf16"] = cs.cuda_ms(lambda: fl.fused_stacked_lstm_train(*tr),
                                 10)
    bwd = (res[3], res[4], tr[1], tr[2],
           *(torch.randn_like(t) for t in res[:3]), 12345, cs.DROP)
    out["k2_bf16"] = cs.cuda_ms(lambda: fl.encoder_backward(*bwd), 10)
    enc16 = enc.to(bf).contiguous()
    w_train = seq2seq.pack_decoder_weights(params, bf)
    dec = (enc16, h0, c0, w_train, y_in, coins, 777, cs.DROP, cs.DROP)
    ht, r = fd.decoder_forward(*dec)
    out["k3_bf16"] = cs.cuda_ms(lambda: fd.decoder_forward(*dec), 10)
    db = (r, ht, enc16, c0, w_train, torch.randn_like(ht), 777, cs.DROP,
          cs.DROP)
    out["k4_bf16"] = cs.cuda_ms(lambda: fd.decoder_backward(*db), 10)
    for key, fn in (("k3_bf16", lambda: fd.decoder_forward(*dec)),
                    ("k4_bf16", lambda: fd.decoder_backward(*db))):
        out.update({f"{key}_{p.replace(' / ', '_').replace(' ', '_')}": ms
                    for p, ms in cs.train_split(fn).items()})
    calls = {
        "k5_bf16": lambda: fi.greedy_decode_fused(enc16, h0, c0, w, cs.STOP),
        "k6_bf16": lambda: fi.beam_decode_fused(
            enc16, h0, c0, w, cs.N_BEAM, cs.K_BEAM, cs.STOP)}
    for key, fn in calls.items():
        out[key] = cs.cuda_ms(fn, 5 if key == "k5_bf16" else 3)
        split = cs.decode_split(fn, h0.shape[0])
        out.update({f"{key}_{p.replace(' ', '_')}": ms
                    for p, ms in split.items()})
    return out


def time_tree(tree):
    """{kernel: ms, slice: utts/s} for the checkout at ``tree``."""
    sys.path.insert(0, tree)
    import time

    import numpy as np
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_decoder as fd
    from ast_tpu_torch.ops import fused_infer as fi
    from ast_tpu_torch.ops import fused_lstm as fl
    from ast_tpu_torch.train.trainer import NN

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}
    with tempfile.TemporaryDirectory() as root:
        exp, cfg, paths = cs.make_experiment(root)
        mcfg = cfg.model
        rng = np.random.default_rng(0)
        params, state = seq2seq.init_model(mcfg, seed=0, device=dev)
        X = torch.from_numpy(rng.standard_normal(
            (cs.B, cs.FRAMES, 13)).astype(np.float32)).to(dev)
        y = rng.integers(4, cs.VOCAB, (cs.U_TRAIN, cs.B)).astype(np.int32)
        y[0] = 1
        y_in = torch.from_numpy(y[:-1].copy()).to(dev)
        coins = torch.from_numpy(
            (rng.random(cs.U_TRAIN - 1) < 0.8).astype(np.int32)).to(dev)
        coins[0] = 1
        with torch.inference_mode():
            enc_in = seq2seq.encoder_inputs(params, state, mcfg, X)
            out["k1"] = cs.cuda_ms(lambda: fl.fused_stacked_lstm(*enc_in),
                                   20)
            tr = (*enc_in[:4], 12345, cs.DROP)
            res = fl.fused_stacked_lstm_train(*tr)
            out["k1t"] = cs.cuda_ms(lambda: fl.fused_stacked_lstm_train(*tr),
                                    10)
            d_out = [torch.randn_like(t) for t in res[:3]]
            bwd = (res[3], res[4], enc_in[1], enc_in[2], *d_out, 12345,
                   cs.DROP)
            out["k2"] = cs.cuda_ms(lambda: fl.encoder_backward(*bwd), 10)
            enc, h0, c0 = seq2seq.encoder_outputs(*res[:3])
            w = seq2seq.pack_decoder_weights(params)
            dec = (enc, h0, c0, w, y_in, coins, 777, cs.DROP, cs.DROP)
            ht, r = fd.decoder_forward(*dec)
            out["k3"] = cs.cuda_ms(lambda: fd.decoder_forward(*dec), 10)
            d_ht = torch.randn_like(ht)
            db = (r, ht, enc, c0, w, d_ht, 777, cs.DROP, cs.DROP)
            out["k4"] = cs.cuda_ms(lambda: fd.decoder_backward(*db), 10)
            for nb in (8, 16):
                tr_nb = (enc_in[0][:, :, :nb].contiguous(), *enc_in[1:4],
                         12345, cs.DROP)
                res_nb = fl.fused_stacked_lstm_train(*tr_nb)
                out[f"k1t_b{nb}"] = cs.cuda_ms(
                    lambda: fl.fused_stacked_lstm_train(*tr_nb), 10)
                bwd_nb = (res_nb[3], res_nb[4], enc_in[1], enc_in[2],
                          *(torch.randn_like(t) for t in res_nb[:3]), 12345,
                          cs.DROP)
                out[f"k2_b{nb}"] = cs.cuda_ms(
                    lambda: fl.encoder_backward(*bwd_nb), 10)
                dec_nb = (enc[:nb].contiguous(), h0[:, :nb].contiguous(),
                          c0[:, :nb].contiguous(), w,
                          y_in[:, :nb].contiguous(), coins, 777, cs.DROP,
                          cs.DROP)
                ht_nb, r_nb = fd.decoder_forward(*dec_nb)
                out[f"k3_b{nb}"] = cs.cuda_ms(
                    lambda: fd.decoder_forward(*dec_nb), 10)
                db_nb = (r_nb, ht_nb, dec_nb[0], dec_nb[2], w,
                         torch.randn_like(ht_nb), 777, cs.DROP, cs.DROP)
                out[f"k4_b{nb}"] = cs.cuda_ms(
                    lambda: fd.decoder_backward(*db_nb), 10)
            # a checkout without decode_weights packs inside the wrappers
            w_dec = getattr(seq2seq, "decode_weights",
                            seq2seq.pack_decoder_weights)(params)
            out["k5"] = cs.cuda_ms(lambda: fi.greedy_decode_fused(
                enc, h0, c0, w_dec, cs.STOP), 5)
            out["k6"] = cs.cuda_ms(lambda: fi.beam_decode_fused(
                enc, h0, c0, w_dec, cs.N_BEAM, cs.K_BEAM, cs.STOP), 3)
            out.update(time_bf16(params, state, mcfg, X, enc, h0, c0, y_in,
                                 coins))
        train_exp = cs.make_train_experiment(root)[0]
        nn = NN(train_exp, "cuda")
        Xb, yb = cs.train_batch(dev)
        batch = {"X": Xb.cpu().numpy(), "y": yb.cpu().numpy(),
                 "n_real": cs.B, "utts": [""] * cs.B}

        def step_ms(nn):
            for i in range(2):
                nn.train_step(batch, i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(TRAIN_STEPS):
                nn.train_step(batch, 2 + i)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS

        def step_busy(nn, key):
            """The device's busy ms a step and the encoder's kernels' part
            of it, under torch.profiler."""
            _, busy, groups = cs.step_profile(nn, batch, TRAIN_STEPS)
            out[f"{key}_busy"] = busy
            out[f"{key}_encoder"] = sum(ms for g, ms in groups
                                        if g.startswith("encoder"))

        out["train_step"] = step_ms(nn)
        step_busy(nn, "train_step")
        cfg_path = os.path.join(train_exp, "train_cfg.json")
        with open(cfg_path) as f:
            saved_cfg = f.read()
        cs.edit_train_cfg(train_exp, lambda c: c.setdefault(
            "extras", {}).update(compute_dtype="bfloat16"))
        nn16 = NN(train_exp, "cuda")
        out["train_step_bf16"] = step_ms(nn16)
        step_busy(nn16, "train_step_bf16")
        with open(cfg_path, "w") as f:
            f.write(saved_cfg)
        tcfg = nn.cfg.train
        for epoch in (1, 2):
            nn.timer.reset()
            nn.train_epoch(tcfg["train_set"], epoch=epoch)
            out[f"epoch{epoch}_utts_s"] = nn.timer.items_per_sec
        passes = []
        for _ in range(SLICE_PASSES + 1):       # the first warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_utts = len(nn.predict(tcfg["dev_set"]))
            passes.append(n_utts / (time.perf_counter() - t0))
        out["predict_utts_s"] = statistics.median(passes[1:])
        rates = [cs.run_slice(exp, paths, root)[0]
                 for _ in range(SLICE_PASSES)]
    for name in ("greedy", "beam"):
        out[f"{name}_utts_s"] = statistics.median(r[name] for r in rates)
    return out


def main():
    if sys.argv[1:2] == ["--tree"]:
        import torch

        if not torch.cuda.is_available():
            print("ab_kernels: no CUDA device available", file=sys.stderr)
            return 2
        print(json.dumps(time_tree(os.path.abspath(sys.argv[2]))))
        return 0
    parent = os.path.abspath(sys.argv[1])
    change = os.path.abspath(sys.argv[2] if len(sys.argv) > 2
                             else os.path.dirname(__file__))
    runs = []
    for name, tree in (("parent", parent), ("change", change),
                       ("change", change), ("parent", parent)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--tree", tree], capture_output=True,
                             text=True, cwd=tree)
        if res.returncode != 0:
            print(res.stdout, res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        runs.append((name, json.loads(res.stdout.strip().splitlines()[-1])))
        print(name, json.dumps({k: round(v, 3) for k, v in
                                runs[-1][1].items()}), flush=True)
    mean = {n: {k: sum(r[k] for m, r in runs if m == n) / 2 for k in ORDER}
            for n in ("parent", "change")}
    for k in ORDER:
        p, c = mean["parent"][k], mean["change"][k]
        unit = "utts/s" if k.endswith("utts_s") else "ms"
        print(f"{k}: parent {p:.3f} {unit}, change {c:.3f} {unit}"
              + (f", {(c / p - 1) * 100:+.1f} %" if p else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
