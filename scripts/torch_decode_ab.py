#!/usr/bin/env python3
"""K5, K6, K3 and K4 at bf16 in two checkouts of the port, in turns, on
one NVIDIA GPU: a quick A/B for a change to the step kernels' products.

    python3 scripts/torch_decode_ab.py OTHER_DIR [THIS_DIR]

Runs ``--tree DIR`` as a fresh process for this checkout (THIS_DIR,
default the one holding this script), OTHER_DIR, OTHER_DIR again and this
checkout again.  The first run first holds this checkout's bf16 kernels
to their plain versions (``chip_smoke.check_bf16_kernels``: K1 eval, K5
and K6 at B=32 and at every ``BF16_PARTIAL`` batch;
``chip_smoke.check_bf16_decoder_train``: K3 and K4 at B=32 along K3's
ids and one step at a time; 20 repeats bit-equal).  Every run then
times, at ``chip_smoke.py``'s shapes (es_en_20h width, B=32, 640 frames
-> T'=160, stop 175, beam 5,5, U=64 targets at teacher ratio 0.8,
dropout 0.3, seeded weights), one K5, K6, K3 and K4 call at bf16 with
CUDA events (mean of five after a warm-up) and splits one more of each
under torch.profiler (``chip_smoke.decode_split`` by kernel,
``chip_smoke.train_split`` by launch kind).  Only the port's public
entry points are called, so any two checkouts compare; each builds its
kernels into its own build/.  Needs a CUDA device; exits 2 without one.
"""

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402


def run(tree, check):
    """{"k5", "k6", "k3", "k4": ms, "<key>_<part>": ms} for ``tree``."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_decoder as fd
    from ast_tpu_torch.ops import fused_infer as fi
    from ast_tpu_torch.ops import fused_lstm as fl

    assert fi.__file__.startswith(tree), fi.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf = torch.device("cuda"), torch.bfloat16
    out = {}
    with tempfile.TemporaryDirectory() as root, torch.inference_mode():
        _, cfg, _ = cs.make_experiment(root)
        if check:
            cs.check_bf16_kernels(cfg, dev)
        mcfg = cfg.model
        params, state = seq2seq.init_model(mcfg, seed=0, device=dev)
        X = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (cs.B, cs.FRAMES, 13)).astype(np.float32)).to(dev)
        w = seq2seq.decode_weights(params, bf)
        enc_in = seq2seq.encoder_inputs(params, state, mcfg, X,
                                        enc_w=w["enc"], compute_dtype=bf)
        enc32, h0, c0 = seq2seq.encoder_outputs(
            *fl.stacked_lstm_reference(*enc_in[:4]))
        enc = enc32.to(bf)
        calls = {
            "k5": lambda: fi.greedy_decode_fused(enc, h0, c0, w, cs.STOP),
            "k6": lambda: fi.beam_decode_fused(enc, h0, c0, w, cs.N_BEAM,
                                               cs.K_BEAM, cs.STOP)}
        for key, fn in calls.items():
            out[key] = cs.cuda_ms(fn, 5)
            out.update({f"{key}_{p}": ms for p, ms in
                        cs.decode_split(fn, h0.shape[0]).items()})
        rng = np.random.default_rng(3)
        y = rng.integers(4, cs.VOCAB, (cs.U_TRAIN - 1, cs.B)).astype(np.int32)
        coins = (rng.random(cs.U_TRAIN - 1) < cs.TEACH).astype(np.int32)
        coins[0] = 1
        y_in, coins = (torch.from_numpy(a).to(dev) for a in (y, coins))
        w_train = seq2seq.pack_decoder_weights(params, bf)
        d_ht = torch.from_numpy(rng.standard_normal(
            (cs.U_TRAIN - 1, cs.B, w_train["ctx_w"].shape[1])).astype(
            np.float32) * 0.1).to(dev)
        dec = (enc, h0, c0, w_train, y_in, coins, cs.DEC_SEED, cs.DROP,
               cs.DROP)
        if check:
            cs.check_bf16_decoder_train(*dec[:7], d_ht, f"{cs.B} rows")
        ht, res = fd.decoder_forward(*dec)
        db = (res, ht, enc, c0, w_train, d_ht, cs.DEC_SEED, cs.DROP,
              cs.DROP)
        calls = {"k3": lambda: fd.decoder_forward(*dec),
                 "k4": lambda: fd.decoder_backward(*db)}
        for key, fn in calls.items():
            out[key] = cs.cuda_ms(fn, 5)
            out.update({f"{key}_{p}": ms
                        for p, ms in cs.train_split(fn).items()})
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_ab: no CUDA device available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--tree"]:
        print(json.dumps(run(os.path.abspath(sys.argv[2]),
                             sys.argv[3] == "check")))
        return 0
    this = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else HERE)
    other = os.path.abspath(sys.argv[1])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for i, (name, tree) in enumerate((("this", this), ("other", other),
                                      ("other", other), ("this", this))):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", tree,
             "check" if i == 0 else "time"], capture_output=True, text=True)
        if i == 0 or res.returncode:
            print(res.stdout, res.stderr[-4000:], flush=True)
        if res.returncode:
            return res.returncode
        out = json.loads(res.stdout.strip().splitlines()[-1])
        print(name, json.dumps({k: round(v, 3) for k, v in out.items()}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
