#!/usr/bin/env python
"""Does the port learn?  Train ast_tpu_torch on a synthetic corpus that
can be transcribed, then beam-decode its dev split.

The corpus of ``scripts/synthetic_train.py`` (its own copy here, NumPy
only): each of 30 words has a fixed 8-frame spectral signature, an
utterance's features are its words' signatures in a row plus noise, so a
correct stack -- loader, model, trainer, greedy decode, detokenisation,
BLEU -- drives dev BLEU towards 100 within a few epochs.  The model is
that script's (2 + 2 layers, 256 hidden units, E 128, A 256: all
multiples of 32, which the CUDA kernels require) in float32.

    python scripts/torch_synthetic_train.py [--epochs 8] [--device cuda]
        [--root DIR] [--out results.json]

Trains ``--epochs`` epochs through ``ast_tpu_torch.cli.train``, then runs
``ast_tpu_torch.cli.beam -n 5 -k 5 -w 0.6`` on the dev split, prints the
``dev.log`` BLEU curve, the beam BLEU, each epoch's train utts/s and
seconds, and fails unless the last epoch's dev BLEU passes 50.
"""

import argparse
import contextlib
import io
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N_TRAIN, N_DEV = 600, 60


def build_corpus(root, n_train=N_TRAIN, n_dev=N_DEV, vocab_words=30, seed=0):
    """Write the corpus and the experiment directory; returns the
    latter."""
    rng = np.random.RandomState(seed)
    exp = os.path.join(root, "exp")
    data = os.path.join(root, "data")
    speech = os.path.join(root, "speech")
    refs = os.path.join(data, "refs")
    os.makedirs(exp, exist_ok=True)
    os.makedirs(data, exist_ok=True)

    words = [f"w{i}".encode() for i in range(vocab_words)]
    specials = [b"_PAD", b"_GO", b"_EOS", b"_UNK"]
    w2i = {w: i for i, w in enumerate(specials + words)}
    vocab = {"en_w": {"w2i": w2i,
                      "i2w": {i: w for w, i in w2i.items()},
                      "freq": {}}}

    # fixed spectral signature per word: 8 frames x 13 dims
    signatures = rng.randn(vocab_words, 8, 13).astype(np.float32) * 2.0

    sets = {"syn_train": n_train, "syn_dev": n_dev}
    map_dict, info = {}, {}
    for set_key, n in sets.items():
        map_dict[set_key] = {}
        info[set_key] = {}
        os.makedirs(os.path.join(speech, set_key), exist_ok=True)
        for i in range(n):
            utt = f"{set_key}_u{i:04d}"
            n_words = int(rng.randint(2, 9))
            idx = rng.randint(vocab_words, size=n_words)
            toks = [words[j] for j in idx]
            feats = np.concatenate([signatures[j] for j in idx], axis=0)
            feats = feats + 0.1 * rng.randn(*feats.shape).astype(np.float32)
            np.save(os.path.join(speech, set_key, f"{utt}.npy"), feats)
            map_dict[set_key][utt] = {"en_w": toks}
            info[set_key][utt] = {"sp": len(feats), "en_w": n_words}

    for name, obj in [("syn.vocab", vocab), ("syn.map", map_dict),
                      ("syn.info", info)]:
        with open(os.path.join(data, name), "wb") as f:
            pickle.dump(obj, f)

    dev_refs = os.path.join(refs, "syn_dev")
    os.makedirs(dev_refs, exist_ok=True)
    dev_utts = sorted(map_dict["syn_dev"])
    with open(os.path.join(dev_refs, "eval.ids"), "w") as f:
        f.write("\n".join(dev_utts) + "\n")
    with open(os.path.join(dev_refs, "ref.en0"), "w") as f:
        for u in dev_utts:
            f.write(" ".join(w.decode()
                             for w in map_dict["syn_dev"][u]["en_w"]) + "\n")

    model_cfg = {
        "dropout": {"embed": 0.1, "rnn": 0.1, "out": 0},
        "rnn_config": {
            "bi_rnn": True, "enc_layers": 2, "dec_layers": 2,
            "hidden_units": 256, "embedding_units": 128, "attn_units": 256,
            "n_attn": 1, "feed_attn": True, "ln": False,
        },
        "cnn_config": {
            "bn": True,
            "cnn_layers": [
                {"in_channels": None, "out_channels": 64, "ksize": [5, 13],
                 "stride": [2, 13], "pad": [2, 0]},
                {"in_channels": None, "out_channels": 256, "ksize": [5, 1],
                 "stride": [2, 1], "pad": [2, 0]},
            ],
        },
    }
    train_cfg = {
        "seed": "syn-seed",
        "iters_save": 50,
        "train_set": "syn_train",
        "dev_set": "syn_dev",
        "extras": {"random_out": 0, "speech_noise": 0.05,
                   "teach_ratio": 0.9, "compute_dtype": "float32"},
        "data": {
            "enc_key": "sp", "dec_key": "en_w",
            "speech_path": speech,
            "map_path": os.path.join(data, "syn.map"),
            "vocab_path": os.path.join(data, "syn.vocab"),
            "info_path": os.path.join(data, "syn.info"),
            "max_pred": 16,
            "refs_path": refs,
            "n_evals": 1,
            "buckets_num": 4, "buckets_width": 24,
            "train_scale": 1, "zero_input": 0.05,
            "target_pad_multiple": 8,
        },
        "optimizer": {"type": 0, "lr": 0.001, "l2": 0.0001,
                      "grad_clip": 2, "grad_noise_eta": 0, "freeze": []},
        "batch_size": 32,
    }
    with open(os.path.join(exp, "model_cfg.json"), "w") as f:
        json.dump(model_cfg, f)
    with open(os.path.join(exp, "train_cfg.json"), "w") as f:
        json.dump(train_cfg, f)
    return exp


def card(device):
    """The device's name and, on a card, its power limit."""
    import torch
    if not device.startswith("cuda"):
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else torch.cuda.get_device_name(0)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=8)
    parser.add_argument("--root", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None,
                        help="also write the numbers to this JSON file")
    args = parser.parse_args(argv)

    from ast_tpu_torch.cli import beam as beam_cli
    from ast_tpu_torch.cli import train as train_cli

    with contextlib.ExitStack() as stack:
        root = args.root or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="syn_ast_torch_"))
        exp = build_corpus(root)
        print(f"synthetic corpus at {root}", flush=True)
        report = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(report):
            train_cli.main(["-m", exp, "-e", str(args.epochs), "--device",
                            args.device])
        train_s = time.perf_counter() - t0
        rates = [float(v) for v in re.findall(
            r"train throughput = ([0-9.]+) utts/sec", report.getvalue())]
        with open(os.path.join(exp, "dev.log")) as f:
            bleus = [float(line.split(", ")[1]) for line in f]
        with open(os.path.join(exp, "train.log")) as f:
            losses = [float(line.split(", ")[1]) for line in f]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(report):
            beam_bleu = beam_cli.main(
                ["-m", exp, "-n", "5", "-k", "5", "-w", "0.6", "-s",
                 "syn_dev", "--device", args.device])
        beam_s = time.perf_counter() - t0

    result = {
        "device": card(args.device), "epochs": args.epochs,
        "dev_bleu": bleus, "train_loss": losses, "beam_bleu": beam_bleu,
        "train_utts_per_s": rates,
        "epoch_train_s": [N_TRAIN / r for r in rates],
        "train_cli_s": train_s, "beam_cli_s": beam_s,
        "beam_utts_per_s": N_DEV / beam_s,
    }
    print(f"device: {result['device']}")
    print("dev BLEU per epoch:", bleus)
    print("train loss per epoch:", losses)
    print(f"beam 5,5 W 0.6 dev BLEU: {beam_bleu:.2f} ({beam_s:.1f} s for "
          f"the CLI call, start-up included)")
    print("train utts/s per epoch:", rates)
    print("train seconds per epoch:",
          [round(s, 2) for s in result["epoch_train_s"]])
    print(f"train CLI: {train_s:.1f} s for {args.epochs} epochs, dev decodes "
          f"and start-up included", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if not bleus or bleus[-1] <= 50:
        raise SystemExit(f"the model failed to learn: dev BLEU {bleus}")
    print("LEARNABILITY CHECK PASSED", flush=True)
    return result


if __name__ == "__main__":
    main()
