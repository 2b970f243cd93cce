#!/usr/bin/env python
"""Does ASR pretraining help low-resource speech translation in the port?

The port's counterpart of ``scripts/transfer_ab.py``: the reference's
claim (arXiv:1809.01431) through ``ast_tpu_torch``'s CLIs on that
script's synthetic corpus (its own NumPy copy here):

  1. ASR pretraining: 600 utterances whose targets are the source words
     (each of 30 words has a fixed 8-frame spectral signature; an
     utterance is 6-14 words' signatures in a row plus noise).
  2. Low-resource ST: 96 utterances over the same signatures whose
     targets are a permuted "translation" vocab, so the encoder's
     acoustics transfer and the decoder must be learned anew (96 is the
     size ``docs/PARITY.md`` calibrates: at 48 both arms memorise, by
     160 the scratch arm learns the acoustics itself).
  3. Arm A trains ST from scratch; arm B runs ``ast_tpu_torch.cli.
     copy_params --groups enc,attn`` from the ASR checkpoint (saved as
     epoch 0, which ``cli.train`` resumes) and trains as many epochs.
     Both arms have one config seed, so they see the same batches.

The model is ``transfer_ab.py``'s (2 + 2 layers, 256 hidden units, E 128,
A 256: multiples of 32, which the CUDA kernels need) in float32.

    python scripts/torch_transfer_ab.py [--asr-epochs 12] [--st-epochs 25]
        [--st-utts 96] [--device cuda] [--root DIR] [--out results.json]

Prints the ASR and both arms' dev BLEU by epoch, and exits non-zero
unless arm B's last dev BLEU is above arm A's; ``ast_tpu``'s own margin
(20 BLEU at 25 epochs) is reported, not required.
"""

import argparse
import contextlib
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

MARGIN = 20.0           # ast_tpu's margin at the 96-utterance default


def _write_exp(root, name, sets, map_dict, info, vocab, speech, refs,
               dev_set, seed):
    """One experiment directory and its data pickles."""
    exp = os.path.join(root, name)
    data = os.path.join(root, "data_" + name)
    os.makedirs(exp, exist_ok=True)
    os.makedirs(data, exist_ok=True)
    for fname, obj in [("syn.vocab", vocab), ("syn.map", map_dict),
                       ("syn.info", info)]:
        with open(os.path.join(data, fname), "wb") as f:
            pickle.dump(obj, f)
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
        "seed": seed,
        "iters_save": 50,
        "train_set": [k for k in sets if k.endswith("train")][0],
        "dev_set": dev_set,
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
        "batch_size": 16,
    }
    with open(os.path.join(exp, "model_cfg.json"), "w") as f:
        json.dump(model_cfg, f)
    with open(os.path.join(exp, "train_cfg.json"), "w") as f:
        json.dump(train_cfg, f)
    return exp


def build_tasks(root, n_asr=600, n_st=96, n_dev=50, vocab_words=30, seed=0):
    """Shared acoustic signatures; ASR transcribes, ST 'translates'.
    Returns (asr experiment, {"st_scratch": dir, "st_transfer": dir})."""
    rng = np.random.RandomState(seed)
    speech = os.path.join(root, "speech")
    refs = os.path.join(root, "refs")
    os.makedirs(speech, exist_ok=True)

    src_words = [f"w{i}".encode() for i in range(vocab_words)]
    tgt_words = [f"t{i}".encode() for i in range(vocab_words)]
    perm = rng.permutation(vocab_words)
    specials = [b"_PAD", b"_GO", b"_EOS", b"_UNK"]

    def make_vocab(words):
        w2i = {w: i for i, w in enumerate(specials + words)}
        return {"en_w": {"w2i": w2i,
                         "i2w": {i: w for w, i in w2i.items()},
                         "freq": {}}}

    # a fixed spectral signature per source word: 8 frames x 13 dims
    signatures = rng.randn(vocab_words, 8, 13).astype(np.float32) * 2.0

    def make_corpus(sets, translate):
        map_dict, info = {}, {}
        for set_key, n in sets.items():
            map_dict[set_key] = {}
            info[set_key] = {}
            os.makedirs(os.path.join(speech, set_key), exist_ok=True)
            for i in range(n):
                utt = f"{set_key}_u{i:04d}"
                n_words = int(rng.randint(6, 15))
                idx = rng.randint(vocab_words, size=n_words)
                if translate:
                    toks = [tgt_words[perm[j]] for j in idx]
                else:
                    toks = [src_words[j] for j in idx]
                feats = np.concatenate([signatures[j] for j in idx], axis=0)
                feats = feats + 0.25 * rng.randn(
                    *feats.shape).astype(np.float32)
                np.save(os.path.join(speech, set_key, f"{utt}.npy"), feats)
                map_dict[set_key][utt] = {"en_w": toks}
                info[set_key][utt] = {"sp": len(feats), "en_w": n_words}
        return map_dict, info

    def write_refs(set_key, map_dict):
        d = os.path.join(refs, set_key)
        os.makedirs(d, exist_ok=True)
        utts = sorted(map_dict[set_key])
        with open(os.path.join(d, "eval.ids"), "w") as f:
            f.write("\n".join(utts) + "\n")
        with open(os.path.join(d, "ref.en0"), "w") as f:
            for u in utts:
                f.write(" ".join(
                    w.decode() for w in map_dict[set_key][u]["en_w"]) + "\n")

    asr_sets = {"asr_train": n_asr, "asr_dev": n_dev}
    asr_map, asr_info = make_corpus(asr_sets, translate=False)
    write_refs("asr_dev", asr_map)
    asr_exp = _write_exp(root, "asr", asr_sets, asr_map, asr_info,
                         make_vocab(src_words), speech, refs, "asr_dev",
                         seed="transfer-ab-asr")

    st_sets = {"st_train": n_st, "st_dev": n_dev}
    st_map, st_info = make_corpus(st_sets, translate=True)
    write_refs("st_dev", st_map)
    st_exps = {arm: _write_exp(root, arm, st_sets, st_map, st_info,
                               make_vocab(tgt_words), speech, refs,
                               "st_dev", seed="transfer-ab-st")
               for arm in ("st_scratch", "st_transfer")}
    return asr_exp, st_exps


def read_log(exp, name):
    with open(os.path.join(exp, name)) as f:
        return [float(line.strip().split(", ")[1]) for line in f]


def card(device):
    """The device's name and, on a card, its power limit."""
    if not device.startswith("cuda"):
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def train(exp, epochs, device):
    """``cli.train`` for ``epochs`` epochs; returns its wall seconds and
    each epoch's train utts/s."""
    from ast_tpu_torch.cli import train as train_cli

    report = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(report):
        train_cli.main(["-m", exp, "-e", str(epochs), "--device", device])
    rates = [float(line.rsplit("= ", 1)[1].split()[0])
             for line in report.getvalue().splitlines()
             if line.startswith("train throughput")]
    return time.perf_counter() - t0, rates


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--asr-epochs", type=int, default=12)
    parser.add_argument("--st-epochs", type=int, default=25)
    parser.add_argument("--st-utts", type=int, default=96)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--root", default=None)
    parser.add_argument("--out", default=None,
                        help="also write the numbers to this JSON file")
    args = parser.parse_args(argv)

    from ast_tpu_torch.cli import copy_params

    device = card(args.device)
    with contextlib.ExitStack() as stack:
        root = args.root or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="transfer_ab_torch_"))
        asr_exp, st_exps = build_tasks(root, n_st=args.st_utts)
        print(f"synthetic tasks at {root} ({device})", flush=True)
        secs, rates = {}, {}
        secs["asr"], rates["asr"] = train(asr_exp, args.asr_epochs,
                                          args.device)
        asr = read_log(asr_exp, "dev.log")
        print(f"ASR dev BLEU by epoch: {asr}", flush=True)
        secs["scratch"], rates["scratch"] = train(
            st_exps["st_scratch"], args.st_epochs, args.device)
        with contextlib.redirect_stdout(io.StringIO()):
            copy_params.main(["--src", asr_exp, "--dst",
                              st_exps["st_transfer"], "--groups", "enc,attn",
                              "--device", args.device])
        secs["transfer"], rates["transfer"] = train(
            st_exps["st_transfer"], args.st_epochs, args.device)
        scratch = read_log(st_exps["st_scratch"], "dev.log")
        transfer = read_log(st_exps["st_transfer"], "dev.log")
        losses = {arm: read_log(st_exps[f"st_{arm}"], "train.log")
                  for arm in ("scratch", "transfer")}

    print(f"\ndevice: {device}")
    print("epoch | scratch BLEU | transfer BLEU")
    for i, (a, b) in enumerate(zip(scratch, transfer)):
        print(f"{i + 1:5d} | {a:12.2f} | {b:13.2f}")
    print(f"final: scratch {scratch[-1]:.2f}  transfer {transfer[-1]:.2f}; "
          f"best: scratch {max(scratch):.2f}  transfer {max(transfer):.2f}")
    print("seconds of cli.train (dev decodes and start-up included): "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    print("train utts/s by epoch: " + "; ".join(
        f"{k} {[round(r, 1) for r in v]}" for k, v in rates.items()),
        flush=True)
    margin_met = transfer[-1] > scratch[-1] + MARGIN
    print(f"ast_tpu's margin ({MARGIN:.0f} BLEU at the last epoch): "
          f"{'met' if margin_met else 'not met'}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": device, "asr_dev_bleu": asr,
                       "scratch_dev_bleu": scratch,
                       "transfer_dev_bleu": transfer,
                       "train_loss": losses, "cli_train_s": secs,
                       "train_utts_per_s": rates,
                       "margin_met": margin_met}, f, indent=1)
    if transfer[-1] <= scratch[-1]:
        raise SystemExit("pretraining transfer did not beat training from "
                         f"scratch: final {transfer[-1]} vs {scratch[-1]}")
    print("TRANSFER A/B PASSED: the pretrained encoder ends above scratch",
          flush=True)


if __name__ == "__main__":
    main()
