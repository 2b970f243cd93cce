#!/usr/bin/env python
"""Time ast_tpu_torch's trainer (``NN.train_epoch``) over an epoch of the
es_en_20h corpus's shape, on the card.

The port's counterpart of ``scripts/trainer_epoch_bench.py``: the same
synthetic corpus (``build_corpus``: the 17,306 utterances of the 20
duration buckets of ``fisher_20h.info``, ``EPOCH_BUCKETS``, their frame
lengths and target lengths, random 13-dim features and a 1,098-entry
vocabulary), the same flagship model (``FLAGSHIP_MCFG``, es_en_20h's
widths) and the same train_cfg (``write_configs``), driven through the
shipped harness: loader, prefetch threads, the feed options and the
kernels.  It imports neither JAX nor ``ast_tpu``.

Usage:
  python scripts/torch_trainer_epoch_bench.py [--batch 32] [--g 4]
      [--epochs 3] [--root DIR] [--pack] [--transfer-dtype bfloat16]
      [--workers 2] [--hbm-cache] [--hbm-cache-dtype bfloat16]
      [--scale 1] [--dtype bfloat16] [--remat] [--buckets 0:64,19:32]
      [--device cuda]

It prints one line an epoch, then one more warm epoch under
torch.profiler (not timed) for the device's busy time a step, and last
one JSON object: bench.py's keys (``value`` is the median utts/s of the
warm epochs; epoch 1 holds the model build's first steps, the cache
fill and cuBLAS's warm-up), the card (name, power limit), steps an epoch,
the device's busy ms a step (the profiled epoch) and idle share (of the
timed warm epochs' median step), host-to-device bytes a step and the
peak of allocated device memory (MiB) over the warm epochs.
"""

import argparse
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

VOCAB_WORDS = 1094  # + 4 specials = the flagship's 1098

# The es_en_20h train split's composition -- (bucket, n_utts, frames, U)
# -- from the reference's fisher_20h.info (17,306 utterances in 80-frame
# duration buckets; U the largest BPE target length of a bucket, words x
# 1.4 + GO / EOS, rounded up to 16): ast_tpu's bench.EPOCH_BUCKETS.
EPOCH_BUCKETS = [
    (0, 1025, 80, 16), (1, 3516, 160, 16), (2, 2543, 240, 32),
    (3, 1939, 320, 32), (4, 1486, 400, 48), (5, 1188, 480, 48),
    (6, 932, 560, 64), (7, 736, 640, 80), (8, 674, 720, 64),
    (9, 603, 800, 64), (10, 550, 880, 64), (11, 505, 960, 64),
    (12, 420, 1040, 80), (13, 342, 1120, 80), (14, 277, 1200, 80),
    (15, 189, 1280, 96), (16, 138, 1360, 96), (17, 86, 1440, 80),
    (18, 63, 1520, 80), (19, 94, 1680, 96),
]

# es_en_20h's model: ast_tpu's __graft_entry__.FLAGSHIP_MCFG
FLAGSHIP_MCFG = {
    "dropout": {"embed": 0.3, "rnn": 0.3, "out": 0},
    "rnn_config": {
        "bi_rnn": True,
        "enc_layers": 3,
        "dec_layers": 3,
        "hidden_units": 512,
        "embedding_units": 128,
        "attn_units": 512,
        "n_attn": 1,
        "feed_attn": True,
        "ln": False,
        "dec_vocab_size": 1098,
    },
    "cnn_config": {
        "bn": True,
        "cnn_layers": [
            {"in_channels": None, "out_channels": 128, "ksize": [9, 13],
             "stride": [2, 13], "pad": [4, 0]},
            {"in_channels": None, "out_channels": 512, "ksize": [9, 1],
             "stride": [2, 1], "pad": [4, 0]},
        ],
    },
}

METRIC = "fisher_es_en_20h_train_utts_per_sec_per_chip"


def build_corpus(root, log=print, scale=1, buckets=None):
    """The synthetic corpus of ``buckets`` (default EPOCH_BUCKETS) under
    ``root``: per-utterance ``.npy`` features, ``syn.map`` /
    ``syn.vocab`` / ``syn.info`` and the dev references, byte for byte
    those of ``scripts/trainer_epoch_bench.py``'s ``build_corpus`` over
    the same buckets.  ``scale`` multiplies every bucket's count.  The
    features are written once (``.corpus_done``).  Returns the number of
    train utterances."""
    buckets = EPOCH_BUCKETS if buckets is None else buckets
    data = os.path.join(root, "data")
    speech = os.path.join(root, "speech", "syn_train")
    refs = os.path.join(data, "refs")
    exp = os.path.join(root, "exp")
    done_marker = os.path.join(root, ".corpus_done")
    for d in (data, speech, refs, exp):
        os.makedirs(d, exist_ok=True)

    specials = [b"_PAD", b"_GO", b"_EOS", b"_UNK"]
    words = [f"w{i}".encode() for i in range(VOCAB_WORDS)]
    w2i = {w: i for i, w in enumerate(specials + words)}
    vocab = {"en_w": {"w2i": w2i,
                      "i2w": {i: w for w, i in w2i.items()},
                      "freq": {}}}

    rng = np.random.RandomState(0)
    map_dict = {"syn_train": {}, "syn_dev": {}}
    info = {"syn_train": {}, "syn_dev": {}}

    regen = not os.path.exists(done_marker)
    t0 = time.time()
    n_total = 0
    for b, n, T, U in buckets:
        n *= int(scale)
        lo = b * 80 + 1
        hi = T  # the bucket's upper edge: its frame count
        for i in range(n):
            utt = f"b{b:02d}_u{i:05d}"
            frames = int(rng.randint(max(lo, hi - 79), hi + 1))
            # U counts GO / EOS and the pad-to-16 headroom: U-8 .. U-2
            # real tokens put the bucket's target length at U
            n_words = int(rng.randint(max(2, U - 8), U - 1))
            toks = [words[rng.randint(VOCAB_WORDS)]
                    for _ in range(n_words)]
            map_dict["syn_train"][utt] = {"en_w": toks}
            info["syn_train"][utt] = {"sp": frames, "en_w": n_words}
            if regen:
                feats = rng.randn(frames, 13).astype(np.float32)
                np.save(os.path.join(speech, f"{utt}.npy"), feats)
            n_total += 1
    # a small dev set (never timed), for the trainer's dev split
    dev_dir = os.path.join(root, "speech", "syn_dev")
    os.makedirs(dev_dir, exist_ok=True)
    for i in range(8):
        utt = f"dev_u{i:03d}"
        frames = 100 + 10 * i
        map_dict["syn_dev"][utt] = {"en_w": [words[i]]}
        info["syn_dev"][utt] = {"sp": frames, "en_w": 1}
        if regen:
            np.save(os.path.join(dev_dir, f"{utt}.npy"),
                    rng.randn(frames, 13).astype(np.float32))
    if regen:
        log(f"generated {n_total} feature files in "
            f"{time.time() - t0:.0f}s")
        with open(done_marker, "w") as f:
            f.write("ok")

    for name, obj in [("syn.map", map_dict), ("syn.vocab", vocab),
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
                             for w in map_dict["syn_dev"][u]["en_w"])
                    + "\n")
    return n_total


def write_configs(root, batch, g, transfer_dtype="float32",
                  prefetch_workers=2, hbm_cache=False,
                  hbm_cache_dtype="float32", compute_dtype="bfloat16",
                  remat=False):
    """The experiment's train_cfg and model_cfg under ``root/exp``: those
    of ``trainer_epoch_bench.py``'s ``write_configs``, with the compute
    dtype (bf16 there) and ``extras.remat`` as arguments.  Returns the
    experiment directory."""
    exp = os.path.join(root, "exp")
    data = os.path.join(root, "data")
    extras = {"random_out": 0, "speech_noise": 0.25,
              "teach_ratio": 0.8,
              "compute_dtype": compute_dtype,
              "transfer_dtype": transfer_dtype,
              "prefetch_workers": prefetch_workers,
              "hbm_cache": hbm_cache,
              "hbm_cache_dtype": hbm_cache_dtype,
              "steps_per_dispatch": g}
    if remat:
        extras["remat"] = True
    train_cfg = {
        "seed": "epoch-bench",
        "iters_save": 1000,       # no in-epoch snapshots in the timing
        "train_set": "syn_train",
        "dev_set": "syn_dev",
        "extras": extras,
        "data": {
            "enc_key": "sp", "dec_key": "en_w",
            "speech_path": os.path.join(root, "speech"),
            "map_path": os.path.join(data, "syn.map"),
            "vocab_path": os.path.join(data, "syn.vocab"),
            "info_path": os.path.join(data, "syn.info"),
            "refs_path": os.path.join(data, "refs"),
            "max_pred": 96, "n_evals": 1,
            "buckets_num": 20, "buckets_width": 80,
            "train_scale": 1, "zero_input": 0,
        },
        "optimizer": {"type": 0, "lr": 1e-3, "l2": 1e-4,
                      "grad_clip": 2, "grad_noise_eta": 0,
                      "freeze": []},
        "batch_size": batch,
    }
    mcfg = json.loads(json.dumps(FLAGSHIP_MCFG))
    mcfg["rnn_config"].pop("dec_vocab_size", None)
    with open(os.path.join(exp, "train_cfg.json"), "w") as f:
        json.dump(train_cfg, f, indent=1)
    with open(os.path.join(exp, "model_cfg.json"), "w") as f:
        json.dump(mcfg, f, indent=1)
    return exp


def _decile_spread(v):
    """(p90 - p10) / median of the epochs' rates (bench.py's)."""
    if len(v) < 2:
        return 0.0
    p10, p90 = np.percentile(v, [10, 90])
    return round(float(p90 - p10) / max(1e-9, float(np.median(v))), 3)


def parse_buckets(spec):
    """``"b:n,b:n"`` -> the EPOCH_BUCKETS entries of those buckets with n
    utterances each (None: all, at their counts)."""
    if not spec:
        return None
    rows = {b: (b, n, T, U) for b, n, T, U in EPOCH_BUCKETS}
    out = []
    for part in spec.split(","):
        b, n = (int(v) for v in part.split(":"))
        out.append((b, n) + rows[b][2:])
    return out


def card(device):
    """The card's name and power limit as nvidia-smi prints them."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    name, limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].split(", ")
    return {"name": name, "power_limit": limit}


def device_busy_ms(prof):
    """The union of a torch.profiler trace's device spans, in ms, and
    their count.  It reads the trace's raw events: an epoch's million
    spans would take minutes through ``prof.events()``."""
    from torch.autograd import DeviceType

    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy, end = 0, -1
    for a, b in spans:
        busy += max(0, b - max(a, end))
        end = max(end, b)
    return busy / 1e6, len(spans)


def profiled_epoch(nn, set_key, epoch):
    """One epoch under torch.profiler (the device's activity): (wall ms,
    busy ms, steps, device spans)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    steps0 = nn.timer.n_steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nn.train_epoch(set_key, epoch=epoch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, n_spans = device_busy_ms(prof)
    return wall, busy, nn.timer.n_steps - steps0, n_spans


def run(args):
    """The benchmark; returns its JSON object."""
    import torch

    from ast_tpu_torch.params import torch_device
    from ast_tpu_torch.train.trainer import NN

    device = torch_device(args.device)
    buckets = parse_buckets(args.buckets)
    n_utts = build_corpus(args.root, scale=args.scale, buckets=buckets)
    if args.pack:
        from ast_tpu_torch.data.feature_pack import pack_features
        for s in ("syn_train", "syn_dev"):
            out = os.path.join(args.root, "speech", f"{s}.pack")
            if not os.path.exists(out):
                pack_features(os.path.join(args.root, "speech", s), out)
                print(f"packed {s}", flush=True)
    exp = write_configs(args.root, args.batch, args.g,
                        transfer_dtype=args.transfer_dtype,
                        prefetch_workers=args.workers,
                        hbm_cache=args.hbm_cache,
                        hbm_cache_dtype=args.hbm_cache_dtype,
                        compute_dtype=args.dtype, remat=args.remat)
    whole = "full 20-bucket " if buckets is None else ""
    config = (f"ast_tpu_torch NN.train_epoch: {whole}es_en_20h epoch "
              f"({n_utts} utts), B={args.batch} "
              f"G={args.g}, {args.dtype}, "
              + (f"hbm_cache ({args.hbm_cache_dtype})" if args.hbm_cache
                 else f"host feeding ({args.transfer_dtype})")
              + (", remat" if args.remat else "")
              + f", prefetch_workers={args.workers}"
              + (", pack" if args.pack else ""))
    dev = card(device)
    print(f"{config}; {dev['name']}, {dev['power_limit']}", flush=True)

    nn = NN(exp, args.device)
    rates = []
    for e in range(1, args.epochs + 1):
        if e == 2 and device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        steps0 = nn.timer.n_steps
        t0 = time.perf_counter()
        loss = nn.train_epoch("syn_train", epoch=e)
        dt = time.perf_counter() - t0       # ends in the epoch's sync
        steps = nn.timer.n_steps - steps0
        print(f"epoch {e}: {dt:7.2f} s  {n_utts / dt:8.1f} utts/s  "
              f"{steps} steps, {nn.epoch_h2d_bytes / steps / 1e6:.3f} MB "
              f"host-to-device a step (loss {loss:.3f})"
              + ("  [cold: first steps, cache fill]" if e == 1 else ""),
              flush=True)
        rates.append(n_utts / dt)
    # the warm epochs (the cold one alone when it is the only one)
    rates = rates[1:] or rates
    med = float(np.median(rates))
    out = {
        "metric": METRIC if device.type == "cuda"
        else "fisher_es_en_20h_train_utts_per_sec_cpu",
        "value": round(med, 2), "unit": "utts/sec/chip", "config": config,
        "trainer_epochs_utts_per_sec": [round(v, 1) for v in rates],
        "trainer_epoch_seconds": round(n_utts / med, 2),
        "trainer_spread": _decile_spread(rates),
        "device": dev, "steps_per_epoch": steps,
        "h2d_bytes_per_step": round(nn.epoch_h2d_bytes / steps),
        "device_busy_ms_per_step": None, "idle_share": None,
        "peak_mib": None,
    }
    if device.type == "cuda":
        out["peak_mib"] = round(torch.cuda.max_memory_allocated() / 2**20, 1)
        wall, busy, n, spans = profiled_epoch(nn, "syn_train",
                                              args.epochs + 1)
        # the idle share of the timed epochs' step: tracing slows the
        # host, not the kernels
        step_ms = 1e3 * n_utts / med / steps
        out.update(device_busy_ms_per_step=round(busy / n, 3),
                   idle_share=round(1.0 - busy / n / step_ms, 4),
                   profiled_wall_ms_per_step=round(wall / n, 3),
                   profiled_idle_share=round(1.0 - busy / wall, 4))
        print(f"profiled epoch: {wall / n:.3f} ms a step, device busy "
              f"{busy / n:.3f} ms a step ({spans} device spans); "
              f"{step_ms:.3f} ms a timed step, idle "
              f"{1 - busy / n / step_ms:.1%}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--g", type=int, default=4,
                    help="extras.steps_per_dispatch")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--root", default=os.path.join(
        tempfile.gettempdir(), "torch_trainer_epoch_bench"))
    ap.add_argument("--pack", action="store_true",
                    help="serve features from a memory-mapped pack "
                         "instead of per-utterance .npy files")
    ap.add_argument("--transfer-dtype", default="float32",
                    dest="transfer_dtype",
                    choices=["float32", "bfloat16", "float16"])
    ap.add_argument("--workers", type=int, default=2,
                    help="extras.prefetch_workers")
    ap.add_argument("--hbm-cache", action="store_true", dest="hbm_cache",
                    help="extras.hbm_cache: the epoch's features on the "
                         "device, batches gathered there")
    ap.add_argument("--hbm-cache-dtype", default="float32",
                    dest="hbm_cache_dtype", choices=["float32", "bfloat16"])
    ap.add_argument("--scale", type=int, default=1,
                    help="multiply every bucket's utterance count")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"],
                    help="extras.compute_dtype")
    ap.add_argument("--remat", action="store_true", help="extras.remat")
    ap.add_argument("--buckets", default=None,
                    help="b:n,... -- only these buckets, n utterances each "
                         "(default: all 20 at their counts)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
