#!/usr/bin/env python3
"""Where the decode time of ast_tpu_torch goes, on one NVIDIA GPU.

    python3 profile_decode.py [--out DIR]

On chip_smoke.py's synthetic es_en_20h experiment (seeded weights, 64
feature files of 100-1,200 frames):
1. kernels: one call each of K1, K5 and K6 at chip_smoke's shapes (B=32,
   640 frames, stop 175, beam 5,5), of the training decoder's K3 and
   K4 (U=64 targets, dropout 0.3, teacher ratio 0.8), and of the
   training encoder's K1 train and K2 (dropout 0.3; also at 8 rows),
   under torch.profiler -- each CUDA kernel's launches, mean and share of
   the call's device time, and the call split by phase: LSTM cells
   (the encoder's waves among them), row-wise
   linears (q, ctx, logits; K4's and K2's transposed products), attention,
   the cell backward, selection and argmax, the wrapper's torch ops (the
   weight packs of K1-K4), and the launch gaps (the span from the first
   kernel's start to the last one's end, less the busy time).
   The kernels are programmatic dependent launches, so a
   kernel's span may start while its predecessor runs and wait for it:
   the split gives each kernel only the part of its span past the end
   of the ones before it (its share of the busy time);
2. slice: the entry point ast_tpu_torch.cli.infer, greedy and beam 5,5,
   under torch.profiler after a warm-up call -- wall time, device busy
   time (the union of kernel intervals) and the idle share
   1 - busy / wall, and the length buckets and batches the files make;
3. host: the pieces of a CLI call timed alone -- config and checkpoint
   read, weights to the card, the feature reads, one greedy batch (B=32,
   640 frames) end to end.

With --out, the profiler's tables are written there too.  Needs a CUDA
device; exits 2 without one.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import chip_smoke


def device_intervals(prof):
    """(name, start_us, end_us) of every kernel the profiler saw on the
    card."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def exclusive_us(intervals):
    """[(name, µs)]: each interval's part past the end of every interval
    that started before it; these add up to the length of the union."""
    out, end = [], -np.inf
    for name, a, b in sorted(intervals, key=lambda x: x[1]):
        out.append((name, max(0.0, b - max(a, end))))
        end = max(end, b)
    return out


def busy_us(intervals):
    """Length of the union of the intervals."""
    return sum(t for _, t in exclusive_us(intervals))


def kernel_table(intervals):
    """Per kernel name: launches, total and mean exclusive µs, share of
    the sum (the busy time)."""
    by = {}
    for name, dt in exclusive_us(intervals):
        n, t = by.get(name, (0, 0.0))
        by[name] = (n + 1, t + dt)
    total = sum(t for _, t in by.values()) or 1.0
    rows = sorted(by.items(), key=lambda kv: -kv[1][1])
    return total, [(name, n, t, t / n, t / total) for name, (n, t) in rows]


def profiled(fn):
    """Run ``fn`` once under torch.profiler (CPU + CUDA); returns (prof,
    wall seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


# kernel-name fragments -> phase of a decode step, first match wins
PHASES = (("cell_bwd", "cell backward"), ("EncCell", "LSTM cell"),
          ("wave_kernel", "linears"),
          (", true>", "LSTM cell"), ("prod_train_kernel", "LSTM cell"),
          ("prod_bwd_kernel", "linears + cell backward"),
          ("prod_kernel", "linears"),
          ("attention", "attention"),
          ("argmax", "selection / argmax"),
          ("beam_step", "selection / argmax"),
          ("select_embed", "input selection / head"),
          ("head_kernel", "input selection / head"),
          ("at::", "torch ops"), ("Memcpy", "torch ops"),
          ("Memset", "torch ops"))


def phase_split(intervals):
    """[(phase, ms)] of a call's kernels, by each kernel's exclusive
    time, with the launch gaps last."""
    by = {}
    for name, t in exclusive_us(intervals):
        ph = next((p for k, p in PHASES if k in name), "other")
        by[ph] = by.get(ph, 0.0) + t / 1e3
    span = (max(b for _, _, b in intervals)
            - min(a for _, a, _ in intervals)) / 1e3
    return sorted(by.items(), key=lambda kv: -kv[1]) + [
        ("launch gaps", span - busy_us(intervals) / 1e3)]


def short(name, width=48):
    return name if len(name) <= width else name[:width - 3] + "..."


def encoder_train_calls(enc_in, nb):
    """K1 train and K2 on the first ``nb`` rows of the batch behind
    ``enc_in`` (K2 fed K1's residuals and random cotangents)."""
    import torch

    from ast_tpu_torch.ops import fused_lstm

    tr = (enc_in[0][:, :, :nb].contiguous(), *enc_in[1:4], 12345,
          chip_smoke.DROP)
    res = fused_lstm.fused_stacked_lstm_train(*tr)
    bwd = (res[3], res[4], enc_in[1], enc_in[2],
           *(torch.randn_like(t) for t in res[:3]), 12345, chip_smoke.DROP)
    tag = "" if nb == chip_smoke.B else f" at {nb} rows"
    return {f"K1 train{tag}": lambda: fused_lstm.fused_stacked_lstm_train(
                *tr),
            f"K2{tag}": lambda: fused_lstm.encoder_backward(*bwd)}


def profile_kernels(cfg, device, out):
    """Phase 1."""
    import torch

    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.ops import fused_decoder, fused_infer, fused_lstm

    params, state = seq2seq.init_model(cfg.model, seed=0, device=device)
    rng = np.random.default_rng(2)
    X = torch.from_numpy(rng.standard_normal(
        (chip_smoke.B, chip_smoke.FRAMES, 13)).astype(np.float32)).to(device)
    U = chip_smoke.U_TRAIN - 1
    y_in = rng.integers(4, chip_smoke.VOCAB, (U, chip_smoke.B))
    y_in[0] = 1
    coins = (rng.random(U) < chip_smoke.TEACH).astype(np.int32)
    coins[0] = 1
    y_in = torch.from_numpy(y_in.astype(np.int32)).to(device)
    coins = torch.from_numpy(coins).to(device)
    with torch.inference_mode():
        enc_in = seq2seq.encoder_inputs(params, state, cfg.model, X)
        enc, h0, c0 = seq2seq.encoder_outputs(
            *fused_lstm.fused_stacked_lstm(*enc_in))
        w = seq2seq.decode_weights(params)
        w_train = seq2seq.pack_decoder_weights(params)
        k3 = (enc, h0, c0, w_train, y_in, coins, 777, chip_smoke.DROP,
              chip_smoke.DROP)
        ht, res = fused_decoder.decoder_forward(*k3)
        k4 = (res, ht, enc, c0, w_train, torch.randn_like(ht), 777,
              chip_smoke.DROP, chip_smoke.DROP)
        calls = {
            "K3": lambda: fused_decoder.decoder_forward(*k3),
            "K4": lambda: fused_decoder.decoder_backward(*k4),
            "K1": lambda: fused_lstm.fused_stacked_lstm(*enc_in),
            **encoder_train_calls(enc_in, chip_smoke.B),
            **encoder_train_calls(enc_in, 8),
            "K5": lambda: fused_infer.greedy_decode_fused(
                enc, h0, c0, w, chip_smoke.STOP),
            "K6": lambda: fused_infer.beam_decode_fused(
                enc, h0, c0, w, chip_smoke.N_BEAM, chip_smoke.K_BEAM,
                chip_smoke.STOP),
        }
        for name, fn in calls.items():
            fn()  # warm-up
            prof, wall = profiled(fn)
            total, rows = kernel_table(device_intervals(prof))
            print(f"{name}: wall {wall * 1e3:.2f} ms, device busy "
                  f"{total / 1e3:.2f} ms in {sum(r[1] for r in rows)} kernel "
                  f"launches", flush=True)
            for kname, n, t, mean, share in rows[:8]:
                print(f"  {short(kname):48s} {n:5d} x {mean:8.2f} us "
                      f"= {t / 1e3:7.2f} ms  {share * 100:5.1f} %")
            print("  by phase: " + ", ".join(
                f"{ph} {ms:.2f} ms" for ph, ms in phase_split(
                    device_intervals(prof))), flush=True)
            if out:
                table = f"kernels_{name.replace(' ', '_')}.txt"
                with open(os.path.join(out, table), "w") as f:
                    f.write(prof.key_averages().table(
                        sort_by="self_device_time_total", row_limit=40))


def profile_slice(cfg, exp, paths, root, out):
    """Phase 2."""
    from ast_tpu_torch.cli import infer

    width = cfg.train["data"]["buckets_width"]
    sizes = {}
    for p in paths:
        T = len(np.load(p, mmap_mode="r"))
        T = max(width, -(-T // width) * width)
        sizes[T] = sizes.get(T, 0) + 1
    n_batches = sum(-(-n // chip_smoke.B) for n in sizes.values())
    print(f"slice: {len(paths)} files in {len(sizes)} length buckets, "
          f"{n_batches} batches", flush=True)
    # the CLI's one line per file goes to its -o file only
    chip_smoke.quiet(infer.main, ["-m", exp, "--device", "cuda", "-o",
                                  os.path.join(root, "warmup.txt")]
                     + paths[:2])
    for name, extra in (("greedy", []),
                        ("beam", ["--beam", f"{chip_smoke.N_BEAM},"
                                            f"{chip_smoke.K_BEAM}"])):
        argv = ["-m", exp, "--device", "cuda", "-o",
                os.path.join(root, f"{name}.txt")] + extra + paths
        prof, wall = profiled(lambda: chip_smoke.quiet(infer.main, argv))
        iv = device_intervals(prof)
        busy = busy_us(iv) / 1e6
        total, rows = kernel_table(iv)
        print(f"slice {name}: {len(paths)} files, wall {wall:.3f} s, device "
              f"busy {busy:.3f} s, idle share {1 - busy / wall:.3f} "
              f"(under the profiler)", flush=True)
        for kname, n, t, mean, share in rows[:6]:
            print(f"  {short(kname):48s} {n:6d} x {mean:8.2f} us "
                  f"= {t / 1e6:6.3f} s  {share * 100:5.1f} %")
        if out:
            with open(os.path.join(out, f"slice_{name}.txt"), "w") as f:
                f.write(prof.key_averages().table(
                    sort_by="self_cpu_time_total", row_limit=40))


def time_host(exp, paths):
    """Phase 3."""
    import torch

    from ast_tpu_torch import Config
    from ast_tpu_torch.checkpoint import latest_checkpoint, load_checkpoint
    from ast_tpu_torch.cli.infer import _read_features
    from ast_tpu_torch.models import seq2seq
    from ast_tpu_torch.params import from_jax_numpy

    device = torch.device("cuda")
    t0 = time.perf_counter()
    cfg = Config(exp)
    snap = load_checkpoint(latest_checkpoint(exp)[0])
    t1 = time.perf_counter()
    params, state = from_jax_numpy(snap["params"], snap["state"], device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    feats = [_read_features(p) for p in paths]
    t3 = time.perf_counter()
    X = np.zeros((chip_smoke.B, chip_smoke.FRAMES, 13), np.float32)
    for j, x in enumerate(feats[:chip_smoke.B]):
        X[j, :min(len(x), chip_smoke.FRAMES)] = x[:chip_smoke.FRAMES]

    def batch():
        with torch.inference_mode():
            return seq2seq.predict_greedy(
                params, state, cfg.model, torch.from_numpy(X).to(device),
                chip_smoke.STOP)[0].cpu()

    batch()
    t4 = time.perf_counter()
    batch()
    t5 = time.perf_counter()
    print(f"host: config + checkpoint read {t1 - t0:.3f} s, weights to the "
          f"card {t2 - t1:.3f} s, {len(paths)} feature reads {t3 - t2:.3f} "
          f"s, one greedy batch (B={chip_smoke.B}, {chip_smoke.FRAMES} "
          f"frames, stop {chip_smoke.STOP}) {(t5 - t4) * 1e3:.1f} ms end to "
          f"end", flush=True)


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="directory for the profiler's tables")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device available", file=sys.stderr)
        return 2
    from ast_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    build.library()
    with tempfile.TemporaryDirectory() as root:
        exp, cfg, paths = chip_smoke.make_experiment(root)
        profile_kernels(cfg, torch.device("cuda"), args.out)
        profile_slice(cfg, exp, paths, root, args.out)
        time_host(exp, paths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
