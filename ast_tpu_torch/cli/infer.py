"""Decode loose audio / feature files with a trained experiment, on a GPU.

``python -m ast_tpu_torch.cli.infer -m <exp_dir> utt1.wav utt2.sph a.npy
... [--beam N,K] [-w W] [--cmvn utt|none|<stats.pkl>] [--batch B]
[--stop-limit S] [-o out.txt] [--ckpt F] [--device cuda|cpu]``

The counterpart of ``ast_tpu/cli/infer.py``: each input is read (WAV /
SPHERE audio, 1-D ``.npy`` audio, or a precomputed ``(T, 13)`` ``.npy``
feature matrix), audio goes through the MFCC front-end
(``ops/fbank.py``) on ``--device`` and CMVN, inputs are bucketed by
padded length (multiples of ``buckets_width``, capped at the training
length), each bucket is decoded in batches -- greedy, cut at each row's
first EOS, or beam with the ``score/(len-2)^W`` rerank -- and
``utt<TAB>text`` lines come out in input order.  On ``--device cuda``
every kernel of the path is a hand-written CUDA kernel; ``--device cpu``
runs their plain versions.  Decoding runs at the experiment's
``extras.compute_dtype`` (bfloat16: K1 eval, K5 and K6 in their bf16
mode), as ``ast_tpu``'s ``NN.compute_dtype``.
"""

import argparse
import os
import pickle

import numpy as np
import torch

from ast_tpu_torch.config import Config
from ast_tpu_torch.symbols import SYMBOLS
from ast_tpu_torch.checkpoint import latest_checkpoint, load_checkpoint
from ast_tpu_torch.detok import dec_i2w, get_hyps
from ast_tpu_torch.data import wav_loader
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.ops import beam as beam_ops
from ast_tpu_torch.ops.bf16 import parse_dtype
from ast_tpu_torch.ops.fbank import (
    MfccExtractor, apply_cmvn, compute_cmvn_stats)
from ast_tpu_torch.params import from_jax_numpy, torch_device


def _read_input(path, mfcc, cmvn_mode, cmvn_stats, utt2spk, utt):
    """One file -> float32 (T, n_ceps) features."""
    if path.endswith(".npy"):
        x = np.load(path).astype(np.float32)
        if x.ndim == 2:          # precomputed features, used as-is
            return x
        if x.ndim != 1:
            raise ValueError(f"{path}: expected 1-D audio or 2-D "
                             f"features, got shape {x.shape}")
        audio, rate = x, None
    elif path.endswith(".sph"):
        audio, rate = wav_loader.read_sph(path, with_rate=True)
    else:
        audio, rate = wav_loader.read_wav(path, with_rate=True)
    want = mfcc.cfg.sample_rate
    if rate is not None and rate != want:
        raise ValueError(
            f"{path}: sample rate {rate} != model front-end rate {want}; "
            "resample offline (the experiment was trained on "
            f"{want} Hz features)")
    feats = mfcc(audio).cpu().numpy()
    if cmvn_mode == "none":
        return feats
    if cmvn_mode == "utt":
        stats = compute_cmvn_stats([feats])
    else:
        spk = utt2spk.get(utt, utt)
        if spk not in cmvn_stats:
            raise KeyError(
                f"{path}: no CMVN stats for speaker {spk!r} in the "
                "provided stats file (and no utt2spk entry); use "
                "--cmvn utt for per-utterance normalization")
        stats = cmvn_stats[spk]
    return np.asarray(apply_cmvn(feats, stats), np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Decode loose audio/feature files")
    parser.add_argument("-m", "--cfg_path", required=True)
    parser.add_argument("inputs", nargs="+",
                        help=".wav/.sph audio, 1-D .npy audio, or "
                             "2-D (T, n_ceps) .npy features")
    parser.add_argument("--beam", default=None, metavar="N,K",
                        help="beam decode at N,K (default: greedy)")
    parser.add_argument("-w", "--W", type=float, default=0.6,
                        help="beam length-norm weight (default 0.6)")
    parser.add_argument("--cmvn", default="utt",
                        help="'utt' (per-utterance stats, default), "
                             "'none', or a path to a cmvn.stats pickle "
                             "({'utt2spk': ..., 'stats': ...}, the "
                             "wav-mode training layout)")
    parser.add_argument("--batch", type=int, default=None,
                        help="max decode batch (default: train batch_size)")
    parser.add_argument("--stop-limit", type=int, default=None,
                        help="max decode steps (default data.max_pred)")
    parser.add_argument("-o", "--output", default=None,
                        help="write '<name>\\t<text>' lines here too")
    parser.add_argument("--ckpt", default=None,
                        help="decode from this checkpoint file instead of "
                             "the latest epoch")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "plain PyTorch versions of the kernels)")
    args = parser.parse_args(argv)
    beam_nk = None
    if args.beam is not None:
        try:
            beam_nk = tuple(int(v) for v in args.beam.split(","))
            if len(beam_nk) != 2:
                raise ValueError
        except ValueError:
            parser.error(f"--beam expects N,K (got {args.beam!r})")
    device = torch_device(args.device)

    cfg = Config(args.cfg_path)
    mcfg = cfg.model
    dtype = parse_dtype(cfg.train["extras"].get("compute_dtype"))
    ckpt = args.ckpt or latest_checkpoint(cfg.model["model_dir"])[0]
    if ckpt is None:
        print("warning: no checkpoint found — decoding with random init")
        params, state = seq2seq.init_model(mcfg, seed=0, device=device)
    else:
        snap = load_checkpoint(ckpt)
        params, state = from_jax_numpy(snap["params"], snap.get("state") or {},
                                       device)
    data_cfg = cfg.train["data"]
    stop_limit = args.stop_limit or int(data_cfg["max_pred"])
    bs = cfg.train["batch_size"]
    if isinstance(bs, dict):  # legacy per-bucket sizes {max, med, min}
        bs = max(int(bs[k]) for k in ("max", "med", "min") if k in bs)
    batch_size = args.batch or int(bs)
    width_b = int(data_cfg["buckets_width"])
    max_sp = (int(data_cfg["buckets_num"]) + 1) * width_b

    cmvn_stats, utt2spk = {}, {}
    if args.cmvn not in ("utt", "none"):
        # a stats file the user names, in the layout the wav-mode
        # trainer reads
        with open(args.cmvn, "rb") as f:
            blob = pickle.load(f)
        cmvn_stats = blob.get("stats", blob)
        utt2spk = blob.get("utt2spk", {})

    mfcc = MfccExtractor(device=device)
    feats, seen = [], {}
    for path in args.inputs:
        utt = os.path.splitext(os.path.basename(path))[0]
        if utt in seen:
            seen[utt] += 1
            utt = f"{utt}#{seen[utt]}"
        else:
            seen[utt] = 0
        with torch.inference_mode():
            feats.append((utt, _read_input(path, mfcc, args.cmvn,
                                           cmvn_stats, utt2spk, utt)))

    groups = {}
    for utt, x in feats:
        if x.shape[0] > max_sp:
            print(f"warning: {utt}: {x.shape[0]} frames truncated to "
                  f"the training cap {max_sp}")
            x = x[:max_sp]
        T = max(width_b, -(-x.shape[0] // width_b) * width_b)
        groups.setdefault(T, []).append((utt, x))

    if beam_nk is not None:
        decode = beam_ops.make_beam_decoder(mcfg, N=beam_nk[0],
                                            K=beam_nk[1],
                                            stop_limit=stop_limit,
                                            compute_dtype=dtype)
    preds = {}
    with torch.inference_mode():
        w = seq2seq.decode_weights(params, dtype, mcfg)   # once a run
        for T in sorted(groups):
            items = groups[T]
            for i in range(0, len(items), batch_size):
                chunk = items[i:i + batch_size]
                X = np.zeros((len(chunk), T, chunk[0][1].shape[1]),
                             np.float32)
                for j, (_, x) in enumerate(chunk):
                    X[j, :x.shape[0]] = x[:T]
                X = torch.from_numpy(X).to(device)
                if beam_nk is not None:
                    hyps, scores, lengths = (
                        a.cpu().numpy() for a in decode(params, state, X,
                                                        w))
                    entries = {
                        utt: [(hyps[j, n, :int(lengths[j, n])].tolist(),
                               float(scores[j, n]))
                              for n in range(hyps.shape[1])]
                        for j, (utt, _) in enumerate(chunk)}
                    preds.update(beam_ops.get_best_hyps(entries, args.W))
                else:
                    p = seq2seq.predict_greedy(
                        params, state, mcfg, X, stop_limit, w,
                        compute_dtype=dtype)[0].cpu().numpy()
                    for j, (utt, _) in enumerate(chunk):
                        # cut each file's ids at its own first EOS
                        eos = np.nonzero(p[j] == SYMBOLS.EOS_ID)[0]
                        preds[utt] = (p[j][:eos[0]] if eos.size
                                      else p[j]).tolist()

    hyps = get_hyps(preds.items(), dec_i2w(cfg.train), data_cfg["dec_key"])
    lines = []
    for utt, _ in feats:
        lines.append(f"{utt}\t{' '.join(hyps[utt])}")
        print(lines[-1])
    if args.output:
        with open(args.output, "w") as f:
            f.write("\n".join(lines) + "\n")
    return {utt: " ".join(hyps[utt]) for utt, _ in feats}


if __name__ == "__main__":
    main()
