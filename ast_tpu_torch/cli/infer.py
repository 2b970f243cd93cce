"""Decode loose feature files with a trained experiment, on a GPU.

``python -m ast_tpu_torch.cli.infer -m <exp_dir> a.npy b.npy ...
[--beam N,K] [-w W] [--batch B] [--stop-limit S] [-o out.txt]
[--ckpt F] [--device cuda|cpu]``

The counterpart of ``ast_tpu/cli/infer.py`` for precomputed ``(T, 13)``
``.npy`` features: inputs are bucketed by padded length (multiples of
``buckets_width``, capped at the training length), each bucket is decoded
in batches -- greedy, cut at each row's first EOS, or beam with the
``score/(len-2)^W`` rerank -- and ``utt<TAB>text`` lines come out in
input order.  On ``--device cuda`` every kernel of the path is a
hand-written CUDA kernel; ``--device cpu`` runs their plain versions.
"""

import argparse
import os

import numpy as np
import torch

from ast_tpu_torch.config import Config
from ast_tpu_torch.symbols import SYMBOLS
from ast_tpu_torch.checkpoint import latest_checkpoint, load_checkpoint
from ast_tpu_torch.detok import dec_i2w, get_hyps
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.ops import beam as beam_ops
from ast_tpu_torch.params import from_jax_numpy, torch_device

AUDIO_TODO = ("audio input needs the fbank front-end and the wav/sph "
              "loader, which are not ported yet (ROADMAP.md queue 1, "
              "'fbank / wav input'); pass (T, 13) .npy features")


def _read_features(path):
    """One file -> float32 (T, n_ceps) features."""
    if not path.endswith(".npy"):
        raise NotImplementedError(f"{path}: {AUDIO_TODO}")
    x = np.load(path).astype(np.float32)
    if x.ndim != 2:
        raise NotImplementedError(f"{path}: shape {x.shape}: {AUDIO_TODO}")
    return x


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Decode loose (T, 13) .npy feature files")
    parser.add_argument("-m", "--cfg_path", required=True)
    parser.add_argument("inputs", nargs="+",
                        help="2-D (T, n_ceps) .npy feature files")
    parser.add_argument("--beam", default=None, metavar="N,K",
                        help="beam decode at N,K (default: greedy)")
    parser.add_argument("-w", "--W", type=float, default=0.6,
                        help="beam length-norm weight (default 0.6)")
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

    feats, seen = [], {}
    for path in args.inputs:
        utt = os.path.splitext(os.path.basename(path))[0]
        if utt in seen:
            seen[utt] += 1
            utt = f"{utt}#{seen[utt]}"
        else:
            seen[utt] = 0
        feats.append((utt, _read_features(path)))

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
                                            stop_limit=stop_limit)
    preds = {}
    with torch.inference_mode():
        w = seq2seq.decode_weights(params)      # once for every batch
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
                    p = seq2seq.predict_greedy(params, state, mcfg, X,
                                               stop_limit, w)[0].cpu().numpy()
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
