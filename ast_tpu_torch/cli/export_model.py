"""Export a trained model as a serving directory.

``python -m ast_tpu_torch.cli.export_model -m <exp_dir> [-o DIR]
[--batch B] [--frames T1,T2] [--beam N,K] [--stop-limit S] [--ckpt F]
[--quantize int8] [--quantize-min-size N]``

The counterpart of ``ast_tpu/cli/export_model.py``: loads the
experiment's latest checkpoint (or ``--ckpt``) and writes the port's
serving directory (``serving.py``): the weights once, optionally int8,
the model config, greedy -- and with ``--beam`` beam -- entries for each
frame count of the ladder, ``vocab.json`` and ``manifest.json``.  Every
model variant exports; the server decodes each as ``models.seq2seq``
routes it.  ``--platforms`` and ``--native-kernels`` (``ast_tpu``'s
StableHLO lowering targets) are accepted and ignored: the server runs
the kernels whenever it runs on the card.  ``--dtype`` (default: the
experiment's ``extras.compute_dtype``) is written to the manifest's
``compute_dtype``, at which the server decodes, any model variant at
either dtype.
"""

import argparse
import os

from ast_tpu_torch import serving
from ast_tpu_torch.checkpoint import latest_checkpoint, load_checkpoint
from ast_tpu_torch.config import Config
from ast_tpu_torch.detok import dec_i2w
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.ops import beam as beam_ops
from ast_tpu_torch.ops.bf16 import parse_dtype
from ast_tpu_torch.params import tree_map


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Export a model as a serving directory")
    parser.add_argument("-m", "--cfg_path", required=True)
    parser.add_argument("-o", "--out_dir", default=None,
                        help="output dir (default <exp>/serving)")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--frames", default=None,
                        help="comma-separated input frame counts; "
                             "default: a 4-step ladder over the bucket "
                             "range (quarter points + the longest-"
                             "bucket cap), so short inputs are not "
                             "padded to the maximum length -- the model "
                             "attends over padding unmasked")
    parser.add_argument("--beam", default=None, metavar="N,K",
                        help="also export beam decode entries at N,K")
    parser.add_argument("--stop-limit", type=int, default=None,
                        help="max decode steps (default data.max_pred)")
    parser.add_argument("--platforms", default=None,
                        help="ast_tpu's lowering targets; set and ignored")
    parser.add_argument("--native-kernels", action="store_true",
                        help="ast_tpu's Mosaic-kernel artifacts; set and "
                             "ignored (the server runs the CUDA kernels "
                             "on the card)")
    parser.add_argument("--dtype", default=None,
                        choices=["float32", "bfloat16"],
                        help="compute dtype (default: the experiment's "
                             "compute_dtype)")
    parser.add_argument("--ckpt", default=None,
                        help="export this checkpoint file instead of the "
                             "latest epoch")
    parser.add_argument("--quantize", default=None, choices=["int8"],
                        help="store weights as int8 (symmetric "
                             "per-output-channel), dequantized at load")
    parser.add_argument("--quantize-min-size", type=int, default=4096,
                        help="only quantize weight tensors with at least "
                             "this many elements (default 4096)")
    args = parser.parse_args(argv)

    beam_nk = None
    if args.beam:
        try:
            beam_nk = tuple(int(v) for v in args.beam.split(","))
            if len(beam_nk) != 2:
                raise ValueError
        except ValueError:
            parser.error(f"--beam expects N,K (got {args.beam!r})")
    ignored = [name for name, on in (
        ("--platforms", args.platforms is not None),
        ("--native-kernels", args.native_kernels)) if on]
    if ignored:
        print(f"set and ignored (the port has one artifact format, and "
              f"its server runs the CUDA kernels on the card): "
              f"{', '.join(ignored)}", flush=True)

    cfg = Config(args.cfg_path)
    mcfg = cfg.model
    dtype = args.dtype or cfg.train["extras"].get("compute_dtype",
                                                  "float32")
    compute_dtype = parse_dtype(dtype)     # before any file is written
    data_cfg = cfg.train["data"]
    stop_limit = args.stop_limit or int(data_cfg["max_pred"])
    if beam_nk:
        # the beam decoder's own checks (K <= V, N, K >= 1), before any
        # file is written
        beam_ops.make_beam_decoder(mcfg, *beam_nk, stop_limit,
                                   compute_dtype=compute_dtype)
    if args.frames:
        frames = [int(t) for t in args.frames.split(",")]
    else:
        n = int(data_cfg["buckets_num"])
        w = int(data_cfg["buckets_width"])
        # quarter-point ladder + the trainer's truncation cap
        # ((n+1)*w): the server picks the smallest fitting shape
        frames = sorted({max(1, round(n * f)) * w
                         for f in (0.25, 0.5, 0.75)} | {(n + 1) * w})

    ckpt = args.ckpt or latest_checkpoint(mcfg["model_dir"])[0]
    if ckpt is None:
        print("warning: no checkpoint found — exporting the random init")
        params, state = (tree_map(lambda t: t.numpy(), tree) for tree in
                         seq2seq.init_model(mcfg, seed=0))
    else:
        snap = load_checkpoint(ckpt)
        params, state = snap["params"], snap.get("state") or {}

    out_dir = args.out_dir or os.path.join(mcfg["model_dir"], "serving")
    os.makedirs(out_dir, exist_ok=True)
    quant = bool(args.quantize)
    if quant:
        params = serving.quantize_params(params, args.quantize_min_size)
    nbytes = serving.save_model(out_dir, mcfg, params, state)
    print(f"weights: {serving.WEIGHTS} ({nbytes} bytes"
          f"{', int8' if quant else ''})")
    entries = []
    for T in frames:
        shapes = [("greedy", None, None)]
        if beam_nk:
            shapes.append(("beam", *beam_nk))
        for kind, N, K in shapes:
            entries.append(serving.make_entry(out_dir, kind, args.batch,
                                              T, N, K, quant))
            print(f"entry {entries[-1]['file']}")
    mpath = serving.write_manifest(
        out_dir, entries, mcfg, stop_limit, dtype,
        i2w=dec_i2w(cfg.train), dec_key=data_cfg["dec_key"],
        quantization=args.quantize)
    print(f"manifest: {mpath}")
    return out_dir


if __name__ == "__main__":
    main()
