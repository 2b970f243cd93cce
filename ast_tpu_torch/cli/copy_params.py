"""Pretrain-and-transfer: copy param groups between experiments.

``python -m ast_tpu_torch.cli.copy_params --src D [--dst D]
[--groups enc,attn,dec] [--average last:K|e1,e2] [--out F]
[--export-chainer F] [--device cuda|cpu]``

The counterpart of ``ast_tpu/cli/copy_params.py``, with its flags,
messages and files.  Transfer (the default): build a fresh target model
for ``--dst``'s model_cfg, copy the encoder (``enc``: conv front-end,
encoder LSTMs and their BN running stats), attention (``attn``) and / or
decoder (``dec``) groups of ``--src``'s latest checkpoint into it, and
save it as ``seq2seq_0.model.npz`` of ``--dst`` with no optimizer state,
so ``cli.train`` there resumes from the transferred weights with a fresh
optimizer.  ``--average`` instead writes the mean of several of
``--src``'s epoch checkpoints, for ``--ckpt`` of ``cli.beam``,
``cli.infer`` and ``cli.export_model``; ``--export-chainer`` writes
``--src``'s latest checkpoint in the reference's Chainer layout (a
``seq2seq_<e>.model`` that the reference and every entry point of this
package load).  The target's groups that are not copied come from the
port's seeded generator, not from JAX's PRNG.
"""

import argparse
import os

import numpy as np

from ast_tpu_torch.checkpoint import (
    average_checkpoints, checkpoint_path, latest_checkpoint,
    list_checkpoints, load_checkpoint, save_checkpoint, transfer_params,
)
from ast_tpu_torch.config import Config
from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.params import torch_device, tree_map
from ast_tpu_torch.train.chainer_import import ast_to_chainer


def _average(src_dir, spec, out):
    """--average: mean of several epoch checkpoints.  spec: 'last:K' or
    'e1,e2,...'."""
    available = dict(list_checkpoints(src_dir))
    if not available:
        raise FileNotFoundError(f"no checkpoints found in {src_dir}")
    if spec.startswith("last:"):
        k = int(spec.split(":", 1)[1])
        if k < 1:
            raise ValueError(f"--average last:K needs K >= 1, got {k}")
        epochs = sorted(available)[-k:]
    else:
        epochs = [int(e) for e in spec.split(",") if e.strip()]
        missing = [e for e in epochs if e not in available]
        if missing:
            raise FileNotFoundError(
                f"epochs {missing} have no checkpoint in {src_dir} "
                f"(available: {sorted(available)})")
    params, state = average_checkpoints([available[e] for e in epochs])
    out = out or os.path.join(
        src_dir, f"seq2seq_avg_{'-'.join(map(str, epochs))}.model.npz")
    save_checkpoint(out, params, state)
    print(f"averaged epochs {epochs} -> {out}")
    print("decode/export from it with --ckpt "
          f"{out} on beam/infer/export_model")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="Transfer param groups")
    parser.add_argument("--src", required=True, help="donor experiment dir")
    parser.add_argument("--dst", help="target experiment dir")
    parser.add_argument("--groups", default="enc",
                        help="comma list of: enc, attn, dec")
    parser.add_argument("--export-chainer", metavar="FILE",
                        help="instead of transferring, write --src's latest "
                             "checkpoint in the reference's Chainer "
                             "save_npz layout (loadable by the reference's "
                             "nn.py:150 serializers.load_npz)")
    parser.add_argument("--average", metavar="SPEC",
                        help="instead of transferring, average --src epoch "
                             "checkpoints ('last:K' or 'e1,e2,...') into "
                             "one decode-time model (use via --ckpt)")
    parser.add_argument("--out", default=None,
                        help="output path for --average")
    parser.add_argument("--device", default="cuda",
                        help="torch device the target model is built on "
                             "(default cuda)")
    args = parser.parse_args(argv)

    if args.average:
        return _average(args.src, args.average, args.out)

    groups = tuple(g.strip() for g in args.groups.split(",") if g.strip())

    src_ckpt, src_epoch = latest_checkpoint(args.src)
    if src_ckpt is None:
        raise FileNotFoundError(f"no checkpoint found in {args.src}")
    print(f"donor checkpoint: {src_ckpt} (epoch {src_epoch})")
    src = load_checkpoint(src_ckpt)

    if args.export_chainer:
        arrays = ast_to_chainer(src["params"], src.get("state") or {})
        # an open handle, as Chainer's save_npz: no .npz suffix appended
        with open(args.export_chainer, "wb") as f:
            np.savez_compressed(f, **arrays)
        print(f"exported Chainer-format model: {args.export_chainer} "
              f"({len(arrays)} arrays)")
        return args.export_chainer
    if not args.dst:
        parser.error("--dst is required unless --export-chainer is given")

    dst_cfg = Config(args.dst)
    dst_params, dst_state = (
        tree_map(lambda t: t.detach().cpu().numpy(), tree)
        for tree in seq2seq.init_model(dst_cfg.model, seed=0,
                                       device=torch_device(args.device)))
    new_params, new_state = transfer_params(
        src["params"], dst_params, groups=groups,
        src_state=src.get("state"), dst_state=dst_state)

    # the reference verifies the copied arrays (copy_params.py:61-65)
    ok = np.allclose(np.asarray(new_params["cnn"][0]["w"]),
                     np.asarray(src["params"]["cnn"][0]["w"]))
    print(f"encoder conv weights match donor: {ok}")

    out = checkpoint_path(args.dst, 0)
    save_checkpoint(out, new_params, new_state)
    print(f"saved transferred model: {out}")
    return out


if __name__ == "__main__":
    main()
