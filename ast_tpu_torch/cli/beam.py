"""Beam-decode a split of an experiment on a GPU.

``python -m ast_tpu_torch.cli.beam -m <exp_dir> -n N -k K -s <set> -w W
[--resume] [--ckpt F] [--device cuda|cpu] [--dist-backend nccl|gloo]``

``torchrun --nproc-per-node N -m ast_tpu_torch.cli.beam ...`` decodes
over the experiment's ``parallel`` mesh (its data axis and vocab
``model_axis``), one process a card, as ``cli.train`` runs it
(``cli.train.launch``): every rank decodes its rows and holds the whole
split's beams; rank 0 alone writes the pickle and the ``.en`` file.

The counterpart of ``ast_tpu/cli/beam.py``: the split's beams (K1 eval
and K6, batched) are pickled to ``<set>_beam_N-<n>_K-<k>.p`` as plain
lists and floats -- ``--resume`` reuses the pickle, and either package
reads the other's --, reranked by ``score / (len - 2)^W``, scored with
BLEU against the references and written to
``<set>_beam_N-<n>_K-<k>_W-<w>.en``.  ``--ckpt`` decodes that checkpoint
file instead of the latest epoch's and tags both files with its name.
On ``--device cuda`` every kernel of the path is a hand-written CUDA
kernel; ``--device cpu`` runs their plain versions.  ``--save-attn``
pickles each hypothesis's attention history too, (hyp, score,
history), as ``ast_tpu`` does; its frontier loop is the plain one on
either device, as in ``ast_tpu``.
"""

import argparse
import os
import pickle

import torch

from ast_tpu_torch.cli.train import launch
from ast_tpu_torch.eval.bleu import Eval
from ast_tpu_torch.ops.beam import get_best_hyps
from ast_tpu_torch.train.trainer import NN


def main(argv=None):
    parser = argparse.ArgumentParser(description="Beam search decode")
    parser.add_argument("-m", "--cfg_path", required=True)
    parser.add_argument("-n", "--N", required=True, help="number of hyps")
    parser.add_argument("-k", "--K", required=True, help="expansion width")
    parser.add_argument("-s", "--S", required=True, help="dev/dev2/test")
    parser.add_argument("-w", "--W", required=True, help="len norm weight")
    parser.add_argument("--resume", action="store_true",
                        help="reuse pickled beam results")
    parser.add_argument("--ckpt", default=None,
                        help="decode from this checkpoint file instead "
                             "of the latest epoch")
    parser.add_argument("--save-attn", action="store_true",
                        help="pickle per-hypothesis attention history "
                             "alongside (hyp, score), as the reference "
                             "beam entries do")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda, under torchrun "
                             "cuda:LOCAL_RANK; cpu runs the plain PyTorch "
                             "versions of the kernels)")
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"),
                        default=None,
                        help="torch.distributed backend of a multi-process "
                             "run (default nccl on CUDA, gloo on the CPU)")
    args = parser.parse_args(argv)
    device = launch(args.device, args.dist_backend)
    try:
        bleu = run(args, device)
        if torch.distributed.is_initialized():
            torch.distributed.barrier()     # no rank leaves mid-exchange
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return bleu


def run(args, device):
    """Decode, pickle, rerank and score ``args``' split on ``device``;
    returns the BLEU."""
    cfg_path = args.cfg_path
    N, K, W = int(args.N), int(args.K), float(args.W)
    set_key = args.S

    nn = NN(cfg_path, device, ckpt=args.ckpt)
    refs_path = os.path.join(nn.cfg.train["data"]["refs_path"], set_key)
    metrics = Eval(refs_path, nn.cfg.train["data"]["n_evals"])

    # keyed by the checkpoint's name under --ckpt, so --resume never
    # serves another model's beams and the latest epoch's stay
    tag = ""
    if args.ckpt:
        tag = "_ckpt-" + os.path.splitext(os.path.basename(args.ckpt))[0]
    beam_path = os.path.join(cfg_path, f"{set_key}_beam_N-{N}_K-{K}{tag}.p")
    if args.resume and os.path.exists(beam_path):
        print("Loading saved beam results")
        with open(beam_path, "rb") as f:
            beam = pickle.load(f)
    else:
        print("Computing beam results (batched on device)")
        beam = nn.decode_beam_set(set_key, N=N, K=K,
                                  save_attn=args.save_attn)
        if nn.primary:
            with open(beam_path, "wb") as f:
                pickle.dump(beam, f)

    preds = get_best_hyps(beam, W)
    hyps = nn.data_loader.get_hyps(preds.items())
    bleu = metrics.calc_bleu(hyps) * 100
    print(f"BLEU = {bleu:.2f}")

    out_fname = os.path.join(
        cfg_path, f"{set_key}_beam_N-{N}_K-{K}_W-{W:.2f}{tag}.en")
    if nn.primary:
        metrics.write_to_file(hyps, out_fname)
        print(f"Predictions written to: {out_fname}")
    return bleu


if __name__ == "__main__":
    main()
