"""Train an experiment on a GPU.

``python -m ast_tpu_torch.cli.train -m <exp_dir> -e <epochs>
[--device cuda|cpu]``

The counterpart of ``ast_tpu/cli/train.py``, with the same epoch cycle:
train one epoch, append ``epoch, loss`` to ``train.log``, greedy-decode
the dev split, detokenise, score BLEU with ``ast_tpu_torch.eval.bleu.Eval``,
append ``epoch, bleu`` to ``dev.log``, and save
``seq2seq_<epoch>.model.npz`` every ``iters_save`` epochs and at the
last one.  It resumes from the latest checkpoint (``max_epoch + 1``).
On ``--device cuda`` every kernel of the path is a hand-written CUDA
kernel; ``--device cpu`` runs their plain versions.
"""

import argparse
import os

from ast_tpu_torch.eval.bleu import Eval
from ast_tpu_torch.train.trainer import NN


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train and evaluate model")
    parser.add_argument("-m", "--cfg_path", required=True,
                        help="experiment directory")
    parser.add_argument("-e", "--epochs", required=True, type=int,
                        help="number of epochs")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "plain PyTorch versions of the kernels)")
    args = parser.parse_args(argv)
    print(f"number of epochs={args.epochs:d}")

    nn = NN(args.cfg_path, args.device)
    tcfg = nn.cfg.train
    train_key, dev_key = tcfg["train_set"], tcfg["dev_set"]
    metrics = Eval(os.path.join(tcfg["data"]["refs_path"], dev_key),
                   tcfg["data"]["n_evals"])

    start_epoch = nn.max_epoch + 1
    max_epoch = start_epoch + args.epochs
    for epoch in range(start_epoch, max_epoch):
        print("-" * 80)
        print(f"Experiment: {args.cfg_path:s} epoch: {epoch:d}")
        print("-" * 80)
        loss = nn.train_epoch(train_key, epoch=epoch)
        with open(nn.train_log, mode="a") as f:
            f.write(f"{epoch:d}, {loss:.4f}\n")
        hyps = nn.data_loader.get_hyps(nn.predict(dev_key))
        bleu = metrics.calc_bleu(hyps) * 100
        with open(nn.dev_log, mode="a") as f:
            f.write(f"{epoch:d}, {bleu:.2f}\n")
        print(f"BLEU = {bleu:.2f}")
        print(f"train throughput = {nn.timer.items_per_sec:.1f} utts/sec")
        nn.timer.reset()
        print("-" * 80)
        if epoch % tcfg["iters_save"] == 0 or epoch == max_epoch - 1:
            print("Saving model")
            nn.save(epoch)
            print("Finished saving model")


if __name__ == "__main__":
    main()
