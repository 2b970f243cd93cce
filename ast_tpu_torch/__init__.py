"""ast_tpu_torch — the PyTorch + CUDA (Hopper) port of ast_tpu's serving
and training paths.

Serving: loose audio (WAV, SPHERE, ``.npy``; MFCC + CMVN on the device)
or ``(T, 13)`` feature files go through the conv front-end, the fused
biLSTM encoder and fused greedy or beam decoding, and come out as text
(``python -m ast_tpu_torch.cli.infer``); ``cli.export_model`` writes a
serving directory that ``cli.serve`` answers HTTP requests from.  Training: bucketed
batches go through the same front-end and encoder in train mode, the
fused scheduled-sampling decoder, a CE loss, their fused backwards and
AMSGrad, epoch by epoch with greedy dev BLEU
(``python -m ast_tpu_torch.cli.train``).  Transfer: ``cli.copy_params``
copies a donor's encoder / attention / decoder into a new experiment,
averages checkpoints or writes the reference's Chainer format, and
``eval.wer`` scores an ASR side.  Every Pallas kernel on those
paths is a hand-written CUDA kernel here (``kernels/csrc``); each sits
beside a plain PyTorch version that CPU tensors take.

The JAX package ``ast_tpu`` is the reference this port is tested
against.  The port imports neither JAX nor any module of ``ast_tpu``: it
keeps its own copies of what it shares with it (``config``, ``symbols``,
``eval.bleu``, ``eval.wer``, ``eval.metrics``, ``train.chainer_import``),
so an experiment directory, a reference Chainer checkpoint included,
means the same to both.
Parameters, BN state and optimizer state keep ast_tpu's layout
and its flat-NPZ checkpoint format, so weights and runs move both ways.
"""

from ast_tpu_torch.config import Config
from ast_tpu_torch.symbols import SYMBOLS

__version__ = "0.1.0"

__all__ = ["Config", "SYMBOLS", "__version__"]
