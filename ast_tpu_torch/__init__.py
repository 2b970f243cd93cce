"""ast_tpu_torch — the PyTorch + CUDA (Hopper) port of ast_tpu's serving path.

Loose ``(T, 13)`` feature files go through the conv front-end, the fused
biLSTM encoder and fused greedy or beam decoding, and come out as text
(``python -m ast_tpu_torch.cli.infer``).  Every Pallas kernel on that
path is a hand-written CUDA kernel here (``kernels/csrc``); each sits
beside a plain PyTorch version that CPU tensors take.

The JAX package ``ast_tpu`` is the reference this port is tested
against.  The port never imports JAX: of ``ast_tpu`` it uses only the
two JAX-free modules ``ast_tpu.symbols`` and ``ast_tpu.config``, so an
experiment directory means the same to both.  Parameters keep ast_tpu's
layout and its flat-NPZ checkpoint format, so weights move both ways.
"""

from ast_tpu.config import Config
from ast_tpu.symbols import SYMBOLS

__version__ = "0.1.0"

__all__ = ["Config", "SYMBOLS", "__version__"]
