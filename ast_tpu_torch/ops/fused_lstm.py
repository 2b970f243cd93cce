"""K1: the fused stacked-(bi)LSTM encoder recurrence, inference variant.

The counterpart of ``ast_tpu/ops/fused_lstm.py`` ``fused_stacked_lstm``
with ``train=False``: every layer and direction of the recurrence from
the hoisted layer-0 projection.  A CUDA tensor runs the hand kernel
(``kernels/csrc/k1_encoder.cu``); a CPU tensor runs
:func:`stacked_lstm_reference`, the plain version of the same function
(the encoder ``lax.scan`` of ``ast_tpu/models/seq2seq.py``).

Layout (D2 directions, H units per direction):
  x0_proj (T, D2, B, 4H), wx_rest (L-1, D2, H, 4H), wh (L, D2, H, 4H),
  b (L, D2, 4H)  ->  outs (T, D2, B, H), h_fin / c_fin (L, D2, B, H).
"""

import torch

from ast_tpu_torch.kernels import build
from ast_tpu_torch.ops.lstm import lstm_gates


def pack_encoder_weights(enc_layers):
    """Direction-stacked per-layer dicts -> (wx_rest, wh, b) stacks."""
    wh = torch.stack([l["wh"] for l in enc_layers])
    b = torch.stack([l["b"] for l in enc_layers])
    if len(enc_layers) > 1:
        wx_rest = torch.stack([l["wx"] for l in enc_layers[1:]])
    else:
        wx_rest = wh.new_zeros((0,) + tuple(wh.shape[1:]))
    return wx_rest.contiguous(), wh.contiguous(), b.contiguous()


def stacked_lstm_reference(x0_proj, wx_rest, wh, b):
    """Plain PyTorch recurrence; same contract as :func:`fused_stacked_lstm`."""
    T, D2, B, H4 = x0_proj.shape
    H = H4 // 4
    L = wh.shape[0]
    h = x0_proj.new_zeros((L, D2, B, H))
    c = x0_proj.new_zeros((L, D2, B, H))
    outs = []
    for t in range(T):
        x = None
        new_h, new_c = [], []
        for l in range(L):
            z = x0_proj[t] if l == 0 else torch.bmm(x, wx_rest[l - 1])
            z = z + torch.bmm(h[l], wh[l]) + b[l][:, None, :]
            x, c_l = lstm_gates(z, c[l], H)
            new_h.append(x)
            new_c.append(c_l)
        h, c = torch.stack(new_h), torch.stack(new_c)
        outs.append(x)
    return torch.stack(outs), h, c


def fused_stacked_lstm(x0_proj, wx_rest, wh, b):
    """Encoder recurrence.  Returns (outs, h_fin, c_fin)."""
    if not x0_proj.is_cuda:
        return stacked_lstm_reference(x0_proj, wx_rest, wh, b)
    T, D2, B, H4 = x0_proj.shape
    H = H4 // 4
    L = wh.shape[0]
    build.check_tensor(x0_proj, "x0_proj", (T, D2, B, 4 * H))
    build.check_tensor(wx_rest, "wx_rest", (L - 1, D2, H, 4 * H))
    build.check_tensor(wh, "wh", (L, D2, H, 4 * H))
    build.check_tensor(b, "b", (L, D2, 4 * H))
    dev = x0_proj.device
    outs = torch.empty((T, D2, B, H), device=dev)
    hbuf = torch.zeros((2, L, D2, B, H), device=dev)
    c = torch.zeros((L, D2, B, H), device=dev)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    fused_stacked_lstm.launches += 1
    build.check_launch("k1_encoder_forward", lib.k1_encoder_forward(
        x0_proj.data_ptr(), wx_rest.data_ptr(), wh.data_ptr(), b.data_ptr(),
        outs.data_ptr(), hbuf.data_ptr(), c.data_ptr(),
        T, L, D2, B, H, stream))
    return outs, hbuf[T % 2], c


fused_stacked_lstm.launches = 0
