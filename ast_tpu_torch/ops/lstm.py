"""LSTM gate math on packed pre-activations, gate order [i, f, g, o]
(the counterpart of ``ast_tpu/ops/lstm.py`` ``lstm_gates``)."""

import torch


def lstm_gates(z, c, hidden):
    """z: (..., 4H) pre-activations, c: (..., H) -> (h_new, c_new)."""
    i = torch.sigmoid(z[..., :hidden])
    f = torch.sigmoid(z[..., hidden:2 * hidden])
    g = torch.tanh(z[..., 2 * hidden:3 * hidden])
    o = torch.sigmoid(z[..., 3 * hidden:])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new
