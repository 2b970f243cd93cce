"""LSTM gate math on packed pre-activations, gate order [i, f, g, o]
(the counterpart of ``ast_tpu/ops/lstm.py`` ``lstm_gates``), its
backward as the fused kernels' bodies write it (``ast_tpu/ops/
fused_lstm.py`` ``_bwd_kernel``), and the scan path's per-layer output
transforms: inverted hash dropout and LayerNorm (``ast_tpu/models/
seq2seq.py`` ``_layernorm``)."""

import torch


def lstm_gate_acts(z, c, hidden):
    """As :func:`lstm_gates`, also returning the post-activation gates
    ``[i|f|g|o]`` (..., 4H) that a backward pass keeps.
    Returns (acts, h_new, c_new)."""
    i = torch.sigmoid(z[..., :hidden])
    f = torch.sigmoid(z[..., hidden:2 * hidden])
    g = torch.tanh(z[..., 2 * hidden:3 * hidden])
    o = torch.sigmoid(z[..., 3 * hidden:])
    c_new = f * c + i * g
    return torch.cat([i, f, g, o], dim=-1), o * torch.tanh(c_new), c_new


def lstm_gates_backward(acts, c_new, c_prev, dh, dc_in):
    """Backward of one LSTM cell from its kept gates: ``dh`` and the
    carried ``dc_in`` at the outputs -> (dz (..., 4H) at the
    pre-activations, dc at c_prev)."""
    i, f, g, o = acts.chunk(4, dim=-1)
    tanh_c = torch.tanh(c_new)
    do = dh * tanh_c
    dc = dc_in + dh * o * (1.0 - tanh_c * tanh_c)
    dz = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                    dc * i * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
    return dz, dc * f


def lstm_gates(z, c, hidden):
    """z: (..., 4H) pre-activations, c: (..., H) -> (h_new, c_new)."""
    return lstm_gate_acts(z, c, hidden)[1:]


def layernorm(x, g, b, eps=1e-6):
    """LayerNorm over the last axis with population variance, eps 1e-6
    (``ast_tpu``'s ``_layernorm``)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def dropout(x, keep, rate):
    """Inverted dropout with a given keep-mask (``ops.dropout.drop_mask``):
    kept values divided by ``1 - rate``, the others 0."""
    return torch.where(keep, x / (1.0 - rate), 0.0)
