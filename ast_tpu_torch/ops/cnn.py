"""Conv front-end: Conv2D (no bias) -> BatchNorm -> ReLU (or leaky ReLU)
-> optional max pooling over time, layer by layer.

The counterpart of ``ast_tpu/ops/cnn.py``.  The shipped layer family
(layer 0 collapses the feature axis, later layers are 1-D over time)
runs in its im2col form (``_conv_frontend_matmul``): each layer a window
gather of ``kh`` strided time slices followed by one ``(B*T',
kh*C_in) @ (kh*C_in, C_out)`` matmul.  Any other stack, or
``force_nchw``, runs the general NCHW convolution (``F.conv2d`` with
stride, padding and dilation), as ``ast_tpu`` runs ``lax.conv``.  In
eval mode BatchNorm (eps 2e-5) uses the running statistics; in train
mode the batch statistics over every row and time step (padding
included, population variance), and the running statistics move with
decay 0.9.  Max pooling is ``lax.reduce_window``'s "SAME": ceil(T /
stride) outputs, the input padded with -inf, ``total // 2`` frames
before.  Weights stay OIHW.  This stage is plain PyTorch with autograd
on every device: it has no Pallas counterpart on the TPU either.
"""

import torch
import torch.nn.functional as F

BN_DECAY = 0.9
BN_EPS = 2e-5
# jax.nn.leaky_relu's default slope
LEAKY_SLOPE = 0.01


def im2col_eligible(cnn_config, in_dim):
    """The shipped conv-stack family: layer 0 collapses the feature axis
    (kw == sw == in_dim, pw == 0), later layers are 1-D over time."""
    layers = cnn_config["cnn_layers"]
    if not layers:
        return False
    l0 = layers[0]
    if (l0["ksize"][1] != in_dim or l0["stride"][1] != in_dim
            or l0["pad"][1] != 0 or l0.get("dilate", 1) != 1):
        return False
    return all(l["ksize"][1] == 1 and l["stride"][1] == 1
               and l["pad"][1] == 0 and l.get("dilate", 1) == 1
               for l in layers[1:])


def _batchnorm(p, s, h, axes, shape, train):
    """BatchNorm over ``axes`` of ``h``, the per-channel vectors viewed
    as ``shape``.  Returns (h, the new state)."""
    if train:
        mean = h.mean(dim=axes)
        var = h.var(dim=axes, correction=0)
        s = {"bn_mean": (BN_DECAY * s["bn_mean"]
                         + (1 - BN_DECAY) * mean).detach(),
             "bn_var": (BN_DECAY * s["bn_var"]
                        + (1 - BN_DECAY) * var).detach()}
    else:
        mean, var = s["bn_mean"], s["bn_var"]
    h = (h - mean.view(shape)) * torch.rsqrt(var + BN_EPS).view(shape)
    return h * p["bn_gamma"].view(shape) + p["bn_beta"].view(shape), s


def _max_pool_same(h, dim, k, stride):
    """``lax.reduce_window(max, "SAME")`` over axis ``dim`` of a 4-D
    tensor: the axis padded with -inf, ``total // 2`` before."""
    n = h.shape[dim]
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    pad = [0] * 4
    pad[2 * (3 - dim)] = total // 2
    pad[2 * (3 - dim) + 1] = total - total // 2
    h = F.pad(h, pad, value=-float("inf"))
    ks, ss = [1, 1], [1, 1]
    ks[dim - 2], ss[dim - 2] = k, stride
    return F.max_pool2d(h, ks, ss)


def _activate(h, layer):
    if layer.get("leaky_relu", False):
        return F.leaky_relu(h, LEAKY_SLOPE)
    return torch.relu(h)


def _conv_frontend_matmul(params, state, cnn_config, X, train):
    h = X
    new_state = []
    for i, (p, s, layer) in enumerate(zip(params, state,
                                          cnn_config["cnn_layers"])):
        kh, sh, ph = layer["ksize"][0], layer["stride"][0], layer["pad"][0]
        if ph:
            h = F.pad(h, (0, 0, ph, ph))
        T_out = (h.shape[1] - kh) // sh + 1
        win = torch.cat([h[:, k:k + sh * (T_out - 1) + 1:sh]
                         for k in range(kh)], dim=-1)   # (B, T', kh*C_in)
        w = p["w"]                                      # (C_out, C_in, kh, kw)
        if i == 0:
            w2 = w[:, 0].permute(1, 2, 0).reshape(-1, w.shape[0])
        else:
            w2 = w[..., 0].permute(2, 1, 0).reshape(-1, w.shape[0])
        out = torch.matmul(win, w2)
        if "bn_gamma" in p:
            out, s = _batchnorm(p, s, out, (0, 1), (-1,), train)
        else:
            out = out + p["b"]
        new_state.append(s)
        h = _activate(out, layer)
        if layer.get("max_pool"):
            pk, pstr = layer["max_pool"]
            h = _max_pool_same(h[:, None], 2, pk, pstr)[:, 0]
    return h, new_state


def _conv_frontend_nchw(params, state, cnn_config, X, train):
    h = X[:, None]                                      # (B, 1, T, D)
    new_state = []
    for p, s, layer in zip(params, state, cnn_config["cnn_layers"]):
        dil = layer.get("dilate", 1)
        h = F.conv2d(h, p["w"], stride=tuple(layer["stride"]),
                     padding=tuple(layer["pad"]), dilation=(dil, dil))
        if "bn_gamma" in p:
            h, s = _batchnorm(p, s, h, (0, 2, 3), (1, -1, 1, 1), train)
        else:
            h = h + p["b"].view(1, -1, 1, 1)
        new_state.append(s)
        h = _activate(h, layer)
        if layer.get("max_pool"):
            pk, pstr = layer["max_pool"]
            h = _max_pool_same(h, 2, pk, pstr)
    B, C, Tp, Wp = h.shape
    return h.transpose(1, 2).reshape(B, Tp, C * Wp), new_state


def conv_frontend(params, state, cnn_config, X, train=False):
    """X: (B, T, D) float32 -> ((B, T', C_out * W'), new BN state).  The
    new state is the old one in eval mode; in train mode it holds the
    moved running statistics (detached: they take no gradient)."""
    if (im2col_eligible(cnn_config, X.shape[-1])
            and not cnn_config.get("force_nchw", False)):
        return _conv_frontend_matmul(params, state, cnn_config, X, train)
    return _conv_frontend_nchw(params, state, cnn_config, X, train)


def conv_out_len(cnn_config, t):
    """Output time length for input length ``t`` under the conv stack."""
    for layer in cnn_config["cnn_layers"]:
        kh = (layer["ksize"][0] - 1) * layer.get("dilate", 1) + 1
        t = (t + 2 * layer["pad"][0] - kh) // layer["stride"][0] + 1
        if layer.get("max_pool", None):
            t = -(-t // layer["max_pool"][1])
    return t
