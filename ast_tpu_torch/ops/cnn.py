"""Conv front-end in its im2col form.

The counterpart of ``ast_tpu/ops/cnn.py`` ``_conv_frontend_matmul``:
each layer is a window gather of ``kh`` strided time slices followed by
one ``(B*T', kh*C_in) @ (kh*C_in, C_out)`` matmul, then BatchNorm (eps
2e-5) and ReLU.  In eval mode BatchNorm uses the running statistics; in
train mode the batch statistics over all ``B*T'`` rows (padding
included, population variance), and the running statistics move with
decay 0.9.  Weights stay OIHW.  This stage is plain PyTorch with
autograd: it has no Pallas counterpart on the TPU either.
"""

import torch

BN_DECAY = 0.9
BN_EPS = 2e-5


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


def conv_frontend(params, state, cnn_config, X, train=False):
    """X: (B, T, D) float32 -> ((B, T', C_out), new BN state).  The new
    state is the old one in eval mode; in train mode it holds the moved
    running statistics (detached: they take no gradient)."""
    if not im2col_eligible(cnn_config, X.shape[-1]):
        raise NotImplementedError(
            "conv front-end: only the im2col-eligible layer family "
            "(feature axis collapsed by layer 0, 1-D later layers) is "
            "ported")
    h = X
    new_state = []
    for i, (p, s, layer) in enumerate(zip(params, state,
                                          cnn_config["cnn_layers"])):
        if layer.get("max_pool") or layer.get("leaky_relu"):
            raise NotImplementedError(
                "conv front-end: max_pool / leaky_relu layers are not "
                "ported")
        kh, sh, ph = layer["ksize"][0], layer["stride"][0], layer["pad"][0]
        if ph:
            h = torch.nn.functional.pad(h, (0, 0, ph, ph))
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
            if train:
                mean = out.mean(dim=(0, 1))
                var = out.var(dim=(0, 1), correction=0)
                s = {"bn_mean": (BN_DECAY * s["bn_mean"]
                                 + (1 - BN_DECAY) * mean).detach(),
                     "bn_var": (BN_DECAY * s["bn_var"]
                                + (1 - BN_DECAY) * var).detach()}
            else:
                mean, var = s["bn_mean"], s["bn_var"]
            out = (out - mean) * torch.rsqrt(var + BN_EPS)
            out = out * p["bn_gamma"] + p["bn_beta"]
        else:
            out = out + p["b"]
        new_state.append(s)
        h = torch.relu(out)
    return h, new_state


def conv_out_len(cnn_config, t):
    """Output time length for input length ``t`` under the conv stack."""
    for layer in cnn_config["cnn_layers"]:
        kh = (layer["ksize"][0] - 1) * layer.get("dilate", 1) + 1
        t = (t + 2 * layer["pad"][0] - kh) // layer["stride"][0] + 1
        if layer.get("max_pool", None):
            t = -(-t // layer["max_pool"][1])
    return t
