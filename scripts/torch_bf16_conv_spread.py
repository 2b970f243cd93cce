#!/usr/bin/env python3
"""Where the conv front-end's bf16 gradients part between float32 and
float64 sums, tensor by tensor, on one device.

    python3 scripts/torch_bf16_conv_spread.py [cpu|cuda]

The front-end of es_en_20h (two im2col layers, 128 and 512 channels,
batch-statistics BN and ReLU) on ``chip_smoke.py``'s phase-12 batch (8
rows of 640 frames with its speech noise, seeded weights) at
``compute_dtype`` bfloat16, in float32 and in float64 with the same
rounding points (the bf16 function with its sums taken exactly), under a
seeded cotangent of its output: for each tensor (each layer's rounded
window, product, normalised and activated output, their gradients, the
weights' gradients) the largest difference over the float64 value's
max and how many elements differ, then the five elements of layer 1's
product gradient that differ most, with their normalised values on
both sides of ReLU's kink.  Runs on the CPU or on the card (the default
when there is one).
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ast_tpu_torch.models import seq2seq  # noqa: E402
from ast_tpu_torch.ops import cnn  # noqa: E402

BF = torch.bfloat16


def frontend(params, cnn_config, X, cot, dtype, dev):
    """The im2col front-end at bf16 in ``dtype`` (``ops.cnn``'s
    ``_conv_frontend_matmul`` in train mode, written out so that every
    tensor is kept): {name: tensor on the CPU in float64}."""
    keep, grads_of = {}, {}
    h = X.to(dev, dtype)
    ws = []
    for i, layer in enumerate(cnn_config["cnn_layers"]):
        p = params[i]
        w = p["w"].detach().to(dev, dtype).requires_grad_(True)
        ws.append(w)
        kh, sh, ph = layer["ksize"][0], layer["stride"][0], layer["pad"][0]
        h = F.pad(h, (0, 0, ph, ph))
        T_out = (h.shape[1] - kh) // sh + 1
        win = torch.cat([h[:, k:k + sh * (T_out - 1) + 1:sh]
                         for k in range(kh)], dim=-1)
        w2 = (w[:, 0].permute(1, 2, 0) if i == 0
              else w[..., 0].permute(2, 1, 0)).reshape(-1, w.shape[0])
        win_r = win.to(BF).to(dtype)
        w2_r = w2.contiguous().to(BF).to(dtype)
        out = torch.matmul(win_r, w2_r)
        mean, var = out.mean(dim=(0, 1)), out.var(dim=(0, 1), correction=0)
        hn = ((out - mean) * torch.rsqrt(var + cnn.BN_EPS)
              * p["bn_gamma"].to(dev, dtype) + p["bn_beta"].to(dev, dtype))
        h = torch.relu(hn)
        keep.update({f"win{i}": win_r, f"out{i}": out, f"hn{i}": hn,
                     f"h{i}": h})
        grads_of.update({f"d_out{i}": out, f"d_w2_{i}": w2_r})
    names = [f"d_w{i}" for i in range(len(ws))] + list(grads_of)
    gs = torch.autograd.grad(h, ws + list(grads_of.values()),
                             cot.to(dev, dtype))
    keep.update(zip(names, gs))
    return {k: v.detach().cpu().double() for k, v in keep.items()}


def main():
    dev = torch.device(sys.argv[1] if len(sys.argv) > 1 else
                       "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(HERE, "experiments/es_en_20h/model_cfg.json")) as f:
        mcfg = json.load(f)
    mcfg["rnn_config"]["dec_vocab_size"] = cs.VOCAB
    params = seq2seq.init_model(mcfg, seed=0)[0]
    X, _, draws = cs.variant_inputs(mcfg, "cpu")
    X = X * (1.0 + draws.noise)
    C = mcfg["cnn_config"]["cnn_layers"][-1]["out_channels"]
    cot = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (X.shape[0], cnn.conv_out_len(mcfg["cnn_config"], X.shape[1]), C))
        .astype(np.float32))
    a = frontend(params["cnn"], mcfg["cnn_config"], X, cot, torch.float32,
                 dev)
    b = frontend(params["cnn"], mcfg["cnn_config"], X, cot, torch.float64,
                 dev)
    print(f"{dev} ({torch.cuda.get_device_name(0) if dev.type == 'cuda' else 'CPU'})")
    for k in a:
        d = (a[k] - b[k]).abs()
        print(f"  {k:8s} {tuple(a[k].shape)}: float32 against float64 "
              f"{float(d.max() / b[k].abs().max()):.3e} of max, "
              f"{int((d > 0).sum())} of {d.numel()} elements apart")
    d = (a["d_out1"] - b["d_out1"]).abs().flatten()
    for j in torch.topk(d, 5).indices.tolist():
        idx = tuple(int(i) for i in np.unravel_index(j, a["d_out1"].shape))
        print(f"  d_out1{idx}: float32 {float(a['d_out1'].flatten()[j]):.6f}"
              f", float64 {float(b['d_out1'].flatten()[j]):.6f}; normalised"
              f" {float(a['hn1'].flatten()[j]):.3e} / "
              f"{float(b['hn1'].flatten()[j]):.3e}")


if __name__ == "__main__":
    main()
