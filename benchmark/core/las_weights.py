"""LAS-6-1280's weights, made on the device from ``--seed``
(``benchmark/core/weights.py``'s recipe at this model's shapes).

One ``torch.Generator`` on the device draws every weight in one call of
N(0, 1) numbers, which are then scaled leaf by leaf: He-normal conv
kernels over the input planes, LSTM input weights at the Glorot-uniform
variance, recurrent weights at the variance of an orthogonal matrix's
entries, forget-gate biases 1, LeCun-normal attention and output layers,
N(0, 1) embeddings, BatchNorm scale 1 and shift 0, other biases 0.  The
layout is the program's parameter tree flattened to ``path -> tensor``,
which the reference (``reference/las_model.py``) reads: the listener's
layer l reads the conv output's channels x bins (l = 0) or both
directions of the layer below, the attention maps the speller's H to the
listener's He = 2 ``enc_units``, the context layer reads [cv; h].
"""

import torch


def conv_out(cnn):
    """(channels, the width it leaves: channels x bins) of the conv
    stack over ``plane_bins`` bins."""
    w = int(cnn["plane_bins"])
    for layer in cnn["cnn_layers"]:
        kw, sw, pw = layer["ksize"][1], layer["stride"][1], layer["pad"][1]
        w = (w + 2 * pw - kw) // sw + 1
    o = cnn["cnn_layers"][-1]["out_channels"]
    return o, o * w


def specs(mcfg, V):
    """[(path, shape, std or a constant name)] of the configuration's
    weights."""
    rnn, cnn = mcfg["rnn_config"], mcfg["cnn_config"]
    H, E, A = rnn["hidden_units"], rnn["embedding_units"], rnn["attn_units"]
    w = rnn["enc_units"]
    He = 2 * w
    out = []
    in_ch = int(cnn["cnn_layers"][0].get("in_channels") or 1)
    for i, layer in enumerate(cnn["cnn_layers"]):
        o, (kh, kw) = layer["out_channels"], layer["ksize"]
        out += [(f"cnn/{i}/w", (o, in_ch, kh, kw),
                 (2.0 / (in_ch * kh * kw)) ** 0.5),
                (f"cnn/{i}/bn_gamma", (o,), "ones"),
                (f"cnn/{i}/bn_beta", (o,), "zeros")]
        in_ch = o
    for l in range(rnn["enc_layers"]):
        n_in = conv_out(cnn)[1] if l == 0 else He
        out += [(f"enc/lstm/{l}/wx", (2, n_in, 4 * w),
                 (2.0 / (n_in + 4 * w)) ** 0.5),
                (f"enc/lstm/{l}/wh", (2, w, 4 * w), (4 * w) ** -0.5),
                (f"enc/lstm/{l}/b", (2, 4 * w), "forget")]
    out += [("attn/wa/0/w", (H, He), H ** -0.5),
            ("attn/wa/0/b", (He,), "zeros"),
            ("attn/context/w", (He + H, A), (He + H) ** -0.5),
            ("attn/context/b", (A,), "zeros"),
            ("dec/embed", (V, E), 1.0)]
    for l in range(rnn["dec_layers"]):
        n_in = E + A if l == 0 else H
        out += [(f"dec/lstm/{l}/wx", (n_in, 4 * H),
                 (2.0 / (n_in + 4 * H)) ** 0.5),
                (f"dec/lstm/{l}/wh", (H, 4 * H), (4 * H) ** -0.5),
                (f"dec/lstm/{l}/b", (4 * H,), "forget")]
    out += [("dec/out_w", (A, V), A ** -0.5), ("dec/out_b", (V,), "zeros")]
    return out


def make_weights(mcfg, V, seed, device):
    """The flat weights of ``seed`` on ``device``, float32."""
    sp = specs(mcfg, V)
    sizes = [torch.Size(shape).numel() if not isinstance(std, str) else 0
             for _, shape, std in sp]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    draws = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (path, shape, std), n in zip(sp, sizes):
        if std == "ones":
            out[path] = torch.ones(shape, device=device)
        elif std == "zeros":
            out[path] = torch.zeros(shape, device=device)
        elif std == "forget":
            b = torch.zeros(shape, device=device)
            h = shape[-1] // 4
            b[..., h:2 * h] = 1.0
            out[path] = b
        else:
            out[path] = draws[at:at + n].view(shape) * std
            at += n
    return out
