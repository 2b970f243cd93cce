"""The model's weights, made on the device from ``--seed``.

One ``torch.Generator`` on the device draws every weight in one call of
N(0, 1) numbers, which are then scaled leaf by leaf: He-normal conv
kernels, LSTM input weights at the Glorot-uniform variance, recurrent
weights at the variance of an orthogonal matrix's entries, forget-gate
biases 1, LeCun-normal attention and output layers, N(0, 1)
embeddings, BatchNorm scale 1 and shift 0, other biases 0.  The layout
is the program's parameter tree, flattened to ``path -> tensor``
(``cnn/0/w``, ``enc/lstm/0/wx``, ...); the reference reads the same
flat dict.
"""

import torch


def specs(mcfg, V):
    """[(path, shape, std or a constant name)] of the configuration's
    weights."""
    rnn, cnn = mcfg["rnn_config"], mcfg["cnn_config"]
    H, E, A = rnn["hidden_units"], rnn["embedding_units"], rnn["attn_units"]
    He = H // 2
    out, in_ch = [], 1
    for i, layer in enumerate(cnn["cnn_layers"]):
        o, (kh, kw) = layer["out_channels"], layer["ksize"]
        out += [(f"cnn/{i}/w", (o, in_ch, kh, kw),
                 (2.0 / (in_ch * kh * kw)) ** 0.5),
                (f"cnn/{i}/bn_gamma", (o,), "ones"),
                (f"cnn/{i}/bn_beta", (o,), "zeros")]
        in_ch = o
    for l in range(rnn["enc_layers"]):
        n_in = in_ch if l == 0 else He
        out += [(f"enc/lstm/{l}/wx", (2, n_in, 4 * He),
                 (2.0 / (n_in + 4 * He)) ** 0.5),
                (f"enc/lstm/{l}/wh", (2, He, 4 * He), (4 * He) ** -0.5),
                (f"enc/lstm/{l}/b", (2, 4 * He), "forget")]
    out += [("attn/wa/0/w", (H, H), H ** -0.5), ("attn/wa/0/b", (H,), "zeros"),
            ("attn/context/w", (2 * H, A), (2 * H) ** -0.5),
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


def flat_leaves(tree, prefix=""):
    """``path -> leaf`` of a nested dict / list tree of tensors."""
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    if items is None:
        return {prefix[:-1]: tree}
    for k, v in items:
        out.update(flat_leaves(v, f"{prefix}{k}/"))
    return out


def load_into(tree, flat):
    """Copy ``flat`` into the program's parameter tree, in place; the
    paths and shapes must be the same."""
    leaves = flat_leaves(tree)
    if set(leaves) != set(flat):
        raise ValueError("the program's parameters differ from the "
                         f"benchmark's: {sorted(set(leaves) ^ set(flat))}")
    with torch.no_grad():
        for path, leaf in leaves.items():
            if tuple(leaf.shape) != tuple(flat[path].shape):
                raise ValueError(f"{path}: {tuple(leaf.shape)} in the "
                                 f"program, {tuple(flat[path].shape)} here")
            leaf.copy_(flat[path])
