"""The FLOPs of the model's matrix products that a step or a decode
needs, counted from its shapes: the numerator of ``mfu.*``.

The port has no such count to copy; this one is written from the
model's equations and uses ``kernel_cost``'s terms for the recurrences
(2 FLOPs a multiply-add).  Elementwise work (gates, softmax, BatchNorm,
dropout, top-K) is left out.  Training counts the forward products
three times (the forward and the two products of each in the backward);
recomputation and the products an implementation adds (the training
decoder's argmax logits, the embedding gradient as a one-hot product)
are not counted.
"""


def _dims(mcfg, V):
    rnn = mcfg["rnn_config"]
    return dict(H=rnn["hidden_units"], E=rnn["embedding_units"],
                A=rnn["attn_units"], Le=rnn["enc_layers"],
                Ld=rnn["dec_layers"], V=V, D2=2 if rnn["bi_rnn"] else 1)


def encoder_flops(mcfg, B, T):
    """(FLOPs of the conv front-end and the encoder at B rows of T frames,
    the encoder's length T')."""
    d = _dims(mcfg, 0)
    flops, in_ch, t = 0, 1, T
    for i, layer in enumerate(mcfg["cnn_config"]["cnn_layers"]):
        (kh, kw), o = layer["ksize"], layer["out_channels"]
        t = (t + 2 * layer["pad"][0] - kh) // layer["stride"][0] + 1
        k = kh * kw if i == 0 else kh * in_ch
        flops += 2 * B * t * k * o
        in_ch = o
    He = d["H"] // d["D2"]
    # the layer-0 projection, then h @ wh of every layer and x @ wx above
    flops += 2 * t * d["D2"] * B * in_ch * 4 * He
    flops += 2 * t * d["D2"] * B * 4 * He * He * (2 * d["Le"] - 1)
    return flops, t


def step_cell_flops(mcfg, V, T):
    """FLOPs of one decoder step for one row over T' encoder states: the
    LSTM cell, attention and the logits."""
    d = _dims(mcfg, V)
    H, E, A, L = d["H"], d["E"], d["A"], d["Ld"]
    cell = 4 * H * (E + A + H) + (L - 1) * 4 * H * 2 * H
    attn = H * H + 2 * T * H + 2 * H * A
    return 2 * (cell + attn + A * V)


def train_step_flops(mcfg, V, B, T, U):
    """Model FLOPs of one training step of B rows, T frames, U target
    columns (U - 1 decoder steps): three times the forward's."""
    enc, Tp = encoder_flops(mcfg, B, T)
    return 3 * (enc + B * (U - 1) * step_cell_flops(mcfg, V, Tp))


def beam_flops(mcfg, V, B, T, N, steps):
    """Model FLOPs of a beam decode of B rows, T frames, N hypotheses a
    row, ``steps`` decoder steps."""
    enc, Tp = encoder_flops(mcfg, B, T)
    return enc + B * N * steps * step_cell_flops(mcfg, V, Tp)
