"""The FLOPs of LAS-6-1280's matrix products that a training step needs,
counted from its shapes: the numerator of ``mfu.train`` in its cell.

``model_flops`` counts a direction-stacked encoder whose states are as
wide as the decoder; here the listener's layers above 0 read both
directions of the layer below (2 w inputs), the attention maps the
speller's H to the listener's He = 2 w, and the conv front-end is 2-D
over the input planes.  The terms are ``model_flops``': 2 FLOPs a
multiply-add, the forward's products counted three times for a training
step, elementwise work and the products an implementation adds (the
training decoder's argmax logits) left out.
"""


def encoder_flops(mcfg, B, T):
    """(FLOPs of the conv front-end and the listener at B rows of T
    frames, the listener's length T')."""
    rnn, cnn = mcfg["rnn_config"], mcfg["cnn_config"]
    flops, t = 0, T
    w = int(cnn["plane_bins"])
    c = int(cnn["cnn_layers"][0].get("in_channels") or 1)
    for layer in cnn["cnn_layers"]:
        (kh, kw), o = layer["ksize"], layer["out_channels"]
        t = (t + 2 * layer["pad"][0] - kh) // layer["stride"][0] + 1
        w = (w + 2 * layer["pad"][1] - kw) // layer["stride"][1] + 1
        flops += 2 * B * t * w * c * kh * kw * o
        c = o
    u, D2 = rnn["enc_units"], 2 if rnn["bi_rnn"] else 1
    n_in = c * w
    for _ in range(rnn["enc_layers"]):
        flops += 2 * t * D2 * B * (n_in + u) * 4 * u
        n_in = D2 * u
    return flops, t


def step_cell_flops(mcfg, V, T):
    """FLOPs of one speller step for one row over T' listener states: the
    LSTM cells, attention and the logits."""
    rnn = mcfg["rnn_config"]
    H, E, A, L = (rnn["hidden_units"], rnn["embedding_units"],
                  rnn["attn_units"], rnn["dec_layers"])
    He = (2 if rnn["bi_rnn"] else 1) * rnn["enc_units"]
    cell = 4 * H * (E + A + H) + (L - 1) * 4 * H * 2 * H
    attn = H * He + 2 * T * He + (He + H) * A
    return 2 * (cell + attn + A * V)


def train_step_flops(mcfg, V, B, T, U):
    """Model FLOPs of one training step of B rows, T frames, U target
    columns (U - 1 speller steps): three times the forward's."""
    enc, Tp = encoder_flops(mcfg, B, T)
    return 3 * (enc + B * (U - 1) * step_cell_flops(mcfg, V, Tp))
