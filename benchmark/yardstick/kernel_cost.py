"""The yardstick of the kernels' roofline shares: the FLOPs of a call's
matrix products and the bytes it must move, and the H100's published
peaks.

A frozen copy of ``chip_smoke.py``'s ``PEAK_*``, ``kernel_cost`` and
``bound`` at commit 22fa93ac41eb92290dc27e5d3bbe6819cd4b1719, unchanged
but for this docstring.  The benchmark keeps its own copy so that a
change to the program cannot move the yardstick it is measured by;
``benchmark/tests/test_bench_yardstick.py`` holds the copy equal to
the original at chip_smoke's shapes while both exist.
"""

# the H100 SXM's published peaks (NVIDIA's data sheet, 700 W): float32
# outside the tensor cores, bf16 dense on the tensor cores, and HBM3
PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES = 67e12, 989e12, 3.35e12


def kernel_cost(key, d):
    """(FLOPs of the matrix products, bytes moved) of one call of kernel
    ``key`` ("k1", "k1t", "k2", "k3", "k4", "k5", "k6") at the dims ``d``:
    B, H, L and, for the encoder, T and D2 (directions, H a direction's
    units), for the decoder T, E, A, V and U (K3, K4), n (the steps a K5 /
    K6 call ran), stop, N (K6) and n_logits (K3: the steps whose next
    input is sampled, the only ones that compute logits); ``wbytes`` 2
    for the bf16 modes: the weight matrices (for K5 / K6 the encoder
    states too) and, for the training kernels, the encoder states and
    every residual and gradient stream but ht, the cotangents and the
    final states, which stay f32 (K3 at bf16 writes no x_drop).  Bytes
    count each input read once and each output written once, 4 bytes an
    element but those.  Elementwise work (gates, softmax, dropout, top-K)
    is left out of the FLOPs."""
    B, H, L = d["B"], d["H"], d["L"]
    wb = d.get("wbytes", 4)
    if key in ("k1", "k1t", "k2"):
        T, D2 = d["T"], d["D2"]
        flops = 2 * T * D2 * B * 4 * H * H * (2 * L - 1)
        mats, bias = (2 * L - 1) * D2 * H * 4 * H, L * D2 * 4 * H
        fins = 2 * L * D2 * B * H
        if key == "k2":
            streams = T * L * D2 * B * 5 * H + T * L * D2 * B * 4 * H
            return flops, (wb * (mats + streams)
                           + 4 * (T * D2 * B * H + fins))
        ins = bias + T * D2 * B * 4 * H
        if key == "k1":
            return flops, wb * mats + 4 * (ins + T * D2 * B * H + fins)
        # train: the f32 mode's final states are copies of the streams'
        return flops, (wb * (mats + T * L * D2 * B * 7 * H)
                       + 4 * (ins + T * D2 * B * H
                              + (fins if wb == 2 else 0)))
    T, E, A, V = d["T"], d["E"], d["A"], d["V"]
    cell = 4 * H * (E + A + H) + (L - 1) * 4 * H * 2 * H
    attn = H * H + 2 * T * H + 2 * H * A
    dec_w = (V * E + (E + A) * 4 * H + (2 * L - 1) * H * 4 * H + L * 4 * H
             + H * H + H + 2 * H * A + A + A * V + V)
    enc_state = B * T * H + 2 * L * B * H
    # the products' matrices (wbytes; the embedding and biases f32)
    mats = ((E + A) * 4 * H + (2 * L - 1) * H * 4 * H + H * H + 2 * H * A
            + A * V)
    if key == "k3":
        U = d["U"]
        flops = 2 * U * B * (cell + attn) + 2 * d["n_logits"] * B * A * V
        # ht, sel; acts, c, h (and at f32 x_drop), alphas, q, cv, emb
        streams = U * B * (L * (6 if wb == 2 else 7) * H + T + 2 * H + E)
        return flops, (wb * (mats + B * T * H + streams)
                       + 4 * (enc_state - B * T * H + dec_w - mats + U * B
                              + U + U * B * (A + 1)))
    if key == "k4":
        U = d["U"]
        flops = 2 * U * B * (2 * H * A + 2 * T * H + H * H
                             + (2 * L - 1) * 4 * H * H + 4 * H * (E + A))
        mats = 2 * H * A + H * H + (2 * L - 1) * H * 4 * H + (E + A) * 4 * H
        streams = (U * L * B * 5 * H + L * B * H + U * B * T + B * T * H
                   + U * B * (L * 4 * H + A + T + 2 * H + E))
        return flops, (wb * (mats + streams)
                       + 4 * (2 * U * B * A + 2 * L * B * H))
    R = B * d.get("N", 1)
    flops = 2 * d["n"] * R * (cell + attn + A * V)
    outs = d["stop"] * R * (3 if key == "k6" else 1) + (R if key == "k6"
                                                          else 0)
    # the products' matrices and the encoder states in wbytes; the
    # embedding, the biases and the state in f32
    return flops, (wb * (mats + B * T * H)
                   + 4 * (enc_state - B * T * H + dec_w - mats + outs))


def bound(flops, nbytes, peak=PEAK_F32_FLOPS):
    """(bound_ms, bound_by): the larger of the two least times, the
    products at ``peak`` FLOP/s."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")
