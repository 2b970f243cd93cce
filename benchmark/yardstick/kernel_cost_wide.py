"""The training decoder's kernels' yardstick where the encoder states are
wider than the decoder: K3's and K4's FLOPs and bytes with the encoder
states' width He apart from the decoder's H.

``kernel_cost``'s ``k3`` / ``k4`` (frozen) read both from one H, which
is right only where He == H.  Here the attention's query, scores,
context vector and their gradients take He, the decoder's cell and state
H, and the matrices wa (H, He) and ctx_w (He + H, A); at He == H every
term is ``kernel_cost``'s (``benchmark/tests`` hold the two equal there).
Bytes count each input read once and each output written once, as
``kernel_cost`` does.
"""

from benchmark.yardstick.kernel_cost import (
    PEAK_BF16_FLOPS, PEAK_F32_FLOPS, bound)


def kernel_cost_wide(key, d):
    """(FLOPs, bytes) of one K3 (``"k3"``) or K4 (``"k4"``) call at the
    dims ``d`` of ``kernel_cost`` plus ``He`` (default H)."""
    B, H, L = d["B"], d["H"], d["L"]
    He = d.get("He", H)
    wb = d.get("wbytes", 4)
    T, E, A, V, U = d["T"], d["E"], d["A"], d["V"], d["U"]
    cell = 4 * H * (E + A + H) + (L - 1) * 4 * H * 2 * H
    layers = (E + A) * 4 * H + (2 * L - 1) * H * 4 * H
    if key == "k3":
        attn = H * He + 2 * T * He + (He + H) * A
        flops = 2 * U * B * (cell + attn) + 2 * d["n_logits"] * B * A * V
        mats = layers + H * He + (He + H) * A + A * V
        dec_w = mats + V * E + L * 4 * H + He + A + V
        enc_state = B * T * He + 2 * L * B * H
        # ht, sel; acts, c, h (and at f32 x_drop), alphas, q, cv, emb
        streams = U * B * (L * (6 if wb == 2 else 7) * H + T + 2 * He + E)
        return flops, (wb * (mats + B * T * He + streams)
                       + 4 * (enc_state - B * T * He + dec_w - mats + U * B
                              + U + U * B * (A + 1)))
    if key == "k4":
        flops = 2 * U * B * (A * He + (He + A) * H + 2 * T * He
                             + (2 * L - 1) * 4 * H * H + 4 * H * (E + A))
        mats = A * He + (He + A) * H + (2 * L - 1) * H * 4 * H \
            + (E + A) * 4 * H
        streams = (U * L * B * 5 * H + L * B * H + U * B * T + B * T * He
                   + U * B * (L * 4 * H + A + T + 2 * He + E))
        return flops, (wb * (mats + streams)
                       + 4 * (2 * U * B * A + 2 * L * B * H))
    raise KeyError(key)


def share(rec, kernel):
    """100 x (sum of the calls' bounds) / (sum of their device times) of
    ``kernel``'s calls in ``rec["kernels"]`` (``core.wide_probes``);
    None without calls."""
    calls = (rec.get("kernels") or {}).get(kernel) or []
    if not calls:
        return None
    least = sum(bound(*kernel_cost_wide(key, d), peak=(
        PEAK_BF16_FLOPS if d.get("wbytes", 4) == 2 else PEAK_F32_FLOPS))[0]
        for key, d, _ in calls)
    return 100.0 * least / sum(ms for _, _, ms in calls)
