"""The Python around the training kernels (K3, K4; K1, K2), on the CPU:
the weight packs' layouts, the encoder's wave schedule, the shape gates,
and the plain path.

The kernels' products (kernels/csrc/decode_step.cu) read a weight as
(column blocks, K, 64) tiles: the block that owns 64 output columns sums
x[:, k:k + 32] @ tile over its 32-row tiles.  Each test here emulates
that block by block from the packed tensors and holds the result against
the plain product -- x @ W for K3's (pack_step_weights; a cell's block
holds the four gates of 16 units), dz @ W^T for K4's
(pack_backward_weights) -- at a tiny width and at one where no N is a
multiple of 64, within 1e-12 on float64 inputs (the tiles only change
the order of the sums).  The encoder's packs
(pack_encoder_step_weights, pack_encoder_backward_weights) are held the
same way, every layer and direction against torch.bmm on the unpacked
weights, at a tiny width and at es_en_20h's; and its wave schedule must
visit every cell once, after the cells it reads.
"""

import numpy as np
import pytest
import torch

from ast_tpu_torch.ops import fused_decoder as fd
from ast_tpu_torch.ops import fused_infer as fi
from ast_tpu_torch.ops import fused_lstm as fl

L, R = 3, 5
# (H, E, A, V): tiny; every N ragged (H = A = 96, V = 77, H + E + A = 224)
WIDTHS = {"tiny": (32, 32, 32, 23), "ragged": (96, 32, 96, 77)}


def _weights(width, seed=0):
    H, E, A, V = WIDTHS[width]
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape))

    return {"embed": t(V, E), "wx0": t(E + A, 4 * H),
            "wx_rest": t(L - 1, H, 4 * H), "wh": t(L, H, 4 * H),
            "b": t(L, 4 * H), "wa": t(H, H), "wa_b": t(H),
            "ctx_w": t(2 * H, A), "ctx_b": t(A), "out_w": t(A, V),
            "out_b": t(V)}


def _rows(k, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (R, k)))


def block_products(x, packed):
    """What the product kernel's blocks compute from a packed weight
    (column blocks, K, 64): block c sums x[:, k:k + 32] @ packed[c, k:k +
    32] over its tiles.  Returns (column blocks, R, 64)."""
    nb, K, nc = packed.shape
    assert nc == 64 and K % 32 == 0 and x.shape[1] == K
    out = torch.zeros((nb, x.shape[0], 64), dtype=x.dtype)
    for c in range(nb):
        for k in range(0, K, 32):
            out[c] += x[:, k:k + 32] @ packed[c, k:k + 32]
    return out


def linear_from_blocks(x, packed, N):
    """(R, N) of a linear product: block c holds columns 64 c .. 64 c +
    63; the padding columns must come out zero."""
    z = block_products(x, packed).permute(1, 0, 2).reshape(x.shape[0], -1)
    assert not z[:, N:].any()
    return z[:, :N]


@pytest.mark.parametrize("product", ["cell0", "cell1", "cell2", "q", "ctx",
                                     "logits"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_forward_pack_products(width, product):
    """Every product of a K3 step from pack_step_weights' tiles equals
    x @ W."""
    H, E, A, V = WIDTHS[width]
    w = _weights(width)
    p = fi.pack_step_weights(w)
    if product.startswith("cell"):
        l = int(product[4:])
        wx = w["wx0"] if l == 0 else w["wx_rest"][l - 1]
        cat = torch.cat([wx, w["wh"][l]])                    # (K, 4H)
        K = cat.shape[0]
        off = sum((E + A + H if i == 0 else 2 * H) * 4 * H for i in range(l))
        packed = p["cell"][off:off + K * 4 * H].view(H // 16, K, 64)
        x = _rows(K)
        z = block_products(x, packed)                        # (H/16, R, 64)
        # packed column q * 16 + u of block c is gate q of unit 16 c + u
        got = z.view(H // 16, R, 4, 16).permute(1, 2, 0, 3).reshape(R, 4 * H)
        want = x @ cat
        if l == L - 1:
            assert off + K * 4 * H == p["cell"].numel()
    else:
        name, N = {"q": ("wa", H), "ctx": ("ctx_w", A),
                   "logits": ("out_w", V)}[product]
        x = _rows(w[name].shape[0])
        got = linear_from_blocks(x, p[name], N)
        want = x @ w[name]
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("product", ["d_cv", "d_top", "layer0", "layer1",
                                     "layer2"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_backward_pack_products(width, product):
    """Every product of a K4 step from pack_backward_weights' tiles equals
    the plain backward's dz @ W^T."""
    H, E, A, _ = WIDTHS[width]
    w = _weights(width)
    p = fd.pack_backward_weights(w)
    if product == "d_cv":
        d_pre = _rows(A)
        got = linear_from_blocks(d_pre, p["cv"], H)
        want = d_pre @ w["ctx_w"][:H].t()
    elif product == "d_top":
        d_q, d_pre = _rows(H, 2), _rows(A, 3)
        got = linear_from_blocks(torch.cat([d_q, d_pre], dim=1), p["top"], H)
        want = d_q @ w["wa"].t() + d_pre @ w["ctx_w"][H:].t()
    else:
        l = int(product[5:])
        wx = w["wx0"] if l == 0 else w["wx_rest"][l - 1]
        dz = _rows(4 * H)
        got = linear_from_blocks(dz, p["layer"][l], H + wx.shape[0])
        # [dh_prev | dx]: the carry row of layer l
        want = torch.cat([dz @ w["wh"][l].t(), dz @ wx.t()], dim=1)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_backward_pack_is_one_buffer(width):
    """cv, top and the layers lie back to back in ``flat``, each padded to
    whole column blocks: the kernel finds layer l at the sum of the padded
    sizes before it."""
    H, E, A, _ = WIDTHS[width]
    w = _weights(width)
    p = fd.pack_backward_weights(w)

    def pad(n):
        return -(-n // 64) * 64

    sizes = [A * pad(H), (H + A) * pad(H), 4 * H * pad(H + E + A)] \
        + [4 * H * pad(2 * H)] * (L - 1)
    views = [p["cv"], p["top"], *p["layer"]]
    assert [v.numel() for v in views] == sizes
    assert p["flat"].numel() == sum(sizes)
    item = p["flat"].element_size()
    for v, off in zip(views, np.cumsum([0] + sizes[:-1])):
        assert v.is_contiguous()
        assert v.data_ptr() == p["flat"].data_ptr() + int(off) * item


@pytest.mark.parametrize("bad", ["E", "A", "H"])
def test_train_shape_gate_names_the_width(bad):
    dims = dict(T=20, H=64, E=32, A=64)
    fd.check_train_shapes(**dims)
    dims[bad] += 8
    with pytest.raises(ValueError, match="multiples of 32") as err:
        fd.check_train_shapes(**dims)
    assert str(dims[bad]) in str(err.value)


def test_train_shape_gate_attention_shared_memory():
    """A row's query, two context partials and T scores must fit a block's
    227 KB: T' = 56,000 at H = 512 does, T' = 58,000 does not."""
    fd.check_train_shapes(T=56000, H=512, E=128, A=512)
    with pytest.raises(ValueError, match="shared memory"):
        fd.check_train_shapes(T=58000, H=512, E=128, A=512)


def _decoder_call(width="tiny", T=6, U=4, B=3):
    H, E, A, V = WIDTHS[width]
    w = {k: v.float() for k, v in _weights(width).items()}
    rng = np.random.default_rng(5)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    y_in = torch.from_numpy(rng.integers(4, V, (U, B)).astype(np.int32))
    coins = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    return (t(B, T, H), t(L, B, H) * 0.5, t(L, B, H) * 0.5, w, y_in, coins,
            11, 0.3, 0.3)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers return the plain versions' results and
    launch nothing."""
    args = _decoder_call()
    n3, n4 = fd.decoder_forward.launches, fd.decoder_backward.launches
    ht, res = fd.decoder_forward(*args)
    ht_p, res_p = fd.decoder_forward_reference(*args)
    assert torch.equal(ht, ht_p)
    for k in fd.RES_NAMES:
        assert torch.equal(res[k], res_p[k]), k
    enc, _, c0, w = args[:4]
    d_ht = torch.ones_like(ht)
    g = fd.decoder_backward(res, ht, enc, c0, w, d_ht, 11, 0.3, 0.3)
    g_p = fd.decoder_backward_reference(res, ht, enc, c0, w, d_ht, 11, 0.3,
                                        0.3)
    for k in fd.GRAD_NAMES:
        assert torch.equal(g[k], g_p[k]), k
    assert (fd.decoder_forward.launches, fd.decoder_backward.launches) \
        == (n3, n4)


# encoder widths (L, D2, H): tiny (N = H = 32 and 2H = 64 leave blocks
# ragged), es_en_20h's, and one layer in one direction
ENC_WIDTHS = {"tiny": (3, 2, 32), "es_en_20h": (3, 2, 256),
              "one_layer": (1, 1, 96)}


def _encoder_weights(width, seed=0):
    L, D2, H = ENC_WIDTHS[width]
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((L - 1, D2, H, 4 * H))),
            torch.from_numpy(rng.standard_normal((L, D2, H, 4 * H))))


@pytest.mark.parametrize("width", list(ENC_WIDTHS))
def test_encoder_forward_pack_products(width):
    """Every K1 product -- each layer, each direction -- from
    pack_encoder_step_weights' tiles equals [x | h] @ [wx; wh] (layer 0: h
    @ wh), and the groups lie where k1_encoder.cu looks for them."""
    L, D2, H = ENC_WIDTHS[width]
    wx_rest, wh = _encoder_weights(width)
    flat = fl.pack_encoder_step_weights(wx_rest, wh)
    assert flat.numel() == (2 * L - 1) * D2 * H * 4 * H
    for l in range(L):
        K = 2 * H if l else H
        x = torch.stack([_rows(K, 10 * l + d) for d in range(D2)])
        cat = torch.cat([wx_rest[l - 1], wh[l]], dim=1) if l else wh[0]
        want = torch.bmm(x, cat)                              # (D2, R, 4H)
        for d in range(D2):
            off = (d * H if l == 0
                   else D2 * H + ((l - 1) * D2 + d) * 2 * H) * 4 * H
            packed = flat[off:off + K * 4 * H].view(H // 16, K, 64)
            z = block_products(x[d], packed)
            got = z.view(H // 16, R, 4, 16).permute(1, 2, 0, 3).reshape(
                R, 4 * H)
            torch.testing.assert_close(got, want[d], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("width", list(ENC_WIDTHS))
def test_encoder_backward_pack_products(width):
    """Every K2 product from pack_encoder_backward_weights' tiles equals
    the plain backward's [dz @ wh^T | dz @ wx^T], the layer's carry row."""
    L, D2, H = ENC_WIDTHS[width]
    wx_rest, wh = _encoder_weights(width)
    flat = fl.pack_encoder_backward_weights(wx_rest, wh)
    b0, b1 = -(-H // 64), -(-2 * H // 64)
    assert flat.numel() == D2 * (b0 + (L - 1) * b1) * 4 * H * 64
    for l in range(L):
        dz = torch.stack([_rows(4 * H, 10 * l + d) for d in range(D2)])
        want = torch.bmm(dz, wh[l].transpose(1, 2))
        if l:
            want = torch.cat(
                [want, torch.bmm(dz, wx_rest[l - 1].transpose(1, 2))], dim=2)
        for d in range(D2):
            nb = b1 if l else b0
            off = (d * b0 if l == 0
                   else D2 * b0 + ((l - 1) * D2 + d) * b1) * 4 * H * 64
            packed = flat[off:off + nb * 4 * H * 64].view(nb, 4 * H, 64)
            got = linear_from_blocks(dz[d], packed, 2 * H if l else H)
            torch.testing.assert_close(got, want[d], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("reverse", [False, True], ids=["k1", "k2"])
@pytest.mark.parametrize("T,L", [(1, 1), (1, 3), (2, 3), (3, 3), (7, 3),
                                 (160, 3), (5, 1), (4, 6)])
def test_wave_schedule_order(T, L, reverse):
    """Every (t, l) once; forward a cell comes in a later wave than
    (t - 1, l) and (t, l - 1), in reverse later than (t + 1, l) and
    (t, l + 1); T + L - 1 waves, each by ascending layer (so a wave that
    takes several launches never rewrites a carry a later one reads)."""
    cells, starts = fl.wave_schedule(T, L, reverse)
    assert cells.dtype == np.int32 and starts.dtype == np.int32
    assert cells.flags["C_CONTIGUOUS"] and cells.shape == (T * L, 2)
    assert len(starts) == T + L and starts[0] == 0 and starts[-1] == T * L
    wave_of = {}
    for w in range(T + L - 1):
        rows = cells[starts[w]:starts[w + 1]]
        assert len(rows) > 0
        assert (np.diff(rows[:, 1]) > 0).all()
        for t, l in rows.tolist():
            assert (t, l) not in wave_of
            wave_of[(t, l)] = w
    assert set(wave_of) == {(t, l) for t in range(T) for l in range(L)}
    step = -1 if reverse else 1
    for (t, l), w in wave_of.items():
        for dep in ((t - step, l), (t, l - step)):
            if dep in wave_of:
                assert wave_of[dep] == w - 1, ((t, l), dep)


def test_wave_schedule_full_wave_holds_every_layer():
    """At T' = 160 and L = 3 all but the first and last two waves hold
    three cells: six products a launch with both directions."""
    for reverse in (False, True):
        _, starts = fl.wave_schedule(160, 3, reverse)
        assert np.diff(starts).tolist() == [1, 2] + [3] * 158 + [2, 1]


def test_encoder_shape_gate_names_the_width():
    fl.check_encoder_shapes(256)
    with pytest.raises(ValueError, match="multiple of 32") as err:
        fl.check_encoder_shapes(40)
    assert "40" in str(err.value)


def test_encoder_cpu_tensors_take_the_plain_versions():
    """On CPU tensors K1's and K2's wrappers return the plain versions'
    results and launch nothing."""
    L, D2, H = ENC_WIDTHS["tiny"]
    T, B = 4, 3
    rng = np.random.default_rng(9)

    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32) * 0.3)

    args = (t(T, D2, B, 4 * H), t(L - 1, D2, H, 4 * H), t(L, D2, H, 4 * H),
            t(L, D2, 4 * H))
    wrappers = (fl.fused_stacked_lstm, fl.fused_stacked_lstm_train,
                fl.encoder_backward)
    before = [f.launches for f in wrappers]
    for a, b in zip(fl.fused_stacked_lstm(*args),
                    fl.stacked_lstm_reference(*args)):
        assert torch.equal(a, b)
    got = fl.fused_stacked_lstm_train(*args, 5, 0.3)
    for a, b in zip(got, fl.stacked_lstm_reference(*args, True, 5, 0.3)):
        assert torch.equal(a, b)
    bwd = (got[3], got[4], args[1], args[2], t(T, D2, B, H), t(L, D2, B, H),
           t(L, D2, B, H), 5, 0.3)
    assert torch.equal(fl.encoder_backward(*bwd),
                       fl.encoder_backward_reference(*bwd))
    assert [f.launches for f in wrappers] == before
