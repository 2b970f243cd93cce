"""The bf16 products' tensor-core weight layout, on the CPU.

At bf16 every single product of kernels/csrc/decode_step.cu runs
``mma.sync.aligned.m16n8k16`` on weight tiles in the B-fragment order
the warps read (``ops/fused_infer.mma_tiles``): K5's and K6's cells and
linears (``mma_prod_kernel``) over ``pack_step_weights_mma``'s tiles,
packed once per model; K3's train cells (``mma_prod_train_kernel``) and
linears over the same pack, made once per call; K4's backward products
(``mma_prod_bwd_kernel``) and d_cv linear over
``ops/fused_decoder.pack_backward_weights``' transposed matrices, which
at bf16 it lays out in the same order.  Held here:

- the pack unpacks bit-equal to the matrices it came from, at tiny dims
  with ragged K (not a multiple of 32) and V (not of 64);
- its index formula is the PTX m16n8k16 B-fragment map, modelled in
  numpy from the ISA's fragment layout;
- a numpy model of a block of the kernel -- its ldmatrix addresses, its
  B loads at the pack's offsets, the ISA's A, B and C fragment layouts,
  and its partial-sum index -- computes x @ W (within 1e-12 on float64
  sums of bf16 values: only the order of the sums differs), for the
  decode step's products, K3's train cells and K4's backward products,
  whose partials its per-column epilogue reads summed over the cluster;
- K4's bf16 pack unpacks bit-equal to ctx_w[:H]^T, [wa^T; ctx_w[H:]^T]
  and each layer's [wh^T | wx^T], back to back at the f32 layout's
  offsets, zero past the ragged columns; K3's bf16 pack is
  ``pack_step_weights_mma``, with each layer where K3's loop looks;
- the f32 decode pack and ``pack_step_weights`` (K3's per-call pack at
  f32; at bf16 the column blocks ``pack_step_weights_mma`` tiles) keep
  their column-block layout bit for bit;
- ``step_weights`` refuses a bf16 step in the column-block layout;
- the encoder's waves (K1's eval and train cells, K2's linears;
  ``mma_wave_kernel``): ``ops/fused_lstm``'s bf16 packs unpack to each
  (layer, direction)'s [wx; wh] in unit blocks and [wh^T | wx^T] (zero
  past N), at es_en_20h's width, ragged ones and a five-layer stack; the
  block model over their tiles, at each (layer, direction)'s offset in
  the flat pack, gives x @ W for a layer-0 cell, a two-segment cell above
  it and K2's linear over a cluster of 3 at every row tiling; the f32
  encoder packs and ``decode_weights``' f32 ``"enc"`` keep their layout
  bit for bit, and its bf16 ``"enc"`` is the fragment-order pack.
"""

import numpy as np
import pytest
import torch

from ast_tpu_torch.models import seq2seq
from ast_tpu_torch.ops import fused_decoder as fd
from ast_tpu_torch.ops import fused_infer as fi
from ast_tpu_torch.ops import fused_lstm as fl
from tests.conftest import TINY_MODEL_CFG

BF = torch.bfloat16
L = 2
# (H, E, A, V): the tiny model's (K = E + A + H = 40 and V = 12 ragged),
# and three that the kernels take with V ragged: K4's d_cv and d_top
# columns (H = 32) ragged in the first two, its layer-0 columns (H + E +
# A = 96) in the second; in the third, whole column blocks at an offset
# (layer 0's wx^T from column H = 64) and a ragged tail
DIMS = {"tiny": (16, 8, 16, 12), "kernel": (32, 32, 64, 70),
        "ragged": (32, 32, 32, 40), "wide": (64, 32, 64, 40)}


def _weights(dims, seed=0):
    """Decoder weights in bf16, from a seeded numpy draw."""
    H, E, A, V = DIMS[dims]
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(BF)

    return {"embed": t(V, E), "wx0": t(E + A, 4 * H),
            "wx_rest": t(L - 1, H, 4 * H), "wh": t(L, H, 4 * H),
            "b": t(L, 4 * H), "wa": t(H, H), "wa_b": t(H),
            "ctx_w": t(2 * H, A), "ctx_b": t(A), "out_w": t(A, V),
            "out_b": t(V)}


def _cells(w):
    """Each layer's [wx; wh] (K, 4H)."""
    wxs = [w["wx0"]] + [w["wx_rest"][l] for l in range(L - 1)]
    return [torch.cat([wx, wh]) for wx, wh in zip(wxs, w["wh"])]


def column_blocks(m):
    """numpy model of the column-block layout: (K, N) -> (ceil(N / 64),
    K, 64), block c holding columns 64 c .. 64 c + 63, zero past N."""
    K, N = m.shape
    nb = -(-N // 64)
    out = np.zeros((nb, K, 64), m.dtype)
    for c in range(nb):
        take = min(64, N - 64 * c)
        out[c, :, :take] = m[:, 64 * c:64 * c + take]
    return out


def cell_blocks(cat, H):
    """numpy model of a cell's layout: packed column q * 16 + u of block c
    is gate q of unit 16 c + u."""
    K = cat.shape[0]
    out = np.zeros((H // 16, K, 64), cat.dtype)
    for c in range(H // 16):
        for q in range(4):
            out[c, :, q * 16:q * 16 + 16] = cat[:, q * H + 16 * c:
                                                 q * H + 16 * c + 16]
    return out


def old_layout(w):
    """numpy model of pack_step_weights' matrices (as float32 arrays)."""
    H = w["wh"].shape[1]
    f = {k: w[k].float().numpy() for k in ("wa", "ctx_w", "out_w")}
    return {"cell": np.concatenate([cell_blocks(c.float().numpy(), H).ravel()
                                    for c in _cells(w)]),
            "wa": column_blocks(f["wa"]), "ctx_w": column_blocks(f["ctx_w"]),
            "out_w": column_blocks(f["out_w"])}


def fragment_offset(k, n):
    """Where row k, column n of a 32 x 64 tile lies in mma_tiles' order
    (its docstring's formula): k = 16 ks + 8 i + 2 t + h, n = 8 nt + g
    at ((32 nt + 4 g + t) * 2 + ks) * 4 + 2 i + h."""
    ks, i, t, h = k // 16, k % 16 // 8, k % 8 // 2, k % 2
    nt, g = n // 8, n % 8
    return ((32 * nt + 4 * g + t) * 2 + ks) * 4 + 2 * i + h


def unpack_tiles(t, K):
    """numpy: (..., kt, 2048) tiles -> (..., K, 64) by fragment_offset."""
    off = fragment_offset(np.arange(32)[:, None], np.arange(64)[None, :])
    x = t[..., off]                                   # (..., kt, 32, 64)
    return x.reshape(*t.shape[:-2], -1, 64)[..., :K, :]


def unpack_step(step, w):
    """The matrices of pack_step_weights_mma's ``step`` in
    pack_step_weights' column-block layout (float32 numpy arrays)."""
    H = w["wh"].shape[1]
    out, cell, off = {}, [], 0
    for c in _cells(w):
        K = c.shape[0]
        n = (H // 16) * -(-K // 32)
        tiles = step["cell"][off:off + n].float().numpy()
        cell.append(unpack_tiles(tiles.reshape(H // 16, -1, 2048), K).ravel())
        off += n
    out["cell"] = np.concatenate(cell)
    for k in ("wa", "ctx_w", "out_w"):
        out[k] = unpack_tiles(step[k].float().numpy(), w[k].shape[0])
    return out


def ptx_b_fragment(tile, nt, lane, ks):
    """The ISA's m16n8k16 B fragment (.bf16, .col) of lane ``lane`` for
    the 16 x 8 block of a 32 x 64 ``tile`` at k-step ``ks``, n-tile
    ``nt``: registers b0, b1, each two elements, element j of b_i at row
    2 (lane % 4) + j + 8 i and column lane // 4."""
    g, t = lane // 4, lane % 4
    return [[tile[16 * ks + 2 * t + j + 8 * i, 8 * nt + g] for j in (0, 1)]
            for i in (0, 1)]


@pytest.mark.parametrize("dims", list(DIMS))
def test_mma_pack_unpacks_to_its_matrices(dims):
    """Every matrix of the bf16 decode pack, unpacked, equals the matrix it
    came from bit for bit (the padding rows and columns zero)."""
    H, E, A, V = DIMS[dims]
    w = _weights(dims)
    step = fi.pack_step_weights_mma(w)
    shapes = fi._step_shapes(H, L, E, A, V, mma=True)
    for k in fi.STEP_ORDER:
        assert tuple(step[k].shape) == shapes[k], k
        assert step[k].dtype == (BF if k in fi._STEP_MATRICES
                                 else torch.float32), k
    un = unpack_step(step, w)
    off = 0
    for cat in _cells(w):
        K = cat.shape[0]
        blk = un["cell"][off:off + K * 4 * H].reshape(H // 16, K, 4, 16)
        off += K * 4 * H
        # gate q of unit 16 c + u at packed column q * 16 + u of block c
        got = blk.transpose(1, 2, 0, 3).reshape(K, 4 * H)
        np.testing.assert_array_equal(got, cat.float().numpy())
    assert off == un["cell"].size
    for k in ("wa", "ctx_w", "out_w"):
        K, N = w[k].shape
        flat = un[k].transpose(1, 0, 2).reshape(K, -1)
        np.testing.assert_array_equal(flat[:, :N], w[k].float().numpy())
        assert not flat[:, N:].any(), k
    # the tiles past K (tiny: the cells' K = 40, 32) hold zeros
    n_tiles = sum(-(-c.shape[0] // 32) for c in _cells(w)) * (H // 16)
    assert step["cell"].shape[0] == n_tiles
    nonzero = sum(int(m.count_nonzero()) for m in [
        *_cells(w), w["wa"], w["ctx_w"], w["out_w"]])
    assert sum(int(step[k].count_nonzero())
               for k in fi._STEP_MATRICES) == nonzero


def test_mma_tile_order_is_the_ptx_b_fragment_map():
    """Lane l of a warp that multiplies column tile nt loads 8 values at
    offset 8 (32 nt + l) of a tile: the ISA's B fragments (b0, b1) of
    k-step 0, then of k-step 1."""
    rng = np.random.default_rng(3)
    tile = rng.permutation(32 * 64).reshape(32, 64)
    packed = fi.mma_tiles(torch.from_numpy(tile)[None])[0, 0].numpy()
    assert sorted(packed) == list(range(32 * 64))
    for nt in range(8):
        for lane in range(32):
            got = packed[8 * (32 * nt + lane):8 * (32 * nt + lane) + 8]
            want = [v for ks in (0, 1)
                    for reg in ptx_b_fragment(tile, nt, lane, ks)
                    for v in reg]
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(unpack_tiles(packed[None], 32), tile)


def ldmatrix_x4(a_tile, addr):
    """The ISA's ldmatrix .m8n8.x4 .b16 over a tile of rows: lanes 8 j ..
    8 j + 7 give the row addresses (row, column) of matrix j, and lane l
    receives, as register j, elements 2 (l % 4) and 2 (l % 4) + 1 of
    matrix j's row l // 4."""
    regs = []
    for lane in range(32):
        regs.append([])
        for j in range(4):
            r, c = addr[8 * j + lane // 4]
            regs[-1].append(a_tile[r, c + 2 * (lane % 4):c + 2 * (lane % 4)
                                   + 2])
    return regs


def mma_m16n8k16(c, a_regs, b_regs):
    """The ISA's mma .m16n8k16 .row .col .f32 .bf16: lane l = 4 g + t
    holds a0 = A[g, 2t:2t+2], a1 = A[g+8, 2t:2t+2], a2 = A[g, 2t+8:2t+10],
    a3 = A[g+8, 2t+8:2t+10]; b0 = B[2t:2t+2, g], b1 = B[2t+8:2t+10, g];
    c0, c1 = C[g, 2t:2t+2], c2, c3 = C[g+8, 2t:2t+2].  Returns the lanes'
    c + A B."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        a = a_regs[lane]
        A[g, 2 * t:2 * t + 2], A[g + 8, 2 * t:2 * t + 2] = a[0], a[1]
        A[g, 2 * t + 8:2 * t + 10], A[g + 8, 2 * t + 8:2 * t + 10] = (a[2],
                                                                      a[3])
        b = b_regs[lane]
        B[2 * t:2 * t + 2, g], B[2 * t + 8:2 * t + 10, g] = b[0], b[1]
    D = A @ B
    out = []
    for lane in range(32):
        g, t = lane // 4, lane % 4
        out.append(c[lane] + np.concatenate([D[g, 2 * t:2 * t + 2],
                                             D[g + 8, 2 * t:2 * t + 2]]))
    return out


def row_tile(R):
    """The rows of a product block (decode_step.cu's launch_prod)."""
    return next(rb for rb in (16, 32, 64, 128, 160, 256) if R <= rb)


def kernel_block(x, packed, cell):
    """numpy model of one block of mma_prod_kernel over all its k-tiles:
    the input rows (zero past R) as the bf16 tile; the 8 warps as WM x WN
    (WM = 2 where the block's 16-row tiles are even), warp (wm, wn)
    taking row tiles wm + WM i and column tiles WM wn + j; each warp's
    ldmatrix addresses and B loads as the kernel forms them, the ISA's
    fragments, and the partial sums stored at the kernel's index.  x
    (R, K) holds bf16 values; packed (K / 32, 2048).  Returns P (RB,
    64)."""
    R, K = x.shape
    RB = row_tile(R)
    MT = RB // 16
    WM = 2 if MT % 2 == 0 else 1
    acc = {}
    for kt in range(K // 32):
        a_tile = np.zeros((RB, 32))
        a_tile[:R] = x[:, 32 * kt:32 * kt + 32]
        ws = packed[kt]
        for warp in range(8):
            wm, wn = warp % WM, warp // WM
            b = [[ws[8 * ((WM * wn + j) * 32 + lane):
                     8 * ((WM * wn + j) * 32 + lane) + 8]
                  for lane in range(32)] for j in range(WM)]
            for i in range(MT // WM):
                m = wm + WM * i
                if m * 16 >= R:
                    break
                for ks in (0, 1):
                    # a_lane: row lane % 16, column 8 (lane / 16), k-step ks
                    addr = [(16 * m + lane % 16, 16 * ks + 8 * (lane // 16))
                            for lane in range(32)]
                    a = ldmatrix_x4(a_tile, addr)
                    for j in range(WM):
                        bk = [[bl[4 * ks:4 * ks + 2], bl[4 * ks + 2:4 * ks + 4]]
                              for bl in b[j]]
                        key = (warp, i, j)
                        acc[key] = mma_m16n8k16(
                            acc.get(key, [np.zeros(4)] * 32), a, bk)
    P = np.zeros((RB, 64))
    for (warp, i, j), lanes in acc.items():
        wm, wn = warp % WM, warp // WM
        m, n = wm + WM * i, WM * wn + j
        for lane in range(32):
            for e in range(4):
                col = n * 8 + (lane & 3) * 2 + (e & 1)
                pc = (col % 16) * 4 + col // 16 if cell else col
                P[m * 16 + (lane >> 2) + (e >> 1) * 8, pc] = lanes[lane][e]
    return P


def bwd_transposes(w):
    """The transposed matrices of K4's products, (K, N) float64 numpy:
    cv = ctx_w[:H]^T, top = [wa^T; ctx_w[H:]^T], each layer's [wh^T |
    wx^T] (4H, H + E + A, then 2H)."""
    H = w["wh"].shape[1]
    f = {k: v.double() for k, v in w.items()}
    wxs = [f["wx0"]] + [f["wx_rest"][l] for l in range(L - 1)]
    mats = [f["ctx_w"][:H].t(), torch.cat([f["wa"].t(), f["ctx_w"][H:].t()])]
    mats += [torch.cat([wh.t(), wx.t()], dim=1)
             for wh, wx in zip(f["wh"], wxs)]
    return [m.numpy() for m in mats]


def bwd_epilogue_rows(P, cb, N, R):
    """What PROD_BWD's per-column epilogue sums for column block cb: the
    element (r, n) of column n = 64 cb + c < N reads partial (r, c) of
    each k-group (one, on the tensor cores) of every block of the
    cluster; P (cluster blocks, RB, 64).  Returns (R, columns)."""
    ncol = min(64, N - 64 * cb)
    return np.stack([[sum(P[s, r, c] for s in range(P.shape[0]))
                      for c in range(ncol)] for r in range(R)])


# the products a block of the tensor-core kernels runs: the decode step's
# cells and linears (K3's linears too: the same pack and kernel), K3's
# train cells (mma_prod_train_kernel, over K3's per-call pack of the
# training weights), and K4's backward products (mma_prod_bwd_kernel)
# and d_cv
BLOCK_PRODUCTS = ["cell0", "cell1", "q", "logits", "train_cell0",
                  "train_cell1", "bwd_cv", "bwd_top", "bwd_layer0",
                  "bwd_layer1"]


@pytest.mark.parametrize("R", [9, 25, 70, 150])
@pytest.mark.parametrize("product", BLOCK_PRODUCTS)
def test_kernel_block_model_computes_x_at_w(product, R):
    """The numpy model of a block of the tensor-core kernels, on the
    pack's tiles, gives x @ W for its 64 columns: a cell's block its
    units' four gates side by side (the epilogue's order), a linear's
    block its columns.  K4's backward blocks split the input axis over a
    cluster of 3 as its launches do, and the per-column epilogue's sum of
    their partials gives dz @ W^T in the last, ragged column block.  R
    ragged in the row tiles launch_prod takes: 9 rows of 16 (one row
    tile: a warp a column tile), 25 of 32, 70 of 128 and 150 of 160 (two
    warps a column tile, split by row tile)."""
    dims = "ragged" if product.startswith("bwd") else "kernel"
    H, E, A, V = DIMS[dims]
    w = _weights(dims)
    train = product.startswith("train_")
    if train:
        product = product[len("train_"):]
    # K3's per-call pack of its bf16 training weights, or the decode's
    step = fd.pack_decode_step(w) if train else fi.pack_step_weights_mma(w)
    rng = np.random.default_rng(5)
    cs = 1
    if product.startswith("cell"):
        l = int(product[4:])
        cat = _cells(w)[l].double().numpy()
        K = cat.shape[0]
        first = sum(c.shape[0] // 32 for c in _cells(w)[:l]) * (H // 16)
        tiles = step["cell"][first:first + (H // 16) * (K // 32)].view(
            H // 16, K // 32, -1).double().numpy()
        cb = 1
        cols = [q * H + 16 * cb + u for u in range(16) for q in range(4)]
    else:
        if product.startswith("bwd"):
            pack = fd.pack_backward_weights(w)
            i = {"bwd_cv": 0, "bwd_top": 1}.get(product)
            if i is None:
                i = 2 + int(product[len("bwd_layer"):])
            cat = bwd_transposes(w)[i]
            tiles = [pack["cv"], pack["top"], *pack["layer"]][i]
            cs = 3
        else:
            name = {"q": "wa", "logits": "out_w"}[product]
            cat = w[name].double().numpy()
            tiles = step[name]
        tiles = tiles.double().numpy()
        K = cat.shape[0]
        cb = tiles.shape[0] - 1     # the last block: ragged columns
        cols = list(range(64 * cb, min(64 * cb + 64, cat.shape[1])))
    x = torch.from_numpy(rng.standard_normal((R, K)).astype(
        np.float32)).to(BF).double().numpy()
    # block c of the cluster takes tiles [c n / cs, (c + 1) n / cs)
    n = K // 32
    P = np.stack([kernel_block(
        x[:, 32 * (c * n // cs):32 * ((c + 1) * n // cs)],
        tiles[cb][c * n // cs:(c + 1) * n // cs], product.startswith("cell"))
        for c in range(cs)])
    want = x @ cat[:, cols]
    np.testing.assert_allclose(P.sum(axis=0)[:R, :len(cols)], want,
                               rtol=1e-12, atol=1e-12)
    if cs > 1:
        np.testing.assert_allclose(
            bwd_epilogue_rows(P, cb, cat.shape[1], R), want, rtol=1e-12,
            atol=1e-12)
    assert not P[:, R:].any() and not P[:, :, len(cols):].any()


@pytest.mark.parametrize("dims", ["kernel", "ragged", "wide"])
def test_backward_mma_pack_unpacks_to_transposes(dims):
    """K4's pack at bf16: cv, top and each layer's matrix, unpacked from
    the fragment order, equal ctx_w[:H]^T, [wa^T; ctx_w[H:]^T] and [wh^T |
    wx^T] bit for bit, zero past the ragged columns; each (column blocks,
    K / 32, 2048), back to back in ``flat`` at the f32 layout's offsets,
    which k4_decoder_bwd.cu walks."""
    w = _weights(dims)
    p = fd.pack_backward_weights(w)
    p32 = fd.pack_backward_weights({k: v.float() for k, v in w.items()})
    views = [p["cv"], p["top"], *p["layer"]]
    views32 = [p32["cv"], p32["top"], *p32["layer"]]
    assert p["flat"].dtype == BF and p["flat"].numel() == p32["flat"].numel()
    off = 0
    for v, v32, m in zip(views, views32, bwd_transposes(w)):
        K, N = m.shape
        assert tuple(v.shape) == (-(-N // 64), K // 32, 2048)
        assert v.is_contiguous() and v.numel() == v32.numel()
        assert v.data_ptr() == p["flat"].data_ptr() + 2 * off
        off += v.numel()
        un = unpack_tiles(v.float().numpy(), K)        # (blocks, K, 64)
        flat = un.transpose(1, 0, 2).reshape(K, -1)
        np.testing.assert_array_equal(flat[:, :N], m)
        assert not flat[:, N:].any()
        # the column blocks the f32 mode keeps, tile by tile
        np.testing.assert_array_equal(un, v32.numpy())
    assert off == p["flat"].numel()
    assert any(m.shape[1] % 64 for m in bwd_transposes(w))


def test_k3_bf16_pack_is_the_decode_steps():
    """K3 packs its bf16 training weights per call in the decode step's
    tensor-core layout (pack_decode_step: pack_step_weights_mma), each
    layer's tiles at the offset k3_decoder_fwd.cu's loop adds (K 4H
    elements a layer, as in the column blocks); its f32 pack stays
    pack_step_weights'."""
    mcfg = dict(TINY_MODEL_CFG, rnn_config=dict(
        TINY_MODEL_CFG["rnn_config"], hidden_units=32, embedding_units=32,
        attn_units=64, dec_vocab_size=70))
    tp, _ = seq2seq.init_model(mcfg, seed=2)
    w = seq2seq.pack_decoder_weights(tp, BF)
    H, E, A = w["wh"].shape[1], w["embed"].shape[1], w["ctx_w"].shape[1]
    assert (H, E, A) == (32, 32, 64)
    assert fd.pack_decode_step is fi.pack_decode_step
    got = fd.pack_decode_step(w)
    want = fi.pack_step_weights_mma(w)
    for k in fi.STEP_ORDER:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    old = fi.pack_step_weights(w)
    assert got["cell"].numel() == old["cell"].numel()
    off = 0
    for l, cat in enumerate(_cells(w)):
        K = cat.shape[0]
        assert K == (E + A + H if l == 0 else 2 * H) and K % 32 == 0
        tiles = got["cell"].view(-1)[off:off + K * 4 * H].view(
            H // 16, K // 32, 2048)
        np.testing.assert_array_equal(
            unpack_tiles(tiles.float().numpy(), K).ravel(),
            old["cell"][off:off + K * 4 * H].float().numpy())
        off += K * 4 * H
    assert off == got["cell"].numel()
    w32 = seq2seq.pack_decoder_weights(tp)
    want32 = fi.pack_step_weights(w32)
    for k, v in fd.pack_decode_step(w32).items():
        assert torch.equal(v, want32[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_column_block_packs_unchanged(dtype):
    """The f32 decode pack (decode_weights) and pack_step_weights (K3's
    per-call pack at f32; at bf16 the column blocks that
    pack_step_weights_mma tiles) keep the column-block layout: equal bit
    for bit to the numpy model of it."""
    H, E, A, V = DIMS["kernel"]
    w = _weights("kernel")
    if dtype == "float32":
        w = {k: v.float() for k, v in w.items()}
    want = old_layout(w)
    got = fi.pack_step_weights(w)
    for k, v in want.items():
        assert got[k].dtype == w["wh"].dtype, k
        np.testing.assert_array_equal(got[k].float().numpy(), v)
    assert fi.pack_decode_step(w)["cell"].shape == (
        got["cell"].shape if dtype == "float32" else fi._step_shapes(
            H, L, E, A, V, mma=True)["cell"])


def test_f32_decode_weights_unchanged():
    """decode_weights at f32 holds pack_step_weights' layout, equal to the
    numpy model; at bf16 the tensor-core one, which unpacks to it."""
    mcfg = dict(TINY_MODEL_CFG, rnn_config=dict(
        TINY_MODEL_CFG["rnn_config"], dec_vocab_size=12))
    tp, _ = seq2seq.init_model(mcfg, seed=1)
    w32 = seq2seq.decode_weights(tp)
    for k, v in old_layout(w32).items():
        assert w32["step"][k].dtype == torch.float32
        np.testing.assert_array_equal(w32["step"][k].numpy(), v)
    w16 = seq2seq.decode_weights(tp, BF)
    assert w16["step"]["cell"].dim() == 2
    un = unpack_step(w16["step"], w16)
    for k, v in old_layout(w16).items():
        np.testing.assert_array_equal(un[k], v)


def test_step_weights_refuses_bf16_column_blocks():
    """A bf16 step in the column-block layout (pack_step_weights) is
    refused by name, before any launch."""
    H, E, A, V = DIMS["kernel"]
    w = _weights("kernel")
    w["step"] = fi.pack_step_weights(w)
    with pytest.raises(ValueError, match="tensor-core layout"):
        fi.step_weights(w, H, L, E, A, V, BF)


def test_decode_split_tells_the_products_apart():
    """chip_smoke's split of a profiled decode: within a step the product
    launches before attention are the L cells, then q; after it ctx, then
    logits; each kernel gets the part of its span past the end of those
    before it (overlapping programmatic dependent launches), and the
    gaps are the rest of the call's span."""
    import chip_smoke

    step = ["mma_prod_kernel<8, 4, true>"] * 2 + [
        "mma_prod_kernel<8, 4, false>", "attention_kernel<bf16>",
        "mma_prod_kernel<8, 4, false>", "mma_prod_kernel<8, 4, false>",
        "greedy_argmax_kernel"]
    spans, t = [], 0.0
    for _ in range(2):
        for i, name in enumerate(step):
            # each span starts 1 µs before the previous one ends
            spans.append((t - (1.0 if spans else 0.0), t + 10.0 * (i + 1),
                          name))
            t += 10.0 * (i + 1)
        t += 5.0    # the next step's first span starts 4 µs after
    parts = chip_smoke.split_spans(spans[::-1], layers=2)
    ms = {k: round(v * 1e3, 6) for k, v in parts.items()}
    assert ms == {"cells": 61.0, "q": 60.0, "ctx": 100.0, "logits": 120.0,
                  "attention": 80.0, "selection": 140.0, "other": 0.0,
                  "launch gaps": 4.0}, ms


def test_train_split_tells_the_launch_kinds_apart():
    """chip_smoke's split of a profiled K3 or K4 call by launch kind: the
    cell products with the train epilogue, the linears (K3's q, ctx and
    logits, K4's d_cv), K4's d_top (the first backward product after an
    attention backward) and layer backward products, attention of either
    mode, select_embed / head, the rest; each kernel gets the part of its
    span past the end of those before it, and the gaps are the rest of
    the call's span."""
    import chip_smoke

    k4_step = ["mma_prod_kernel<8, 4, false>", "attention_bwd_kernel<bf16>",
               "mma_prod_bwd_kernel<8, 4>", "mma_prod_bwd_kernel<8, 4>",
               "mma_prod_bwd_kernel<8, 4>"]
    k3_step = ["select_embed_kernel<bf16>", "mma_prod_train_kernel<8, 4>",
               "mma_prod_train_kernel<8, 4>", "mma_prod_kernel<8, 4, false>",
               "attention_train_kernel<bf16>", "mma_prod_kernel<8, 4, false>",
               "mma_prod_kernel<8, 4, false>"]
    names = (["head_kernel<bf16>"] + k4_step * 2
             + ["vectorized_elementwise_kernel"] + k3_step)
    spans, end = [], 0.0
    for name in names:
        # 10 µs each, starting 1 µs before the previous one ends; the
        # elementwise kernel 3 µs after
        start = end + 3.0 if "elementwise" in name else max(end - 1.0, 0.0)
        spans.append((start, start + 10.0, name))
        end = start + 10.0
    parts = chip_smoke.train_split_spans(spans[::-1])
    ms = {k: round(v * 1e3, 6) for k, v in parts.items()}
    assert ms == {"train cells": 18.0, "linears": 45.0, "d_top": 18.0,
                  "layer backward": 36.0, "attention": 27.0,
                  "select / head": 19.0, "other": 10.0,
                  "launch gaps": 3.0}, ms


# encoder widths (L, D2, H): es_en_20h's; H = 32 and 96, where K2's
# layer-0 N = H leaves its last column block ragged (and 2H = 192 splits
# a block between wh^T and wx^T); chip_smoke's DEEP_ENCODER stack, whose
# full waves take two launches
ENC_DIMS = {"es_en_20h": (3, 2, 256), "h32": (3, 2, 32), "h96": (3, 2, 96),
            "deep": (5, 2, 64)}


def _encoder(dims, seed=0):
    """(wx_rest, wh) in bf16 from a seeded numpy draw."""
    L_, D2, H = ENC_DIMS[dims]
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(BF) for shape in ((L_ - 1, D2, H, 4 * H),
                                          (L_, D2, H, 4 * H)))


def encoder_cells(wx_rest, wh):
    """{(l, d): (offset in the forward pack, [wx; wh] (K, 4H))}: layer 0
    (K = H, its input arrives projected) first, then (layer, direction)
    above, where k1_encoder.cu's cell_group looks."""
    L_, D2, H, H4 = wh.shape
    out = {}
    for l in range(L_):
        for d in range(D2):
            off = (d * H if l == 0
                   else D2 * H + ((l - 1) * D2 + d) * 2 * H) * H4
            out[l, d] = (off, torch.cat([wx_rest[l - 1, d], wh[l, d]])
                         if l else wh[0, d])
    return out


def encoder_transposes(wx_rest, wh):
    """{(l, d): (offset in the backward pack, [wh^T | wx^T] (4H, N))},
    where k2_encoder_bwd.cu's weight_at looks."""
    L_, D2, H, H4 = wh.shape
    b0, b1 = -(-H // 64), -(-2 * H // 64)
    out = {}
    for l in range(L_):
        for d in range(D2):
            off = (d * b0 if l == 0
                   else D2 * b0 + ((l - 1) * D2 + d) * b1) * H4 * 64
            m = wh[l, d].t()
            out[l, d] = (off, torch.cat([m, wx_rest[l - 1, d].t()], dim=1)
                         if l else m)
    return out


@pytest.mark.parametrize("dims", list(ENC_DIMS))
def test_encoder_mma_packs_unpack_to_their_matrices(dims):
    """K1's and K2's bf16 packs, unpacked from the fragment order, give
    each (layer, direction)'s [wx; wh] in unit blocks (gate q of unit
    16 c + u at column q * 16 + u of block c) and [wh^T | wx^T] with zero
    columns past N, bit for bit, at the f32 packs' offsets and size."""
    L_, D2, H = ENC_DIMS[dims]
    wx_rest, wh = _encoder(dims)
    fwd = fl.pack_encoder_step_weights(wx_rest, wh)
    bwd = fl.pack_encoder_backward_weights(wx_rest, wh)
    assert fwd.dtype == bwd.dtype == BF
    assert fwd.numel() == (2 * L_ - 1) * D2 * H * 4 * H
    assert bwd.numel() == fl.pack_encoder_backward_weights(
        wx_rest.float(), wh.float()).numel()
    for off, cat in encoder_cells(wx_rest, wh).values():
        K = cat.shape[0]
        tiles = fwd[off:off + K * 4 * H].view(H // 16, K // 32, 2048)
        blk = unpack_tiles(tiles.float().numpy(), K)
        got = blk.reshape(H // 16, K, 4, 16).transpose(1, 2, 0, 3)
        np.testing.assert_array_equal(got.reshape(K, 4 * H),
                                      cat.float().numpy())
    for off, m in encoder_transposes(wx_rest, wh).values():
        K, N = m.shape
        nb = -(-N // 64)
        tiles = bwd[off:off + nb * K * 64].view(nb, K // 32, 2048)
        flat = unpack_tiles(tiles.float().numpy(), K).transpose(
            1, 0, 2).reshape(K, -1)
        np.testing.assert_array_equal(flat[:, :N], m.float().numpy())
        assert not flat[:, N:].any()


# the encoder's wave products: a cell of layer 0 (one input segment, h),
# a cell of layer 1 (two: the layer below's output, then h), K2's linear
# of layer 0 (its last column block ragged) and of layer 1 (a block
# stitched from wh^T's last and wx^T's first columns)
ENC_PRODUCTS = ["cell0", "cell1", "bwd0", "bwd1"]


@pytest.mark.parametrize("R", [9, 25, 70, 150, 200])
@pytest.mark.parametrize("product", ENC_PRODUCTS)
def test_encoder_wave_block_model_computes_x_at_w(product, R):
    """The numpy model of a block of mma_wave_kernel, on the bf16 packs'
    tiles of direction 1 at the offsets the host loops give a wave's
    product, with the input axis split over a cluster of 3 as a wave's
    launch splits it (one tile a block for layer 0's cells here): the
    cluster's summed partials are x @ W -- a cell block's units' four
    gates side by side, which the eval and train epilogues read -- and
    for K2's linear the per-column sum of the wave's linear epilogue
    over the cluster gives dz @ [wh^T | wx^T] in column block 1 (at H =
    96 layer 0's last, ragged; layer 1's stitched from two matrices).
    Every 32-row tile a block stages lies in one input segment.  R in
    every row tiling of launch_wave: 9 rows of 16, 25 of 32, 70 of 128,
    150 of 160, 200 of 256."""
    wx_rest, wh = _encoder("h96")
    H = wh.shape[2]
    l, d, cb, cs = int(product[-1]), 1, 1, 3
    rng = np.random.default_rng(R)
    if product.startswith("cell"):
        off, cat = encoder_cells(wx_rest, wh)[l, d]
        K = cat.shape[0]
        tiles = fl.pack_encoder_step_weights(wx_rest, wh)[
            off:off + K * 4 * H].view(H // 16, K // 32, 2048)
        cols = [q * H + 16 * cb + u for u in range(16) for q in range(4)]
        segments = [H] * (l + 1)
    else:
        off, cat = encoder_transposes(wx_rest, wh)[l, d]
        K, N = cat.shape
        nb = -(-N // 64)
        tiles = fl.pack_encoder_backward_weights(wx_rest, wh)[
            off:off + nb * K * 64].view(nb, K // 32, 2048)
        cols = list(range(64 * cb, min(64 * cb + 64, N)))
        segments = [K]
    bounds = np.cumsum([0] + segments)
    x = torch.from_numpy(rng.standard_normal((R, K)).astype(np.float32)).to(
        BF).double().numpy()
    tiles, cat = tiles.double().numpy(), cat.double().numpy()
    n = K // 32
    parts = [range(c * n // cs, (c + 1) * n // cs) for c in range(cs)]
    for part in parts:
        assert len(part) >= 1
        for k in part:      # the tile's rows within one segment
            s = np.searchsorted(bounds, 32 * k, side="right")
            assert 32 * k + 31 < bounds[s]
    P = np.stack([kernel_block(x[:, 32 * p.start:32 * p.stop],
                               tiles[cb][p.start:p.stop],
                               product.startswith("cell")) for p in parts])
    want = x @ cat[:, cols]
    np.testing.assert_allclose(P.sum(axis=0)[:R, :len(cols)], want,
                               rtol=1e-12, atol=1e-12)
    if not product.startswith("cell"):
        assert len(cols) == (32 if l == 0 else 64)
        np.testing.assert_allclose(bwd_epilogue_rows(P, cb, N, R), want,
                                   rtol=1e-12, atol=1e-12)
    assert not P[:, R:].any() and not P[:, :, len(cols):].any()


def encoder_column_blocks(wx_rest, wh):
    """numpy model of the f32 encoder packs as they were before the bf16
    ones took the fragment order: (forward, backward) flat arrays, each
    (layer, direction)'s cell_blocks / column_blocks back to back."""
    fwd = [cell_blocks(cat.numpy(), wh.shape[2]).ravel()
           for _, cat in encoder_cells(wx_rest, wh).values()]
    bwd = [column_blocks(m.numpy()).ravel()
           for _, m in encoder_transposes(wx_rest, wh).values()]
    return np.concatenate(fwd), np.concatenate(bwd)


@pytest.mark.parametrize("dims", ["h32", "h96", "deep"])
def test_f32_encoder_packs_unchanged(dims):
    """pack_encoder_step_weights and pack_encoder_backward_weights at f32
    keep their column-block layout bit for bit."""
    wx_rest, wh = (t.float() for t in _encoder(dims))
    fwd, bwd = encoder_column_blocks(wx_rest, wh)
    got = fl.pack_encoder_step_weights(wx_rest, wh)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), fwd)
    got = fl.pack_encoder_backward_weights(wx_rest, wh)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), bwd)


def test_decode_weights_encoder_pack():
    """decode_weights keeps K1 eval's pack under "enc": at bf16 the
    fragment-order pack of the bf16 weights, which unpacks to the f32
    layout of the same values; at f32 the column blocks, unchanged."""
    mcfg = dict(TINY_MODEL_CFG, rnn_config=dict(
        TINY_MODEL_CFG["rnn_config"], hidden_units=64, dec_vocab_size=12))
    tp, _ = seq2seq.init_model(mcfg, seed=3)
    wx_rest, wh, b, packed = seq2seq.decode_weights(tp, BF)["enc"]
    H = wh.shape[2]
    assert (H, packed.dtype, b.dtype) == (32, BF, torch.float32)
    assert torch.equal(packed, fl.pack_encoder_step_weights(wx_rest, wh))
    f32 = seq2seq.decode_weights(tp)["enc"]
    assert f32[3].dtype == torch.float32
    np.testing.assert_array_equal(
        f32[3].numpy(), encoder_column_blocks(f32[0], f32[1])[0])
    blocks = fl.pack_encoder_step_weights(wx_rest.float(), wh.float())
    for off, cat in encoder_cells(wx_rest, wh).values():
        K = cat.shape[0]
        np.testing.assert_array_equal(
            unpack_tiles(packed[off:off + K * 4 * H].view(
                H // 16, K // 32, 2048).float().numpy(), K).ravel(),
            blocks[off:off + K * 4 * H].numpy())
