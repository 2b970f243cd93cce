// K2: reverse-time backward of the fused stacked (bi)LSTM encoder.
//
// Replaces ast_tpu/ops/fused_lstm.py _bwd_kernel (via _bwd_rule): for
// every cell (step t, layer l, direction d) it regenerates the layer's
// dropout mask, applies it to the gradient arriving from above (douts
// for the top layer, dz_{l+1} @ wx^T below it), runs the gate backward
// with the carried dh / dc, and writes dz.  The weight gradients are
// time-batched GEMMs outside, as on the TPU.
//
// What bounds it on the H100: like K1, a chain of dependent steps of small
// products -- per cell B rows x 4H inputs x (H or 2H) outputs -- bound by
// launch latency and by what a launch pulls from L2 (the transposed
// weights are L2-resident), not by FLOPs.  Design: cell (t, l) needs only
// the products of (t + 1, l) and (t, l + 1), so the cells with
// (T - 1 - t) + (L - 1 - l) = v are independent: wave v, T + L - 1 of
// them, in the order ops/fused_lstm.wave_schedule gives.  A wave is two
// launches over all its cells and directions: the elementwise cell
// backward (cell_bwd_kernel below), then one grouped product dz @ [wh^T |
// wx^T] (decode_step.cu's product as a Wave of linear products) that
// yields each layer's next dh carry and the layer below's input gradient
// at once.  The transposed matrices are packed once per call by
// ops/fused_lstm.pack_encoder_backward_weights as [layer][direction]
// [column block][k][64], so a block reads its weight tiles as 8 KB bulk
// copies and each weight once a wave; the input axis (4H) is split over a
// thread-block cluster.  Each layer's product writes its own [dh | dx]
// carry, which the next wave's cell backwards of the same layer (at
// t - 1) and of the layer below (at t) read before that wave's product
// rewrites it.  Every launch is a programmatic dependent launch and waits
// for the one before it before its first global access, so stream order
// separates them.
//
// bfloat16 (ast_tpu's compute_dtype bfloat16): K1's residual streams
// arrive in bf16 and are read widened; dz is computed in f32 and stored in
// bf16 (ast_tpu's out_shape in acts.dtype), and also in f32 to a scratch
// row of its wave group, which the wave's product reads and rounds to
// bf16 as it stages it (ast_tpu's dz.astype(wh.dtype)) against the bf16
// transposed weights; the carries, dc and the cotangents stay f32.  The
// product runs on the tensor cores (decode_step.cu's mma_wave_kernel:
// mma.sync m16n8k16 bf16 -> f32) over tiles in their B-fragment order
// (pack_encoder_backward_weights at bf16: per (layer, direction)
// (column blocks, 4H / 32, 2048), a ragged N through zero columns), its
// per-column epilogue reading one partial a block of the cluster.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// One cell's backward, elementwise over (R, H); cons and dh are read from
// rows of `ld` floats (column 0 .. H - 1).  T: the residual streams' type.
template <typename T>
struct BwdCell {
  const float* cons; int cons_ld;   // the gradient from above
  const float* dh; int dh_ld;       // the carried dh
  const T* acts;                    // (R, 4H)
  const T* c_new;                   // (R, H)
  const T* c_prev;                  // (R, H); nullptr = 0
  float* dc;                        // (R, H) carry, in place
  T* dz;                            // (R, 4H)
  float* dz_f32;                    // (R, 4H), bf16 only: dz unrounded
  unsigned seed, flat0;             // the mask's seed and first flat index
};

template <typename T>
struct BwdCells {
  BwdCell<T> g[ast::MAX_WAVE_GROUPS];
  unsigned threshold;
  float keep_scale;
  int R, H;
};

// Cell blockIdx.y of the wave, one thread per (row, unit):  cons =
// dropout(cons) (the forward's mask, kept values times keep_scale), dh =
// dh_carry + cons,
//   dc = dc + dh * o * (1 - tanh(c)^2),  dz = [dc g i(1-i) |
//   dc c_prev f(1-f) | dc i (1-g^2) | dh tanh(c) o(1-o)],  dc <- dc * f.
template <typename T>
__global__ void __launch_bounds__(kThreads) cell_bwd_kernel(BwdCells<T> w) {
  ast::grid_dep_wait();
  ast::grid_dep_launch();
  const BwdCell<T>& a = w.g[blockIdx.y];
  const int H = w.H;
  const long idx = (long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long)w.R * H) return;
  const int r = (int)(idx / H), j = (int)(idx % H);
  const long H4 = 4L * H;
  float cons = a.cons[(long)r * a.cons_ld + j];
  if (w.threshold)
    cons = ast::drop_hash(a.flat0 + (unsigned)idx, a.seed) < w.threshold
               ? 0.f
               : cons * w.keep_scale;
  const float dh = a.dh[(long)r * a.dh_ld + j] + cons;
  const T* ac = a.acts + (long)r * H4 + j;
  const float ig = ast::ld_res(ac), fg = ast::ld_res(ac + H),
              gg = ast::ld_res(ac + 2 * H), og = ast::ld_res(ac + 3 * H);
  const float tc = tanhf(ast::ld_res(a.c_new + idx));
  const float cp = a.c_prev ? ast::ld_res(a.c_prev + idx) : 0.f;
  const float dc = a.dc[idx] + dh * og * (1.f - tc * tc);
  a.dc[idx] = dc * fg;
  const float d0 = dc * gg * ig * (1.f - ig);
  const float d1 = dc * cp * fg * (1.f - fg);
  const float d2 = dc * ig * (1.f - gg * gg);
  const float d3 = dh * tc * og * (1.f - og);
  T* dz = a.dz + (long)r * H4 + j;
  ast::st_res(dz, d0);
  ast::st_res(dz + H, d1);
  ast::st_res(dz + 2 * H, d2);
  ast::st_res(dz + 3 * H, d3);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    float* dzf = a.dz_f32 + (long)r * H4 + j;
    dzf[0] = d0;
    dzf[H] = d1;
    dzf[2 * H] = d2;
    dzf[3 * H] = d3;
  }
}

// The reverse waves, T the residual streams' type (float, or bf16 with
// dz_work the (MAX_WAVE_GROUPS, B, 4H) f32 scratch of a launch's groups).
template <typename T>
int encoder_backward(const T* acts, const T* c_all, const T* w_t,
                     const float* douts, float* carry, float* dc, T* dz,
                     float* dz_work, const int* cells, const int* wave_start,
                     int n_waves, int L, int D2, int B, int H,
                     int row_offset, int global_rows, unsigned seed,
                     unsigned threshold, float keep_scale, void* stream) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long H4 = 4L * H, BH = (long)B * H;
  auto width = [H](int l) { return l ? 2 * H : H; };
  // layer l's carry and transposed weights in direction d
  auto carry_at = [=](int l, int d) {
    return carry + (l ? D2 * BH + ((long)(l - 1) * D2 + d) * 2 * BH : d * BH);
  };
  auto weight_at = [=](int l, int d) {
    const long blk = H4 * 64, b0 = (H + 63) / 64, b1 = (2 * H + 63) / 64;
    return w_t + blk * (l ? D2 * b0 + ((long)(l - 1) * D2 + d) * b1 : d * b0);
  };
  BwdCells<T> cw = {};
  cw.threshold = threshold;
  cw.keep_scale = keep_scale;
  cw.R = B;
  cw.H = H;
  ast::Wave<ast::NoExtra> pw;
  pw.n = 0;
  const unsigned blocks = (unsigned)((BH + kThreads - 1) / kThreads);
  auto flush = [&]() -> cudaError_t {
    if (pw.n == 0) return cudaSuccess;
    cudaError_t err = ast::launch_ex(cell_bwd_kernel<T>, dim3(blocks, pw.n),
                                     dim3(kThreads), 0, 1, s, cw);
    if (err == cudaSuccess)
      err = BF ? ast::launch_linear_wave_bf16(pw, s)
               : ast::launch_linear_wave(pw, s);
    pw.n = 0;
    return err;
  };
  for (int i = 0; i < n_waves; ++i) {
    for (int k = wave_start[i]; k < wave_start[i + 1]; ++k) {
      const int t = cells[2 * k], l = cells[2 * k + 1];
      const long tl = (long)t * L + l;
      for (int d = 0; d < D2; ++d) {
        const long at = (tl * D2 + d) * BH;  // in a (T, L, D2, B, H)
        BwdCell<T>& c = cw.g[pw.n];
        c = BwdCell<T>{};
        if (l == L - 1) {
          c.cons = douts + ((long)t * D2 + d) * BH;
          c.cons_ld = H;
        } else {
          c.cons = carry_at(l + 1, d) + H;   // dx of the layer above
          c.cons_ld = 2 * H;
        }
        c.dh = carry_at(l, d);
        c.dh_ld = width(l);
        c.acts = acts + at * 4;
        c.c_new = c_all + at;
        c.c_prev = t ? c_all + at - (long)L * D2 * BH : nullptr;
        c.dc = dc + ((long)l * D2 + d) * BH;
        c.dz = dz + at * 4;
        if constexpr (BF) c.dz_f32 = dz_work + (long)pw.n * B * H4;
        c.seed = seed + (unsigned)tl;
        // K1's mask: over the global batch's (D2, global_rows, H)
        c.flat0 = ((unsigned)d * (unsigned)global_rows +
                   (unsigned)row_offset) * (unsigned)H;

        ast::Prod& g = pw.p[pw.n];
        g = ast::Prod{};
        if constexpr (BF)
          g.seg[0] = ast::Seg{c.dz_f32, nullptr, (int)H4};
        else
          g.seg[0] = ast::Seg{c.dz, nullptr, (int)H4};
        g.nseg = 1;
        g.w = weight_at(l, d);
        g.R = B;
        g.N = width(l);
        g.out = carry_at(l, d);
        if (++pw.n == ast::MAX_WAVE_GROUPS)  // a wide wave takes several
          AST_RETURN_IF_ERR(flush());
      }
    }
    AST_RETURN_IF_ERR(flush());
  }
  return (int)cudaGetLastError();
}

}  // namespace

// acts (T, L, D2, B, 4H), c_all (T, L, D2, B, H): K1's residuals.
// w_t: per (layer, direction) [wh^T | wx^T] as (column blocks, 4H, 64),
//      H columns for layer 0 and 2H above, zero-padded to whole blocks.
// douts (T, D2, B, H): cotangent of the top layer's (post-dropout) output.
// carry: per layer (D2, B, H) for l = 0 and (D2, B, 2H) above, back to
//        back; columns 0..H-1 hold dh_fin on entry.
// dc (L, D2, B, H): dc_fin on entry.  dz (T, L, D2, B, 4H): output.
// cells, wave_start, n_waves: the reverse wave schedule (host memory).
// row_offset, global_rows: the rows' place in the global batch, as K1's.
AST_EXPORT int k2_encoder_backward(const float* acts, const float* c_all,
                                   const float* w_t, const float* douts,
                                   float* carry, float* dc, float* dz,
                                   const int* cells, const int* wave_start,
                                   int n_waves, int L, int D2, int B, int H,
                                   int row_offset, int global_rows,
                                   unsigned seed, unsigned threshold,
                                   float keep_scale, void* stream) {
  return encoder_backward<float>(acts, c_all, w_t, douts, carry, dc, dz,
                                 nullptr, cells, wave_start, n_waves, L, D2,
                                 B, H, row_offset, global_rows, seed,
                                 threshold, keep_scale, stream);
}

// The rows of k2_encoder_backward_bf16's dz_work, which the caller
// allocates: one a product of a launch.
AST_EXPORT int k2_work_rows() { return ast::MAX_WAVE_GROUPS; }

// bf16: acts, c_all, w_t and dz in bfloat16 (the rest as above); dz_work:
// (k2_work_rows(), B, 4H) f32 scratch.
AST_EXPORT int k2_encoder_backward_bf16(
    const __nv_bfloat16* acts, const __nv_bfloat16* c_all,
    const __nv_bfloat16* w_t, const float* douts, float* carry, float* dc,
    __nv_bfloat16* dz, float* dz_work, const int* cells,
    const int* wave_start, int n_waves, int L, int D2, int B, int H,
    int row_offset, int global_rows, unsigned seed, unsigned threshold,
    float keep_scale, void* stream) {
  return encoder_backward<__nv_bfloat16>(
      acts, c_all, w_t, douts, carry, dc, dz, dz_work, cells, wave_start,
      n_waves, L, D2, B, H, row_offset, global_rows, seed, threshold,
      keep_scale, stream);
}
