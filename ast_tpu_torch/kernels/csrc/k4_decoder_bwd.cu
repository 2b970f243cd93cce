// K4: reverse-time backward of the fused attention-LSTM decoder.
//
// Replaces ast_tpu/ops/fused_decoder.py _bwd_kernel (via decoder_backward /
// fused_decoder_apply's VJP): walking t from U-1 to 0, the gradients of
// every product's inputs -- d_pre = d_ht (1 - ht^2) with d_ht the loss's
// cotangent plus the input-feeding gradient from step t+1; d_cv =
// d_pre @ ctx_w[:He]^T; the attention backward against the row's own
// encoder states, He wide (d_alphas, d_scores = alphas (d_alphas -
// <d_alphas, alphas>), d_q); d_top = d_q @ wa^T + d_pre @ ctx_w[He:]^T
// (H wide); then per layer
// the dropout mask on the arriving gradient, the gate backward with the
// carried dh / dc, and dz @ [wh^T | wx^T]; layer 0's input gradient
// splits into the embedding's (masked again) and the previous step's
// d_ht.  d_enc and the weight gradients are time-batched GEMMs outside,
// as on the TPU.
//
// What bounds it on the H100: U dependent steps of small products at B
// rows against about 29 MB of transposed f32 weights (L2-resident) -- the
// bytes a block keeps in flight from L2, the products' cluster barriers
// and launch latency, not FLOPs.  Design: 3 + L launches a step, each a
// programmatic dependent launch (every kernel waits for its predecessor
// before it touches memory): d_cv, the attention backward, d_top, and one
// product per LSTM layer that yields the dh carry and the layer below's
// gradient at once.  The products are decode_step.cu's, the ones K5 and
// K6 decode with: each weight is read once a step by the block that owns
// its 64 output columns for all B rows, as bulk copies of tiles from the
// transposed matrices that ops/fused_decoder.pack_backward_weights packs
// once per call as (column blocks, K, 64); the input axis (4H for the
// layer products) is split over a thread-block cluster and summed in
// distributed shared memory.  [d_q | d_pre] share one product against
// [wa^T ; ctx_w[He:]^T].  What a summed row feeds is elementwise, so it
// runs in the product's epilogue (BwdEpilogue) and not as launches of its
// own: d_top's epilogue is the top layer's cell backward, layer l's
// product ends in layer l-1's cell backward, and layer 0's in the
// embedding gradient and the step before's d_pre.  The attention backward
// runs a cluster per row, which splits T' (decode_step.cu, ATTN_BWD).  A
// product reads only its input rows (d_q, d_pre or its layer's dz) and
// the residuals; its epilogue writes the layer's carry and the layer
// below's dz and dc, each element by one thread: no block of a launch
// reads what another writes.
//
// bfloat16 (ast_tpu's compute_dtype bfloat16; k4_decoder_backward_bf16):
// K3's bf16 streams (acts, c_all, alphas; c0 rounded to bf16, ast_tpu's
// c_prev of step 0) read widened, the transposed matrices and the encoder
// states in bf16, the products rounding d_pre, d_q and dz as they stage
// them, on the tensor cores (mma.sync bf16 -> f32 over the matrices'
// B-fragment tiles, which pack_backward_weights lays out at bf16; the
// epilogues the f32 mode's), and the attention backward rounding
// d_scores before the d_q sum (d_cv stays f32 against enc).  The output
// streams dz, d_pre, d_scores, d_cv, d_q, d_emb are stored in bf16; what
// a later launch reads stays f32 in small buffers beside them (each
// layer's dz (L, B, 4H), the step's d_pre (B, A), d_cv and d_q (B, H));
// dh0, dc0 f32.
#include <type_traits>

#include "common.cuh"

namespace {

// d_pre = d_ht (1 - ht^2) over n elements: the last step, which no
// input-feeding gradient reaches; at T = bf16 also to its stream d_pre_res.
template <typename T>
__global__ void head_kernel(const float* d_ht, const float* ht, float* d_pre,
                            T* d_pre_res, long n) {
  ast::grid_dep_wait();
  ast::grid_dep_launch();
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float h = ht[i];
  const float d = d_ht[i] * (1.f - h * h);
  d_pre[i] = d;
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    ast::st_res(d_pre_res + i, d);
}

// The backward's inputs, streams and carries.  W: the streams' and the
// packed matrices' type.  At bf16 dz_w (L, B, 4H), d_pre_w (B, A), d_cv_w
// and d_q_w (B, H) hold the f32 values the next launches read.
template <typename W>
struct Bwd {
  const W *acts, *c_all, *c0, *alphas;
  const float *ht, *d_ht;
  const W *enc, *w_cv, *w_top, *w_t;
  float *dh, *dc;
  W *dz, *d_pre, *d_scores, *d_cv, *d_q, *d_emb;
  float *dz_w, *d_pre_w, *d_cv_w, *d_q_w;
  int B, T, H, L, E, A, U;
  unsigned seed, thr_e;
  float inv_e;
  unsigned thr_r;
  float inv_r;
  unsigned row0;  // the global index of row 0 (the dropout masks')
  int He;         // the encoder states' width
};

template <typename W>
int decoder_backward(const Bwd<W>& p, cudaStream_t s) {
  constexpr bool BF = std::is_same<W, __nv_bfloat16>::value;
  const int B = p.B, T = p.T, H = p.H, L = p.L, E = p.E, A = p.A, U = p.U,
            He = p.He;
  const long H4 = 4L * H, BH = (long)B * H, BA = (long)B * A,
             BHe = (long)B * He;
  auto width = [=](int l) { return H + (l ? H : E + A); };
  // the f32 d_pre of step t, which its products read
  auto d_pre_at = [&](long t) -> float* {
    if constexpr (BF) return p.d_pre_w;
    else return p.d_pre + t * BA;
  };
  // layer l's cell backward at step t, fed by the product above it
  auto cell = [&](int t, int l) {
    const long tl = (long)t * L + l;
    ast::CellBwdArgsT<W> c = {};
    c.dh = p.dh + l * BH;
    c.dh_ld = H;
    c.acts = p.acts + tl * B * H4;
    c.c_new = p.c_all + tl * BH;
    c.c_prev = t ? p.c_all + (tl - L) * BH : p.c0 + l * BH;
    c.dc = p.dc + l * BH;
    c.dz = p.dz + tl * B * H4;
    if constexpr (BF) c.dz_f32 = p.dz_w + l * B * H4;
    c.seed = p.seed + 2u * (unsigned)tl + 1u;
    c.threshold = p.thr_r;
    c.keep_scale = p.inv_r;
    c.R = B;
    c.H = H;
    c.flat0 = p.row0 * (unsigned)H;
    return c;
  };
  auto bwd_prod = [&](const ast::Prod& g, const ast::BwdEpilogueT<W>& e) {
    if constexpr (BF) return ast::launch_bwd_prod_bf16(g, e, s);
    else return ast::launch_bwd_prod(g, e, s);
  };
  if (U <= 0) return 0;
  constexpr int kThreads = 256;
  AST_RETURN_IF_ERR(ast::launch_ex(
      head_kernel<W>, dim3((unsigned)((BA + kThreads - 1) / kThreads)),
      dim3(kThreads), 0, 1, s, p.d_ht + (U - 1) * BA, p.ht + (U - 1) * BA,
      d_pre_at(U - 1), p.d_pre + (U - 1) * BA, BA));
  for (int t = U - 1; t >= 0; --t) {
    float* d_pre_t = d_pre_at(t);
    float *d_cv_t, *d_q_t;
    if constexpr (BF) {
      d_cv_t = p.d_cv_w;
      d_q_t = p.d_q_w;
    } else {
      d_cv_t = p.d_cv + (long)t * BHe;
      d_q_t = p.d_q + (long)t * BHe;
    }

    ast::Prod cv = {};
    cv.seg[0] = ast::Seg{d_pre_t, nullptr, A};
    cv.nseg = 1;
    cv.w = p.w_cv;
    cv.R = B;
    cv.N = He;
    cv.out = d_cv_t;
    if constexpr (BF) {
      cv.out16 = p.d_cv + (long)t * BHe;
      AST_RETURN_IF_ERR(ast::launch_linear_prod_bf16(cv, s));
      AST_RETURN_IF_ERR(ast::launch_attention_bwd_bf16(
          p.enc, p.alphas + (long)t * B * T, d_cv_t,
          p.d_scores + (long)t * B * T, d_q_t, p.d_q + (long)t * BHe, B, T,
          He, s));
    } else {
      AST_RETURN_IF_ERR(ast::launch_linear_prod(cv, s));
      AST_RETURN_IF_ERR(ast::launch_attention_bwd(
          p.enc, p.alphas + (long)t * B * T, d_cv_t,
          p.d_scores + (long)t * B * T, d_q_t, B, T, He, s));
    }
    // d_top = [d_q | d_pre] @ [wa^T ; ctx_w[He:]^T], into the top layer's
    // cell backward
    ast::Prod tp = {};
    tp.seg[0] = ast::Seg{d_q_t, nullptr, He};
    tp.seg[1] = ast::Seg{d_pre_t, nullptr, A};
    tp.nseg = 2;
    tp.w = p.w_top;
    tp.R = B;
    tp.N = H;
    ast::BwdEpilogueT<W> te = {};
    te.cell = cell(t, L - 1);
    AST_RETURN_IF_ERR(bwd_prod(tp, te));

    const W* w_l = p.w_t;
    for (int l = 0; l < L - 1; ++l) w_l += H4 * ((width(l) + 63) / 64 * 64);
    for (int l = L - 1; l >= 0; --l) {
      // [dh carry | dx] = dz @ [wh^T | wx^T]: the carry to dh, dx into the
      // cell backward of the layer below or, from layer 0, into d_emb and
      // the step before's d_pre
      ast::Prod g = {};
      const long dz_at = ((long)t * L + l) * B * H4;
      const float* dz_in;
      if constexpr (BF) dz_in = p.dz_w + l * B * H4;
      else dz_in = p.dz + dz_at;
      g.seg[0] = ast::Seg{dz_in, nullptr, (int)H4};
      g.nseg = 1;
      g.w = w_l;
      g.R = B;
      g.N = width(l);
      g.out = p.dh + l * BH;
      ast::BwdEpilogueT<W> e = {};
      e.n_carry = H;
      if (l > 0) {
        e.cell = cell(t, l - 1);
        w_l -= H4 * ((width(l - 1) + 63) / 64 * 64);
      } else {
        e.d_emb = p.d_emb + (long)t * B * E;
        e.E = E;
        e.A = A;
        e.seed = p.seed + 2u * t;
        e.threshold = p.thr_e;
        e.flat0 = p.row0 * (unsigned)E;
        e.inv = p.inv_e;
        if (t > 0) {
          e.d_ht = p.d_ht + (t - 1) * BA;
          e.ht = p.ht + (t - 1) * BA;
          e.d_pre = d_pre_at(t - 1);
          e.d_pre_res = p.d_pre + (t - 1) * BA;
        }
      }
      AST_RETURN_IF_ERR(bwd_prod(g, e));
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Residuals of K3: acts (U, L, B, 4H), c_all (U, L, B, H), alphas (U, B,
// T), ht (U, B, A); c0 (L, B, H); d_ht (U, B, A) the loss's cotangent;
// enc (B, T, He).  Transposed weights, each packed as (column blocks, K,
// 64) by ops/fused_decoder.pack_backward_weights: w_cv = ctx_w[:He]^T (A,
// He), w_top = [wa^T ; ctx_w[He:]^T] (He + A, H), w_t: per layer [wh^T |
// wx^T] (4H, H + E + A for layer 0, 2H above), back to back.  Carries,
// zero on entry: dh (L, B, H), dh0 on exit; dc (L, B, H), dc0 on exit.
// Outputs: dz (U, L, B, 4H), d_pre (U, B, A), d_scores (U, B, T), d_cv,
// d_q (U, B, He), d_emb (U, B, E).  Dropout as in K3 (the masks of the
// global rows row_offset + r), kept values times inv_e / inv_r =
// 1 / (1 - rate).  E, A, H and He must be multiples of 32.
AST_EXPORT int k4_decoder_backward(
    const float* acts, const float* c_all, const float* c0,
    const float* alphas, const float* ht, const float* d_ht,
    const float* enc, const float* w_cv, const float* w_top,
    const float* w_t, float* dh, float* dc, float* dz, float* d_pre,
    float* d_scores, float* d_cv, float* d_q, float* d_emb, int B, int T,
    int H, int L, int E, int A, int U, int row_offset, unsigned seed,
    unsigned thr_e, float inv_e, unsigned thr_r, float inv_r, int He,
    void* stream) {
  Bwd<float> p = {acts,     c_all,   c0,   alphas,  ht,    d_ht,  enc,
                  w_cv,     w_top,   w_t,  dh,      dc,    dz,    d_pre,
                  d_scores, d_cv,    d_q,  d_emb,   nullptr, nullptr,
                  nullptr,  nullptr, B,    T,       H,     L,     E,
                  A,        U,       seed, thr_e,   inv_e, thr_r, inv_r,
                  (unsigned)row_offset, He};
  return decoder_backward(p, static_cast<cudaStream_t>(stream));
}

// bf16: acts, c_all, c0 (K3's c0 rounded), alphas, enc, the packed
// transposed matrices (each (column blocks, K / 32, 2048) tiles in the
// B-fragment order: the same sizes and offsets) and the output streams
// dz, d_pre, d_scores, d_cv, d_q, d_emb in bfloat16 (shapes as above);
// ht, d_ht and the carries f32.
// f32 scratch: dz_w (L, B, 4H), d_pre_w (B, A), d_cv_w and d_q_w (B, He).
AST_EXPORT int k4_decoder_backward_bf16(
    const __nv_bfloat16* acts, const __nv_bfloat16* c_all,
    const __nv_bfloat16* c0, const __nv_bfloat16* alphas, const float* ht,
    const float* d_ht, const __nv_bfloat16* enc, const __nv_bfloat16* w_cv,
    const __nv_bfloat16* w_top, const __nv_bfloat16* w_t, float* dh,
    float* dc, __nv_bfloat16* dz, __nv_bfloat16* d_pre,
    __nv_bfloat16* d_scores, __nv_bfloat16* d_cv, __nv_bfloat16* d_q,
    __nv_bfloat16* d_emb, float* dz_w, float* d_pre_w, float* d_cv_w,
    float* d_q_w, int B, int T, int H, int L, int E, int A, int U,
    int row_offset, unsigned seed, unsigned thr_e, float inv_e,
    unsigned thr_r, float inv_r, int He, void* stream) {
  Bwd<__nv_bfloat16> p = {acts,  c_all,   c0,      alphas,  ht,    d_ht,
                          enc,   w_cv,    w_top,   w_t,     dh,    dc,
                          dz,    d_pre,   d_scores, d_cv,   d_q,   d_emb,
                          dz_w,  d_pre_w, d_cv_w,  d_q_w,   B,     T,
                          H,     L,       E,       A,       U,     seed,
                          thr_e, inv_e,   thr_r,   inv_r,
                          (unsigned)row_offset, He};
  return decoder_backward(p, static_cast<cudaStream_t>(stream));
}
