// K4: reverse-time backward of the fused attention-LSTM decoder.
//
// Replaces ast_tpu/ops/fused_decoder.py _bwd_kernel (via decoder_backward /
// fused_decoder_apply's VJP): walking t from U-1 to 0, the gradients of
// every product's inputs -- d_pre = d_ht (1 - ht^2) with d_ht the loss's
// cotangent plus the input-feeding gradient from step t+1; d_cv =
// d_pre @ ctx_w[:H]^T; the attention backward against the row's own
// encoder states (d_alphas, d_scores = alphas (d_alphas - <d_alphas,
// alphas>), d_q); d_top = d_q @ wa^T + d_pre @ ctx_w[H:]^T; then per layer
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
// [wa^T ; ctx_w[H:]^T].  What a summed row feeds is elementwise, so it
// runs in the product's epilogue (BwdEpilogue) and not as launches of its
// own: d_top's epilogue is the top layer's cell backward, layer l's
// product ends in layer l-1's cell backward, and layer 0's in the
// embedding gradient and the step before's d_pre.  The attention backward
// runs a cluster per row, which splits T' (decode_step.cu, ATTN_BWD).  A
// product reads only its input rows (d_q, d_pre or its layer's dz) and
// the residuals; its epilogue writes the layer's carry and the layer
// below's dz and dc, each element by one thread: no block of a launch
// reads what another writes.
#include "common.cuh"

namespace {

// d_pre = d_ht (1 - ht^2) over n elements: the last step, which no
// input-feeding gradient reaches.
__global__ void head_kernel(const float* d_ht, const float* ht, float* d_pre,
                            long n) {
  ast::grid_dep_wait();
  ast::grid_dep_launch();
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float h = ht[i];
  d_pre[i] = d_ht[i] * (1.f - h * h);
}

}  // namespace

// Residuals of K3: acts (U, L, B, 4H), c_all (U, L, B, H), alphas (U, B,
// T), ht (U, B, A); c0 (L, B, H); d_ht (U, B, A) the loss's cotangent;
// enc (B, T, H).  Transposed weights, each packed as (column blocks, K,
// 64) by ops/fused_decoder.pack_backward_weights: w_cv = ctx_w[:H]^T (A,
// H), w_top = [wa^T ; ctx_w[H:]^T] (H + A, H), w_t: per layer [wh^T |
// wx^T] (4H, H + E + A for layer 0, 2H above), back to back.  Carries,
// zero on entry: dh (L, B, H), dh0 on exit; dc (L, B, H), dc0 on exit.
// Outputs: dz (U, L, B, 4H), d_pre (U, B, A), d_scores (U, B, T), d_cv,
// d_q (U, B, H), d_emb (U, B, E).  Dropout as in K3, kept values times
// inv_e / inv_r = 1 / (1 - rate).  E, A and H must be multiples of 32.
AST_EXPORT int k4_decoder_backward(
    const float* acts, const float* c_all, const float* c0,
    const float* alphas, const float* ht, const float* d_ht,
    const float* enc, const float* w_cv, const float* w_top,
    const float* w_t, float* dh, float* dc, float* dz, float* d_pre,
    float* d_scores, float* d_cv, float* d_q, float* d_emb, int B, int T,
    int H, int L, int E, int A, int U, unsigned seed, unsigned thr_e,
    float inv_e, unsigned thr_r, float inv_r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long H4 = 4L * H, BH = (long)B * H, BA = (long)B * A;
  auto width = [=](int l) { return H + (l ? H : E + A); };
  // layer l's cell backward at step t, fed by the product above it
  auto cell = [=](int t, int l) {
    const long tl = (long)t * L + l;
    ast::CellBwdArgs c = {};
    c.dh = dh + l * BH;
    c.dh_ld = H;
    c.acts = acts + tl * B * H4;
    c.c_new = c_all + tl * BH;
    c.c_prev = t ? c_all + (tl - L) * BH : c0 + l * BH;
    c.dc = dc + l * BH;
    c.dz = dz + tl * B * H4;
    c.seed = seed + 2u * (unsigned)tl + 1u;
    c.threshold = thr_r;
    c.keep_scale = inv_r;
    c.R = B;
    c.H = H;
    return c;
  };
  if (U <= 0) return 0;
  constexpr int kThreads = 256;
  AST_RETURN_IF_ERR(ast::launch_ex(
      head_kernel, dim3((unsigned)((BA + kThreads - 1) / kThreads)),
      dim3(kThreads), 0, 1, s, d_ht + (U - 1) * BA, ht + (U - 1) * BA,
      d_pre + (U - 1) * BA, BA));
  for (int t = U - 1; t >= 0; --t) {
    float* d_pre_t = d_pre + t * BA;
    float* d_cv_t = d_cv + (long)t * BH;
    float* d_q_t = d_q + (long)t * BH;

    ast::Prod cv = {};
    cv.seg[0] = ast::Seg{d_pre_t, nullptr, A};
    cv.nseg = 1;
    cv.w = w_cv;
    cv.R = B;
    cv.N = H;
    cv.out = d_cv_t;
    AST_RETURN_IF_ERR(ast::launch_linear_prod(cv, s));
    AST_RETURN_IF_ERR(ast::launch_attention_bwd(
        enc, alphas + (long)t * B * T, d_cv_t, d_scores + (long)t * B * T,
        d_q_t, B, T, H, s));
    // d_top = [d_q | d_pre] @ [wa^T ; ctx_w[H:]^T], into the top layer's
    // cell backward
    ast::Prod tp = {};
    tp.seg[0] = ast::Seg{d_q_t, nullptr, H};
    tp.seg[1] = ast::Seg{d_pre_t, nullptr, A};
    tp.nseg = 2;
    tp.w = w_top;
    tp.R = B;
    tp.N = H;
    ast::BwdEpilogue te = {};
    te.cell = cell(t, L - 1);
    AST_RETURN_IF_ERR(ast::launch_bwd_prod(tp, te, s));

    const float* w_l = w_t;
    for (int l = 0; l < L - 1; ++l) w_l += H4 * ((width(l) + 63) / 64 * 64);
    for (int l = L - 1; l >= 0; --l) {
      // [dh carry | dx] = dz @ [wh^T | wx^T]: the carry to dh, dx into the
      // cell backward of the layer below or, from layer 0, into d_emb and
      // the step before's d_pre
      ast::Prod g = {};
      g.seg[0] = ast::Seg{dz + ((long)t * L + l) * B * H4, nullptr,
                          (int)H4};
      g.nseg = 1;
      g.w = w_l;
      g.R = B;
      g.N = width(l);
      g.out = dh + l * BH;
      ast::BwdEpilogue e = {};
      e.n_carry = H;
      if (l > 0) {
        e.cell = cell(t, l - 1);
        w_l -= H4 * ((width(l - 1) + 63) / 64 * 64);
      } else {
        e.d_emb = d_emb + (long)t * B * E;
        e.E = E;
        e.A = A;
        e.seed = seed + 2u * t;
        e.threshold = thr_e;
        e.inv = inv_e;
        if (t > 0) {
          e.d_ht = d_ht + (t - 1) * BA;
          e.ht = ht + (t - 1) * BA;
          e.d_pre = d_pre + (t - 1) * BA;
        }
      }
      AST_RETURN_IF_ERR(ast::launch_bwd_prod(g, e, s));
    }
  }
  return (int)cudaGetLastError();
}
