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
// rows against about 20 MB of transposed f32 weights (L2-resident) --
// launch latency and dependent weight loads, not FLOPs.  Design: one
// small head kernel, three launches for the attentional layer and two
// per LSTM layer (elementwise cell backward, one row-wise product that
// yields the dh carry and the layer below's gradient at once) a step.
// Every backward product is the shared linear kernel on a transposed
// copy the wrapper makes once per call, so weight loads stay coalesced;
// [d_q | d_pre] share one product against [wa^T ; ctx_w[H:]^T].
#include "common.cuh"

namespace {

// One block per row r.  d_pre_t = (d_ht_t + carry0's d_ht part) *
// (1 - ht_t^2), when d_pre_t is given; and when d_emb_next is given, the
// embedding gradient of the step after: carry0's embedding part through
// that step's dropout mask (seed over (B, E), kept values times inv).
// carry0: layer 0's [dh (H) | d_emb (E) | d_ht (A)] rows of n0 floats.
__global__ void head_kernel(const float* d_ht_t, const float* ht_t,
                            const float* carry0, int n0, int H, int E,
                            int A, float* d_pre_t, float* d_emb_next,
                            unsigned seed, unsigned threshold, float inv) {
  const int r = blockIdx.x;
  const float* c0 = carry0 + (long)r * n0;
  if (d_pre_t)
    for (int a = threadIdx.x; a < A; a += blockDim.x) {
      const float h = ht_t[(long)r * A + a];
      d_pre_t[(long)r * A + a] =
          (d_ht_t[(long)r * A + a] + c0[H + E + a]) * (1.f - h * h);
    }
  if (d_emb_next)
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      float v = c0[H + e];
      if (threshold)
        v = ast::drop_hash((unsigned)(r * E + e), seed) < threshold ? 0.f
                                                                    : v * inv;
      d_emb_next[(long)r * E + e] = v;
    }
}

// One block per row r: d_alphas[s] = enc[r, s] . d_cv[r], d_scores =
// alphas (d_alphas - sum(d_alphas alphas)), d_q = d_scores @ enc[r].
// Dynamic shared memory: H + T floats.
__global__ void attention_bwd_kernel(const float* enc, const float* alphas,
                                     const float* d_cv, float* d_scores,
                                     float* d_q, int T, int H) {
  extern __shared__ float sm[];
  __shared__ float red[32];
  float* dv = sm;
  float* p = sm + H;
  const int r = blockIdx.x;
  const float* Er = enc + (long)r * T * H;
  const float* al = alphas + (long)r * T;
  for (int h = threadIdx.x; h < H; h += blockDim.x)
    dv[h] = d_cv[(long)r * H + h];
  __syncthreads();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  constexpr int TU = 4;  // encoder rows a warp scores at a time
  for (int t0 = w * TU; t0 < T; t0 += nw * TU) {
    const int tn = min(TU, T - t0);
    float acc[TU] = {};
    for (int h = lane; h < H; h += 32) {
      const float x = dv[h];
#pragma unroll
      for (int u = 0; u < TU; ++u)
        if (u < tn) acc[u] = fmaf(Er[(long)(t0 + u) * H + h], x, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      const float v = ast::warp_sum(acc[u]);
      if (lane == 0 && u < tn) p[t0 + u] = v;
    }
  }
  __syncthreads();
  float inner = 0.f;
  for (int t = threadIdx.x; t < T; t += blockDim.x) inner += p[t] * al[t];
  inner = ast::block_reduce(inner, false, red);
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const float ds = al[t] * (p[t] - inner);
    p[t] = ds;
    d_scores[(long)r * T + t] = ds;
  }
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float acc[TU] = {};
    int t = 0;
    for (; t + TU <= T; t += TU) {
#pragma unroll
      for (int u = 0; u < TU; ++u)
        acc[u] = fmaf(p[t + u], Er[(long)(t + u) * H + h], acc[u]);
    }
    for (; t < T; ++t) acc[0] = fmaf(p[t], Er[(long)t * H + h], acc[0]);
    d_q[(long)r * H + h] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
}

}  // namespace

// Residuals of K3: acts (U, L, B, 4H), c_all (U, L, B, H), alphas (U, B,
// T), ht (U, B, A); c0 (L, B, H); d_ht (U, B, A) the loss's cotangent;
// enc (B, T, H).  Transposed weights: w_cv = ctx_w[:H]^T (A, H), w_top =
// [wa^T ; ctx_w[H:]^T] (H + A, H), w_t: per layer [wh^T | wx^T] (4H,
// H + E + A for layer 0, 2H above), back to back.  Scratch: carry, per
// layer (B, same widths) back to back, zero on entry (on exit columns
// 0..H-1 hold dh0); dc (L, B, H) zero on entry (dc0 on exit); d_top
// (B, H).  Outputs: dz (U, L, B, 4H), d_pre (U, B, A), d_scores (U, B,
// T), d_cv, d_q (U, B, H), d_emb (U, B, E).  Dropout as in K3, kept
// values times inv_e / inv_r = 1 / (1 - rate).
AST_EXPORT int k4_decoder_backward(
    const float* acts, const float* c_all, const float* c0,
    const float* alphas, const float* ht, const float* d_ht,
    const float* enc, const float* w_cv, const float* w_top,
    const float* w_t, float* carry, float* dc, float* d_top, float* dz,
    float* d_pre, float* d_scores, float* d_cv, float* d_q, float* d_emb,
    int B, int T, int H, int L, int E, int A, int U, unsigned seed,
    unsigned thr_e, float inv_e, unsigned thr_r, float inv_r,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long H4 = 4L * H, BH = (long)B * H;
  auto width = [=](int l) { return H + (l ? H : E + A); };
  long w_off[64], c_off[64];
  if (L > 64) return (int)cudaErrorInvalidValue;
  for (long l = 0, wo = 0, co = 0; l < L; ++l) {
    w_off[l] = wo;
    c_off[l] = co;
    wo += H4 * width(l);
    co += (long)B * width(l);
  }
  const int n0 = width(0);
  for (int t = U - 1; t >= 0; --t) {
    float* d_pre_t = d_pre + (long)t * B * A;
    float* d_cv_t = d_cv + (long)t * BH;
    float* d_q_t = d_q + (long)t * BH;
    head_kernel<<<B, 256, 0, s>>>(
        d_ht + (long)t * B * A, ht + (long)t * B * A, carry, n0, H, E, A,
        d_pre_t, t + 1 < U ? d_emb + (long)(t + 1) * B * E : nullptr,
        seed + 2u * (t + 1), thr_e, inv_e);
    AST_RETURN_IF_ERR(cudaGetLastError());

    ast::LinearArgs cv = {};
    cv.xa = ast::Seg{d_pre_t, 0, nullptr, A};
    cv.w = w_cv;
    cv.out = d_cv_t;
    cv.R = B;
    cv.N = H;
    AST_RETURN_IF_ERR(ast::launch_linear(cv, s));
    attention_bwd_kernel<<<B, 512, (size_t)(H + T) * sizeof(float), s>>>(
        enc, alphas + (long)t * B * T, d_cv_t, d_scores + (long)t * B * T,
        d_q_t, T, H);
    AST_RETURN_IF_ERR(cudaGetLastError());
    ast::LinearArgs tp = {};
    tp.xa = ast::Seg{d_q_t, 0, nullptr, H};
    tp.xb = ast::Seg{d_pre_t, 0, nullptr, A};
    tp.w = w_top;
    tp.out = d_top;
    tp.R = B;
    tp.N = H;
    AST_RETURN_IF_ERR(ast::launch_linear(tp, s));

    for (int l = L - 1; l >= 0; --l) {
      const long tl = (long)t * L + l;
      const int n = width(l);
      ast::CellBwdArgs c = {};
      if (l == L - 1) {
        c.cons = d_top;
        c.cons_ld = H;
      } else {
        c.cons = carry + c_off[l + 1] + H;   // dx of the layer above
        c.cons_ld = width(l + 1);
      }
      c.dh = carry + c_off[l];
      c.dh_ld = n;
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
      AST_RETURN_IF_ERR(ast::launch_lstm_cell_bwd(c, 1, s));

      ast::LinearArgs g = {};
      g.xa = ast::Seg{c.dz, 0, nullptr, (int)H4};
      g.w = w_t + w_off[l];
      g.out = carry + c_off[l];
      g.R = B;
      g.N = n;
      AST_RETURN_IF_ERR(ast::launch_linear(g, s));
    }
  }
  // step 0's embedding gradient
  head_kernel<<<B, 256, 0, s>>>(nullptr, nullptr, carry, n0, H, E, A,
                                nullptr, d_emb, seed, thr_e, inv_e);
  return (int)cudaGetLastError();
}
