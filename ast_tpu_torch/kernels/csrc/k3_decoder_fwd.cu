// K3: fused attention-LSTM decoder of training, forward.
//
// Replaces ast_tpu/ops/fused_decoder.py _fwd_kernel (via decoder_forward /
// fused_decoder_apply): per step t, scheduled-sampling input selection
// (the teacher's id when coins[t] is 1, else the previous step's argmax),
// embedding with hash dropout, the L-layer LSTM with dropout on each
// layer's output, Luong attention over the row's own encoder states,
// ht = tanh(ctx([cv; h_top])), and -- only when step t+1 samples -- the
// logits ht @ out_w + out_b and their argmax (ties to the first index).
// Every residual K4 needs is streamed: the selected ids, the gates, c, h
// before and after dropout, alphas, q, cv and the dropped embedding.
//
// What bounds it on the H100: U dependent steps of small products at B
// rows against about 29 MB of f32 decoder weights (L2-resident) plus the
// 2.2 MB output projection on sampled steps -- the bytes a block keeps in
// flight from L2, the products' cluster barriers and launch latency, not
// FLOPs.  Design: the step's products and attention are decode_step.cu's,
// the ones K5 and K6 decode with.  Each weight is read once a step: a
// block owns 64 output columns (a cell's four gates of 16 units) for all B
// rows, takes its weight tiles by bulk copy from the layout that
// ops/fused_infer.pack_step_weights packs once per call, and shares the
// input axis with the other blocks of its thread-block cluster; the
// cell's epilogue also writes the gates, c, h and the dropped h (a
// separate instantiation, so decoding's is unchanged).  Attention runs a
// cluster per row and writes alphas as well.  The input is an int id and
// the embedding a row gather, not the TPU's one-hot matmul; the argmax of
// a sampled step is taken by the kernel that selects the next input, one
// launch instead of two.  The coins stay on the device: the logits launch
// reads coins[t+1] and returns at once on a teacher-forced step, so the
// host loop never synchronises.  8 launches a step, each a programmatic
// dependent launch: every kernel waits for its predecessor before it
// touches memory or returns.
#include "common.cuh"

namespace {

// One block per row: the input id of step t -- the teacher's when
// *coin_t, else the argmax of the row's logits of the step before (lowest
// index among ties) -- and its embedding row with dropout (kept values /
// div; threshold 0 = none).
__global__ void select_embed_kernel(const int* y_t, const int* coin_t,
                                    const float* logits, int V, int* sel_t,
                                    const float* embed, float* emb_t, int E,
                                    unsigned seed, unsigned threshold,
                                    float div) {
  ast::grid_dep_wait();
  ast::grid_dep_launch();
  __shared__ int id_s;
  const int r = blockIdx.x;
  if (*coin_t) {
    if (threadIdx.x == 0) id_s = y_t[r];
  } else if (threadIdx.x < 32) {
    const int bi = ast::warp_argmax(logits + (long)r * V, V);
    if (threadIdx.x == 0) id_s = bi;
  }
  __syncthreads();
  const int id = id_s;
  if (threadIdx.x == 0) sel_t[r] = id;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float v = embed[(long)id * E + e];
    if (threshold)
      v = ast::drop_hash((unsigned)(r * E + e), seed) < threshold ? 0.f
                                                                  : v / div;
    emb_t[(long)r * E + e] = v;
  }
}

}  // namespace

// enc (B, T, H); embed (V, E); the products' weights as
// ops/fused_infer.pack_step_weights packs them: cell (the L layers'
// [wx; wh] by hidden unit), wa, ctx_w and out_w as (column blocks, K, 64);
// bias (L, 4H), wa_b (H), ctx_b (A), out_b (V); h0 / c0 (L, B, H).
// y_in (U, B) teacher ids, coins (U) int (1 = teacher-forced, coins[0] ==
// 1).  Scratch: logits (B, V) and ht0 (B, A), both zero on entry.
// Outputs: ht (U, B, A); sel (U, B) int; acts (U, L, B, 4H); c_all, h_all
// (pre-dropout), x_drop (U, L, B, H); alphas (U, B, T); q, cv (U, B, H);
// emb (U, B, E).  Dropout: embedding mask seed + 2t over (B, E), layer l
// mask seed + 2(t L + l) + 1 over (B, H); kept values divided by
// div_e / div_r = 1 - rate; threshold 0 = none.  E, A and H must be
// multiples of 32.
AST_EXPORT int k3_decoder_forward(
    const float* enc, const float* embed, const float* cell,
    const float* bias, const float* wa, const float* wa_b,
    const float* ctx_w, const float* ctx_b, const float* out_w,
    const float* out_b, const float* h0, const float* c0, const int* y_in,
    const int* coins, float* logits, const float* ht0, float* ht, int* sel,
    float* acts, float* c_all, float* h_all, float* x_drop, float* alphas,
    float* q, float* cv, float* emb, int B, int T, int H, int L, int E,
    int A, int V, int U, unsigned seed, unsigned thr_e, float div_e,
    unsigned thr_r, float div_r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long H4 = 4L * H, BH = (long)B * H;
  for (int t = 0; t < U; ++t) {
    float* emb_t = emb + (long)t * B * E;
    AST_RETURN_IF_ERR(ast::launch_ex(
        select_embed_kernel, dim3(B), dim3(128), 0, 1, s, y_in + (long)t * B,
        coins + t, (const float*)logits, V, sel + (long)t * B, embed, emb_t,
        E, seed + 2u * t, thr_e, div_e));
    const float* cell_w = cell;
    for (int l = 0; l < L; ++l) {
      const long tl = (long)t * L + l;
      // inputs [emb | ht of the step before (0 at t = 0) | h_prev] (layer
      // 0) or [x_drop of the layer below | h_prev]
      ast::Prod a = {};
      const ast::Seg hp = {t ? h_all + (tl - L) * BH : h0 + l * BH, nullptr,
                           H};
      if (l == 0) {
        a.seg[0] = ast::Seg{emb_t, nullptr, E};
        a.seg[1] = ast::Seg{t ? ht + (long)(t - 1) * B * A : ht0, nullptr,
                            A};
        a.seg[2] = hp;
        a.nseg = 3;
      } else {
        a.seg[0] = ast::Seg{x_drop + (tl - 1) * BH, nullptr, H};
        a.seg[1] = hp;
        a.nseg = 2;
      }
      a.w = cell_w;
      cell_w += (l == 0 ? E + A + H : 2 * H) * H4;
      a.bias = bias + l * H4;
      a.R = B;
      a.N = H;
      a.out = h_all + tl * BH;
      a.c_in = t ? c_all + (tl - L) * BH : c0 + l * BH;
      a.c_out = c_all + tl * BH;
      const ast::CellTrainOut tr = {acts + tl * B * H4, x_drop + tl * BH,
                                    seed + 2u * (unsigned)tl + 1u, thr_r,
                                    div_r};
      AST_RETURN_IF_ERR(ast::launch_cell_train_prod(a, tr, s));
    }
    const float* top = x_drop + ((long)t * L + L - 1) * BH;
    float* q_t = q + (long)t * BH;
    float* cv_t = cv + (long)t * BH;
    float* ht_t = ht + (long)t * B * A;

    ast::Prod qa = {};
    qa.seg[0] = ast::Seg{top, nullptr, H};
    qa.nseg = 1;
    qa.w = wa;
    qa.bias = wa_b;
    qa.R = B;
    qa.N = H;
    qa.out = q_t;
    AST_RETURN_IF_ERR(ast::launch_linear_prod(qa, s));
    AST_RETURN_IF_ERR(ast::launch_attention_train(
        enc, q_t, cv_t, alphas + (long)t * B * T, B, T, H, s));
    ast::Prod ca = {};
    ca.seg[0] = ast::Seg{cv_t, nullptr, H};
    ca.seg[1] = ast::Seg{top, nullptr, H};
    ca.nseg = 2;
    ca.w = ctx_w;
    ca.bias = ctx_b;
    ca.R = B;
    ca.N = A;
    ca.act_tanh = 1;
    ca.out = ht_t;
    AST_RETURN_IF_ERR(ast::launch_linear_prod(ca, s));

    if (t + 1 < U) {  // the argmax feed, skipped unless step t+1 samples
      ast::Prod oa = {};
      oa.seg[0] = ast::Seg{ht_t, nullptr, A};
      oa.nseg = 1;
      oa.w = out_w;
      oa.bias = out_b;
      oa.R = B;
      oa.N = V;
      oa.out = logits;
      oa.done = coins + t + 1;
      AST_RETURN_IF_ERR(ast::launch_linear_prod(oa, s));
    }
  }
  return (int)cudaGetLastError();
}
