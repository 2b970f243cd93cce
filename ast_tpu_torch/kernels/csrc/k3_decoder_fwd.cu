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
// rows against about 16 MB of f32 decoder weights (L2-resident) plus the
// 2.2 MB output projection on sampled steps -- launch latency and
// dependent weight loads from L2, not FLOPs.  Design: the step phases are
// the shared kernels of step_kernels.cu (cell with the train epilogue,
// linear, attention with alphas); the input is an int id and the
// embedding a row gather, not the TPU's one-hot matmul.  The coins stay
// on the device: the logits and argmax launches read coins[t+1] and
// return at once on a teacher-forced step, so the host loop never
// synchronises.
#include "common.cuh"

namespace {

// One block per row: the selected input id of step t, and its embedding
// row with dropout (kept values / div; threshold 0 = none).
__global__ void select_embed_kernel(const int* y_t, const int* coin_t,
                                    const int* prev, int* sel_t,
                                    const float* embed, float* emb_t, int E,
                                    unsigned seed, unsigned threshold,
                                    float div) {
  const int r = blockIdx.x;
  const int id = *coin_t ? y_t[r] : prev[r];
  if (threadIdx.x == 0) sel_t[r] = id;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float v = embed[(long)id * E + e];
    if (threshold)
      v = ast::drop_hash((unsigned)(r * E + e), seed) < threshold ? 0.f
                                                                  : v / div;
    emb_t[(long)r * E + e] = v;
  }
}

// One warp per row: argmax over V logits (lowest index among ties) into
// prev; returns at once when *skip (the next step is teacher-forced).
__global__ void argmax_kernel(const float* logits, int B, int V, int* prev,
                              const int* skip) {
  if (*skip) return;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int r = w; r < B; r += blockDim.x >> 5) {
    const int bi = ast::warp_argmax(logits + (long)r * V, V);
    if (lane == 0) prev[r] = bi;
  }
}

}  // namespace

// enc (B, T, H); weights as models/seq2seq.pack_decoder_weights packs
// them (no vocab padding); h0 / c0 (L, B, H).
// y_in (U, B) teacher ids, coins (U) int (1 = teacher-forced, coins[0] ==
// 1).  Scratch: prev (B) int, zero on entry; logits (B, V).
// Outputs: ht (U, B, A); sel (U, B) int; acts (U, L, B, 4H); c_all, h_all
// (pre-dropout), x_drop (U, L, B, H); alphas (U, B, T); q, cv (U, B, H);
// emb (U, B, E).  Dropout: embedding mask seed + 2t over (B, E), layer l
// mask seed + 2(t L + l) + 1 over (B, H); kept values divided by
// div_e / div_r = 1 - rate; threshold 0 = none.
AST_EXPORT int k3_decoder_forward(
    const float* enc, const float* wx0, const float* wx_rest,
    const float* wh, const float* bias, const float* wa, const float* wa_b,
    const float* ctx_w, const float* ctx_b, const float* out_w,
    const float* out_b, const float* embed, const float* h0,
    const float* c0, const int* y_in, const int* coins, int* prev,
    float* logits, float* ht, int* sel, float* acts, float* c_all,
    float* h_all, float* x_drop, float* alphas, float* q, float* cv,
    float* emb, int B, int T, int H, int L, int E, int A, int V, int U,
    unsigned seed, unsigned thr_e, float div_e, unsigned thr_r, float div_r,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long H4 = 4L * H, BH = (long)B * H;
  for (int t = 0; t < U; ++t) {
    float* emb_t = emb + (long)t * B * E;
    select_embed_kernel<<<B, 128, 0, s>>>(y_in + (long)t * B, coins + t,
                                          prev, sel + (long)t * B, embed,
                                          emb_t, E, seed + 2u * t, thr_e,
                                          div_e);
    AST_RETURN_IF_ERR(cudaGetLastError());
    for (int l = 0; l < L; ++l) {
      const long tl = (long)t * L + l;
      ast::CellArgs a = {};
      if (l == 0) {
        a.xa = ast::Seg{emb_t, 0, nullptr, E};
        // input feeding: the previous step's ht (absent, i.e. 0, at t = 0)
        a.xb = ast::Seg{t ? ht + (long)(t - 1) * B * A : nullptr, 0, nullptr,
                        A};
        a.wx = wx0;
      } else {
        a.xa = ast::Seg{x_drop + (tl - 1) * BH, 0, nullptr, H};
        a.wx = wx_rest + (long)(l - 1) * H * H4;
      }
      a.hp = ast::Seg{t ? h_all + (tl - L) * BH : h0 + l * BH, 0, nullptr,
                      H};
      a.wh = wh + (long)l * H * H4;
      a.bias = bias + (long)l * H4;
      a.c_in = t ? c_all + (tl - L) * BH : c0 + l * BH;
      a.c_out = c_all + tl * BH;
      a.h_out = h_all + tl * BH;
      a.R = B;
      a.H = H;
      ast::CellTrain tr = {};
      tr.acts_out = acts + tl * B * H4;
      tr.x_out = x_drop + tl * BH;
      tr.seed = seed + 2u * (unsigned)tl + 1u;
      tr.threshold = thr_r;
      tr.keep_scale = div_r;
      tr.drop_div = 1;
      AST_RETURN_IF_ERR(ast::launch_lstm_cell(a, 1, s, &tr));
    }
    const float* top = x_drop + ((long)t * L + L - 1) * BH;
    float* q_t = q + (long)t * BH;
    float* cv_t = cv + (long)t * BH;
    float* ht_t = ht + (long)t * B * A;

    ast::LinearArgs qa = {};
    qa.xa = ast::Seg{top, 0, nullptr, H};
    qa.w = wa;
    qa.bias = wa_b;
    qa.out = q_t;
    qa.R = B;
    qa.N = H;
    AST_RETURN_IF_ERR(ast::launch_linear(qa, s));
    AST_RETURN_IF_ERR(ast::launch_attention_alphas(
        enc, q_t, cv_t, alphas + (long)t * B * T, B, T, H, s));
    ast::LinearArgs ca = {};
    ca.xa = ast::Seg{cv_t, 0, nullptr, H};
    ca.xb = ast::Seg{top, 0, nullptr, H};
    ca.w = ctx_w;
    ca.bias = ctx_b;
    ca.out = ht_t;
    ca.R = B;
    ca.N = A;
    ca.act_tanh = 1;
    AST_RETURN_IF_ERR(ast::launch_linear(ca, s));

    if (t + 1 < U) {  // the argmax feed, skipped unless step t+1 samples
      ast::LinearArgs oa = {};
      oa.xa = ast::Seg{ht_t, 0, nullptr, A};
      oa.w = out_w;
      oa.bias = out_b;
      oa.out = logits;
      oa.R = B;
      oa.N = V;
      oa.done = coins + t + 1;
      AST_RETURN_IF_ERR(ast::launch_linear(oa, s));
      argmax_kernel<<<1, 1024, 0, s>>>(logits, B, V, prev, coins + t + 1);
      AST_RETURN_IF_ERR(cudaGetLastError());
    }
  }
  return (int)cudaGetLastError();
}
