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
//
// bfloat16 (ast_tpu's compute_dtype bfloat16; k3_decoder_forward_bf16):
// the packed matrices and the encoder states in bf16 (the embedding and
// biases f32, holding bf16 values), the products at W = __nv_bfloat16
// rounding the inputs they stage, on the tensor cores (mma.sync bf16 ->
// f32 over the B-fragment tiles of ops/fused_infer.pack_step_weights_mma,
// packed once per call: the same tiles and kernels as K5 / K6 at bf16,
// the cell with its train epilogue), attention scoring against the f32
// query and rounding its weights before the context sum.  The streams
// (acts, c_all, h_all, alphas, q, cv, emb) are stored in bf16, ht in f32,
// and not x_drop, which the backward regenerates from h_all (ast_tpu's
// _fd_bwd).  What the next launch reads stays f32 in small buffers: h of
// step t in slot t & 1 of hbuf, c in place, each layer's dropped h, the
// step's q, cv and dropped embedding.
#include <type_traits>

#include "common.cuh"

namespace {

// One block per row: the input id of step t -- the teacher's when
// *coin_t, else the argmax of the row's logits of the step before (lowest
// index among ties) -- and its embedding row with dropout (the mask's
// flat index of row 0 flat0 = row_offset * E; kept values / div;
// threshold 0 = none), to emb_t and, at T = bf16, its stream emb_res.
template <typename T>
__global__ void select_embed_kernel(const int* y_t, const int* coin_t,
                                    const float* logits, int V, int* sel_t,
                                    const float* embed, float* emb_t,
                                    T* emb_res, int E, unsigned seed,
                                    unsigned flat0, unsigned threshold,
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
      v = ast::drop_hash(flat0 + (unsigned)(r * E + e), seed) < threshold
              ? 0.f
              : v / div;
    emb_t[(long)r * E + e] = v;
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      ast::st_res(emb_res + (long)r * E + e, v);
  }
}

// The forward's streams and state.  f32: x_drop is the stream (U, L, B,
// H); bf16: the streams are W and x_drop is each layer's dropped h (L, B,
// H) of the step, beside hbuf (2, L, B, H), c (L, B, H, c0 on entry),
// q_w, cv_w (B, He) and emb_w (B, E), all f32.  He: the encoder states'
// width, which the query, the context vector and ctx_w's first rows
// take.
template <typename W>
struct Fwd {
  const W* enc;
  const float* embed;
  const W *cell, *wa, *ctx_w, *out_w;
  const float *bias, *wa_b, *ctx_b, *out_b;
  const float *h0, *c0;
  const int *y_in, *coins;
  float* logits;
  const float* ht0;
  float* ht;
  int* sel;
  W *acts, *c_all, *h_all, *alphas, *q, *cv, *emb;
  float* x_drop;
  float *hbuf, *c, *q_w, *cv_w, *emb_w;
  int B, T, H, L, E, A, V, U;
  unsigned seed, thr_e;
  float div_e;
  unsigned thr_r;
  float div_r;
  unsigned row0;  // the global index of row 0 (the dropout masks')
  int He;
};

template <typename W>
int decoder_forward(const Fwd<W>& f, cudaStream_t s) {
  constexpr bool BF = std::is_same<W, __nv_bfloat16>::value;
  const int B = f.B, T = f.T, H = f.H, L = f.L, E = f.E, A = f.A, V = f.V,
            U = f.U, He = f.He;
  const long H4 = 4L * H, BH = (long)B * H, BHe = (long)B * He;
  for (int t = 0; t < U; ++t) {
    // what the step's products read: f32 streams, or the bf16 mode's state
    float *emb_t, *q_t, *cv_t;
    const float* h_last = nullptr;  // h of the step before (t > 0)
    if constexpr (BF) {
      emb_t = f.emb_w;
      q_t = f.q_w;
      cv_t = f.cv_w;
      h_last = f.hbuf + ((t - 1) & 1) * L * BH;
    } else {
      emb_t = f.emb + (long)t * B * E;
      q_t = f.q + (long)t * BHe;
      cv_t = f.cv + (long)t * BHe;
      if (t) h_last = f.h_all + ((long)t - 1) * L * BH;
    }
    AST_RETURN_IF_ERR(ast::launch_ex(
        select_embed_kernel<W>, dim3(B), dim3(128), 0, 1, s,
        f.y_in + (long)t * B, f.coins + t, (const float*)f.logits, V,
        f.sel + (long)t * B, f.embed, emb_t, f.emb + (long)t * B * E, E,
        f.seed + 2u * t, f.row0 * (unsigned)E, f.thr_e, f.div_e));
    const W* cell_w = f.cell;
    for (int l = 0; l < L; ++l) {
      const long tl = (long)t * L + l;
      // inputs [emb | ht of the step before (0 at t = 0) | h_prev] (layer
      // 0) or [x_drop of the layer below | h_prev]
      ast::Prod a = {};
      const ast::Seg hp = {(t ? h_last : f.h0) + l * BH, nullptr, H};
      float* x_l = BF ? f.x_drop + l * BH : f.x_drop + tl * BH;
      if (l == 0) {
        a.seg[0] = ast::Seg{emb_t, nullptr, E};
        a.seg[1] = ast::Seg{t ? f.ht + (long)(t - 1) * B * A : f.ht0,
                            nullptr, A};
        a.seg[2] = hp;
        a.nseg = 3;
      } else {
        a.seg[0] = ast::Seg{x_l - BH, nullptr, H};
        a.seg[1] = hp;
        a.nseg = 2;
      }
      a.w = cell_w;
      cell_w += (l == 0 ? E + A + H : 2 * H) * H4;
      a.bias = f.bias + l * H4;
      a.R = B;
      a.N = H;
      ast::CellTrainOut tr = {nullptr, x_l, f.seed + 2u * (unsigned)tl + 1u,
                              f.thr_r, f.div_r};
      tr.flat0 = f.row0 * (unsigned)H;
      if constexpr (BF) {
        a.out = f.hbuf + (t & 1) * L * BH + l * BH;
        a.c_in = f.c + l * BH;
        a.c_out = f.c + l * BH;
        tr.acts16 = f.acts + tl * B * H4;
        tr.c16 = f.c_all + tl * BH;
        tr.h16 = f.h_all + tl * BH;
        AST_RETURN_IF_ERR(ast::launch_cell_train_prod_bf16(a, tr, s));
      } else {
        a.out = f.h_all + tl * BH;
        a.c_in = t ? f.c_all + (tl - L) * BH : f.c0 + l * BH;
        a.c_out = f.c_all + tl * BH;
        tr.acts = f.acts + tl * B * H4;
        AST_RETURN_IF_ERR(ast::launch_cell_train_prod(a, tr, s));
      }
    }
    const float* top = BF ? f.x_drop + (long)(L - 1) * BH
                          : f.x_drop + ((long)t * L + L - 1) * BH;
    float* ht_t = f.ht + (long)t * B * A;

    ast::Prod qa = {};
    qa.seg[0] = ast::Seg{top, nullptr, H};
    qa.nseg = 1;
    qa.w = f.wa;
    qa.bias = f.wa_b;
    qa.R = B;
    qa.N = He;
    qa.out = q_t;
    if constexpr (BF) {
      qa.out16 = f.q + (long)t * BHe;
      AST_RETURN_IF_ERR(ast::launch_linear_prod_bf16(qa, s));
      AST_RETURN_IF_ERR(ast::launch_attention_train_bf16(
          f.enc, q_t, cv_t, f.cv + (long)t * BHe, f.alphas + (long)t * B * T,
          B, T, He, s));
    } else {
      AST_RETURN_IF_ERR(ast::launch_linear_prod(qa, s));
      AST_RETURN_IF_ERR(ast::launch_attention_train(
          f.enc, q_t, cv_t, f.alphas + (long)t * B * T, B, T, He, s));
    }
    ast::Prod ca = {};
    ca.seg[0] = ast::Seg{cv_t, nullptr, He};
    ca.seg[1] = ast::Seg{top, nullptr, H};
    ca.nseg = 2;
    ca.w = f.ctx_w;
    ca.bias = f.ctx_b;
    ca.R = B;
    ca.N = A;
    ca.act_tanh = 1;
    ca.out = ht_t;
    AST_RETURN_IF_ERR(BF ? ast::launch_linear_prod_bf16(ca, s)
                         : ast::launch_linear_prod(ca, s));

    if (t + 1 < U) {  // the argmax feed, skipped unless step t+1 samples
      ast::Prod oa = {};
      oa.seg[0] = ast::Seg{ht_t, nullptr, A};
      oa.nseg = 1;
      oa.w = f.out_w;
      oa.bias = f.out_b;
      oa.R = B;
      oa.N = V;
      oa.out = f.logits;
      oa.done = f.coins + t + 1;
      AST_RETURN_IF_ERR(BF ? ast::launch_linear_prod_bf16(oa, s)
                           : ast::launch_linear_prod(oa, s));
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// enc (B, T, He); embed (V, E); the products' weights as
// ops/fused_infer.pack_step_weights packs them: cell (the L layers'
// [wx; wh] by hidden unit), wa (H, He), ctx_w (He + H, A) and out_w as
// (column blocks, K, 64); bias (L, 4H), wa_b (He), ctx_b (A), out_b (V);
// h0 / c0 (L, B, H).
// y_in (U, B) teacher ids, coins (U) int (1 = teacher-forced, coins[0] ==
// 1).  Scratch: logits (B, V) and ht0 (B, A), both zero on entry.
// Outputs: ht (U, B, A); sel (U, B) int; acts (U, L, B, 4H); c_all, h_all
// (pre-dropout), x_drop (U, L, B, H); alphas (U, B, T); q, cv (U, B, He);
// emb (U, B, E).  Dropout: embedding mask seed + 2t over (B, E), layer l
// mask seed + 2(t L + l) + 1 over (B, H), each hashing the global row
// row_offset + r (a data-parallel rank's shard; 0 for a whole batch);
// kept values divided by div_e / div_r = 1 - rate; threshold 0 = none.
// E, A, H and He must be multiples of 32.
AST_EXPORT int k3_decoder_forward(
    const float* enc, const float* embed, const float* cell,
    const float* bias, const float* wa, const float* wa_b,
    const float* ctx_w, const float* ctx_b, const float* out_w,
    const float* out_b, const float* h0, const float* c0, const int* y_in,
    const int* coins, float* logits, const float* ht0, float* ht, int* sel,
    float* acts, float* c_all, float* h_all, float* x_drop, float* alphas,
    float* q, float* cv, float* emb, int B, int T, int H, int L, int E,
    int A, int V, int U, int row_offset, unsigned seed, unsigned thr_e,
    float div_e, unsigned thr_r, float div_r, int He, void* stream) {
  Fwd<float> f = {enc,    embed,  cell, wa,    ctx_w, out_w, bias, wa_b,
                  ctx_b,  out_b,  h0,   c0,    y_in,  coins, logits, ht0,
                  ht,     sel,    acts, c_all, h_all, alphas, q,    cv,
                  emb,    x_drop, nullptr, nullptr, nullptr, nullptr,
                  nullptr, B,     T,    H,     L,     E,     A,    V,
                  U,      seed,   thr_e, div_e, thr_r, div_r,
                  (unsigned)row_offset, He};
  return decoder_forward(f, static_cast<cudaStream_t>(stream));
}

// bf16: enc and the packed matrices (cell, wa, ctx_w, out_w) in bfloat16,
// in ops/fused_infer.pack_step_weights_mma's tensor-core layout (the same
// sizes and offsets), embed and the biases f32 (bf16 values); the
// streams acts, c_all, h_all, alphas, q, cv, emb in bfloat16 (shapes as
// above), ht f32, no x_drop stream.  The f32 state: hbuf (2, L, B, H),
// c (L, B, H) holding c0 on entry (the call's final c on exit), x_drop
// (L, B, H), q_w, cv_w (B, He), emb_w (B, E).
AST_EXPORT int k3_decoder_forward_bf16(
    const __nv_bfloat16* enc, const float* embed, const __nv_bfloat16* cell,
    const float* bias, const __nv_bfloat16* wa, const float* wa_b,
    const __nv_bfloat16* ctx_w, const float* ctx_b,
    const __nv_bfloat16* out_w, const float* out_b, const float* h0,
    const int* y_in, const int* coins, float* logits, const float* ht0,
    float* ht, int* sel, __nv_bfloat16* acts, __nv_bfloat16* c_all,
    __nv_bfloat16* h_all, __nv_bfloat16* alphas, __nv_bfloat16* q,
    __nv_bfloat16* cv, __nv_bfloat16* emb, float* hbuf, float* c,
    float* x_drop, float* q_w, float* cv_w, float* emb_w, int B, int T,
    int H, int L, int E, int A, int V, int U, int row_offset, unsigned seed,
    unsigned thr_e, float div_e, unsigned thr_r, float div_r, int He,
    void* stream) {
  Fwd<__nv_bfloat16> f = {enc,    embed, cell,  wa,    ctx_w, out_w,  bias,
                          wa_b,   ctx_b, out_b, h0,    nullptr, y_in, coins,
                          logits, ht0,   ht,    sel,   acts,  c_all,  h_all,
                          alphas, q,     cv,    emb,   x_drop, hbuf,  c,
                          q_w,    cv_w,  emb_w, B,     T,     H,      L,
                          E,      A,     V,     U,     seed,  thr_e,  div_e,
                          thr_r,  div_r, (unsigned)row_offset, He};
  return decoder_forward(f, static_cast<cudaStream_t>(stream));
}
