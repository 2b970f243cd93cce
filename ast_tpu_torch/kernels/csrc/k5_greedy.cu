// K5: fused greedy decoding.
//
// Replaces ast_tpu/ops/fused_infer.py _greedy_kernel (via
// greedy_decode_fused; its step is _lstm_stack, _step_core and
// _context_out): per output step, embedding -> L-layer LSTM -> Luong
// attention -> ht = tanh(ctx([cv; h])) -> logits -> argmax (ties to the
// first index) -> next input.  Each row keeps emitting after its own
// EOS; once every row has finished, the remaining steps write PAD.
//
// What bounds it on the H100: B = 32 rows a step against 31.6 MB of f32
// decoder weights (L2-resident), stop_limit dependent steps of L + 5
// launches each.  A step moves about 68 MB through L2 (decode_step.cu's
// note) for 0.15 GFLOP of FMA: the bytes in flight per SM, the cluster
// barriers of its products and launch latency bound it, not FLOPs.
// Design: the step is decode_step.cu's -- products that read each weight
// once a step, K split over thread-block clusters (3 blocks for the
// cells, 8 for q and ctx on the H100), reduced in distributed shared
// memory; attention by one cluster of 3 blocks per utterance -- and the
// embedding a row gather by token id (not the TPU's one-hot matmul).
// State ping-pongs between two slots, since a step's products read the
// previous step's state while other blocks write the new one.  A
// device-side finished flag replaces the host's early exit: every kernel
// of a step reads it and returns at once after the last row's EOS, so the
// host loop never synchronises.  Every launch is a programmatic dependent
// launch.
//
// bfloat16 (k5_greedy_decode_bf16; ast_tpu's compute_dtype bfloat16): the
// packed matrices and the encoder states in bf16, the embedding and the
// biases f32 holding bf16 values, h, c, ht, the logits and the argmax in
// f32 -- decode_step.cu's step at W = __nv_bfloat16, which reads half the
// weight and encoder bytes a step.
#include "common.cuh"

namespace {

// One warp per row: argmax over V logits (lowest index among ties),
// record it, feed it back as the next input, and set *done once every
// row has produced EOS.  Launched as a single block.
__global__ void greedy_argmax_kernel(const float* logits, int B, int V,
                                     int* tok_in, int* fin, int* tok_out,
                                     int* done) {
  ast::grid_dep_wait();
  if (*done) {
    for (int r = threadIdx.x; r < B; r += blockDim.x) tok_out[r] = ast::PAD_ID;
    return;
  }
  ast::grid_dep_launch();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int r = w; r < B; r += nw) {
    const int bi = ast::warp_argmax(logits + (long)r * V, V);
    if (lane == 0) {
      tok_out[r] = bi;
      tok_in[r] = bi;
      if (bi == ast::EOS_ID) fin[r] = 1;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int all = 1;
    for (int r = 0; r < B; ++r) all &= fin[r] != 0;
    if (all) *done = 1;
  }
}

template <typename W>
int greedy_decode(const W* enc, const float* embed, const W* cell,
                  const float* bias, const W* wa, const float* wa_b,
                  const W* ctx_w, const float* ctx_b, const W* out_w,
                  const float* out_b, float* hbuf, float* cbuf,
                  float* htbuf, int* tok_in, int* fin, int* done, float* q,
                  float* cv, float* logits, int* tok_out, int B, int T,
                  int H, int L, int E, int A, int V, int stop,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ast::StepWeightsT<W> w = {embed, cell,  bias,  wa, wa_b, ctx_w,
                                  ctx_b, out_w, out_b, L,  H,    E,
                                  A,     V};
  const long state = (long)L * B * H;
  for (int t = 0; t < stop; ++t) {
    const int i = t & 1, o = i ^ 1;
    ast::DecoderStep st = {};
    st.tok = tok_in;
    st.ht_in = htbuf + i * (long)B * A;
    st.h_in = hbuf + i * state;
    st.c_in = cbuf + i * state;
    st.h_out = hbuf + o * state;
    st.c_out = cbuf + o * state;
    st.q = q;
    st.cv = cv;
    st.ht_out = htbuf + o * (long)B * A;
    st.logits = logits;
    AST_RETURN_IF_ERR(ast::decode_step(w, enc, T, 1, st, B, done, s));
    AST_RETURN_IF_ERR(ast::launch_ex(greedy_argmax_kernel, dim3(1),
                                     dim3(1024), 0, 1, s, logits, B, V,
                                     tok_in, fin, tok_out + (long)t * B,
                                     done));
  }
  return (int)cudaGetLastError();
}

}  // namespace

// enc: (B, T, H); weights as in ast::StepWeightsT.
// State, initialised by the caller: hbuf and cbuf (2, L, B, H) with h0 /
// c0 in slot 0, htbuf (2, B, A) with 0 in slot 0, tok_in (B) = GO, fin
// (B) = 0, done (1) = 0.  Scratch: q, cv (B, H), logits (B, V).
// Output: tok_out (stop, B) int32.
AST_EXPORT int k5_greedy_decode(
    const float* enc, const float* embed, const float* cell,
    const float* bias, const float* wa, const float* wa_b,
    const float* ctx_w, const float* ctx_b, const float* out_w,
    const float* out_b, float* hbuf,
    float* cbuf, float* htbuf, int* tok_in, int* fin, int* done, float* q,
    float* cv, float* logits, int* tok_out, int B, int T, int H, int L,
    int E, int A, int V, int stop, void* stream) {
  return greedy_decode(enc, embed, cell, bias, wa, wa_b, ctx_w, ctx_b, out_w,
                       out_b, hbuf, cbuf, htbuf, tok_in, fin, done, q, cv,
                       logits, tok_out, B, T, H, L, E, A, V, stop, stream);
}

// The same with enc, cell, wa, ctx_w and out_w in bfloat16.
AST_EXPORT int k5_greedy_decode_bf16(
    const __nv_bfloat16* enc, const float* embed, const __nv_bfloat16* cell,
    const float* bias, const __nv_bfloat16* wa, const float* wa_b,
    const __nv_bfloat16* ctx_w, const float* ctx_b,
    const __nv_bfloat16* out_w, const float* out_b, float* hbuf,
    float* cbuf, float* htbuf, int* tok_in, int* fin, int* done, float* q,
    float* cv, float* logits, int* tok_out, int B, int T, int H, int L,
    int E, int A, int V, int stop, void* stream) {
  return greedy_decode(enc, embed, cell, bias, wa, wa_b, ctx_w, ctx_b, out_w,
                       out_b, hbuf, cbuf, htbuf, tok_in, fin, done, q, cv,
                       logits, tok_out, B, T, H, L, E, A, V, stop, stream);
}
