// K5: fused greedy decoding.
//
// Replaces ast_tpu/ops/fused_infer.py _greedy_kernel (via
// greedy_decode_fused): per output step, embedding -> L-layer LSTM ->
// Luong attention -> ht = tanh(ctx([cv; h])) -> logits -> argmax (ties to
// the first index) -> next input.  Each row keeps emitting after its own
// EOS; once every row has finished, the remaining steps write PAD.
//
// What bounds it on the H100: B rows per step against about 32 MB of f32
// decoder weights (L2-resident), stop_limit dependent steps of L + 5
// launches each -- weight reads from L2 and launch latency, not FLOPs.
// Design: the step phases are the shared kernels of step_kernels.cu;
// the embedding is a row gather by token id (not the TPU's one-hot
// matmul) and attention runs each row against its own encoder rows (not
// the all-pairs-plus-diagonal-mask form).  A device-side finished flag
// replaces the host's early exit: every kernel of a step reads it and
// returns at once after the last row's EOS, so the host loop never
// synchronises.
#include "common.cuh"

namespace {

// One warp per row: argmax over V logits (lowest index among ties),
// record it, feed it back as the next input, and set *done once every
// row has produced EOS.  Launched as a single block.
__global__ void greedy_argmax_kernel(const float* logits, int B, int V,
                                     int* tok_in, int* fin, int* tok_out,
                                     int* done) {
  if (*done) {
    for (int r = threadIdx.x; r < B; r += blockDim.x) tok_out[r] = ast::PAD_ID;
    return;
  }
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

}  // namespace

// enc: (B, T, H); weights as in ast::DecoderWeights.
// State, initialised by the caller: hbuf (2, L, B, H) with h0 in slot 0,
// c (L, B, H) = c0, ht (B, A) = 0, tok_in (B) = GO, fin (B) = 0,
// done (1) = 0.  Scratch: q, cv (B, H), logits (B, V).
// Output: tok_out (stop, B) int32.
AST_EXPORT int k5_greedy_decode(
    const float* enc, const float* embed, const float* wx0,
    const float* wx_rest, const float* wh, const float* bias,
    const float* wa, const float* wa_b, const float* ctx_w,
    const float* ctx_b, const float* out_w, const float* out_b, float* hbuf,
    float* c, float* ht, int* tok_in, int* fin, int* done, float* q,
    float* cv, float* logits, int* tok_out, int B, int T, int H, int L,
    int E, int A, int V, int stop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ast::DecoderWeights w = {embed, wx0,   wx_rest, wh,    bias, wa,
                                 wa_b,  ctx_w, ctx_b,   out_w, out_b, L,
                                 H,     E,     A,       V};
  const long state = (long)L * B * H;
  for (int t = 0; t < stop; ++t) {
    ast::DecoderStep st = {};
    st.tok = tok_in;
    st.ht_in = ht;
    st.h_in = hbuf + (t & 1) * state;
    st.c_in = c;
    st.h_out = hbuf + ((t + 1) & 1) * state;
    st.c_out = c;
    st.q = q;
    st.cv = cv;
    st.ht_out = ht;
    st.logits = logits;
    AST_RETURN_IF_ERR(ast::decoder_step(w, enc, T, 1, st, B, done, s));
    greedy_argmax_kernel<<<1, 1024, 0, s>>>(logits, B, V, tok_in, fin,
                                            tok_out + (long)t * B, done);
    AST_RETURN_IF_ERR(cudaGetLastError());
  }
  return (int)cudaGetLastError();
}
