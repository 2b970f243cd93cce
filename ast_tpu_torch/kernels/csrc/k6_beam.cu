// K6: fused beam search frontier.
//
// Replaces ast_tpu/ops/fused_infer.py _beam_kernel (via
// beam_decode_fused): per step, the decoder step for all R = B * N
// hypotheses, log-softmax over the vocabulary, top-K continuations per
// live hypothesis (ties to the lowest index), a frozen hypothesis
// contributing one candidate (score unchanged, token EOS), N of the N * K
// candidates per utterance by (value desc, index asc) over distinct
// candidates, and the parent gather of h, c and ht.  It streams int32
// tokens, parents and validity per step; backtracking and compaction
// run outside, as on the TPU.
//
// What bounds it on the H100: the same L2-resident weight reads and
// launch latency as K5, at R = B * N rows; the selection is tiny
// (N * K candidates per utterance) but sequential.  Design: the decoder
// step reuses step_kernels.cu over R rows with encoder row r / N (no
// tiling of the encoder states); one warp per row does log-softmax and
// the K selection passes; one warp per utterance does the N-of-N*K
// selection, each pass taking the best candidate strictly after the
// previous one in (value desc, index asc) order -- distinct candidates
// without a taken-mask, even when N > K.  Parent gathers use exact
// integer row indices (not one-hot products), writing back into the
// step's input buffers, so state needs no extra copy.  The device-side
// done flag ends the work once every hypothesis has finished; later
// steps stream EOS, identity parents and valid = 0.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// (value desc, index asc) order: is (v, i) better than (bv, bi)?
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best(float& bv, int& bi) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, bv, o);
    const int oi = __shfl_xor_sync(FULL, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

// One warp per row: log-softmax over V, then K passes, each taking the
// best log-prob strictly after the previous pick in (value desc, index
// asc) order.  cand_val = score + logp (or, for a finished row, score
// for k = 0 and score + NEG_INF after it, with token EOS).
__global__ void beam_topk_kernel(const float* logits, int R, int V, int K,
                                 const float* score, const int* fin,
                                 float* cand_val, int* cand_tok,
                                 const int* done) {
  if (*done) return;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= R) return;
  const float sc = score[r];
  if (fin[r]) {
    for (int k = lane; k < K; k += 32) {
      cand_val[(long)r * K + k] = sc + (k == 0 ? 0.f : ast::NEG_INF);
      cand_tok[(long)r * K + k] = ast::EOS_ID;
    }
    return;
  }
  const float* x = logits + (long)r * V;
  float m = -INFINITY;
  for (int v = lane; v < V; v += 32) m = fmaxf(m, x[v]);
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  float sum = 0.f;
  for (int v = lane; v < V; v += 32) sum += expf(x[v] - m);
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
  const float lse = logf(sum);

  float pv = INFINITY;
  int pi = -1;
  for (int k = 0; k < K; ++k) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int v = lane; v < V; v += 32) {
      const float lp = (x[v] - m) - lse;
      const bool after = lp < pv || (lp == pv && v > pi);
      if (after && better(lp, v, bv, bi)) {
        bv = lp;
        bi = v;
      }
    }
    warp_best(bv, bi);
    if (bi >= V) bi = 0;  // all-NaN row: keep token ids in range
    pv = bv;
    pi = bi;
    if (lane == 0) {
      cand_val[(long)r * K + k] = sc + bv;
      cand_tok[(long)r * K + k] = bi;
    }
  }
}

// One warp per utterance, single block: pick N of the N * K candidates,
// update score / fin / next token, record the absolute parent row for
// the gather and the step's output streams, then set *done once every
// hypothesis has finished.  Requires N <= 32.
__global__ void beam_select_kernel(const float* cand_val, const int* cand_tok,
                                   int B, int N, int K, float* score,
                                   int* fin, int* tok_in, int* parent,
                                   int* tok_out, int* par_out, int* val_out,
                                   int* done) {
  const int R = B * N, NK = N * K;
  if (*done) {
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      tok_out[r] = ast::EOS_ID;
      par_out[r] = r % N;
      val_out[r] = 0;
    }
    return;
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int b = w; b < B; b += nw) {
    const float* cv = cand_val + (long)b * NK;
    float pv = INFINITY;
    int pi = -1;
    float my_v = 0.f;
    int my_m = 0;
    for (int j = 0; j < N; ++j) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int m = lane; m < NK; m += 32) {
        const float v = cv[m];
        const bool after = v < pv || (v == pv && m > pi);
        if (after && better(v, m, bv, bi)) {
          bv = v;
          bi = m;
        }
      }
      warp_best(bv, bi);
      if (bi >= NK) bi = 0;  // unreachable with finite candidates
      if (lane == j) {
        my_v = bv;
        my_m = bi;
      }
      pv = bv;
      pi = bi;
    }
    int par = 0, tok = 0, pfin = 0;
    if (lane < N) {
      par = my_m / K;
      tok = cand_tok[(long)b * NK + my_m];
      pfin = fin[b * N + par];
    }
    __syncwarp();  // every parent's fin is read before any slot's is written
    if (lane < N) {
      const int r = b * N + lane;
      score[r] = my_v;
      fin[r] = (pfin || tok == ast::EOS_ID) ? 1 : 0;
      tok_in[r] = tok;
      parent[r] = b * N + par;
      tok_out[r] = tok;
      par_out[r] = par;
      val_out[r] = 1 - pfin;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int all = 1;
    for (int r = 0; r < R; ++r) all &= fin[r] != 0;
    if (all) *done = 1;
  }
}

// dst[m][r] = src[m][parent[r]] for blockIdx.y = m (rows of F floats).
__global__ void gather_rows_kernel(const float* src, float* dst,
                                   const int* parent, int R, int F,
                                   const int* done) {
  if (*done) return;
  const int r = blockIdx.x;
  const long mat = (long)blockIdx.y * R * F;
  const float* s = src + mat + (long)parent[r] * F;
  float* d = dst + mat + (long)r * F;
  for (int f = threadIdx.x; f < F; f += blockDim.x) d[f] = s[f];
}

}  // namespace

// enc: (B, T, H); weights as in ast::DecoderWeights; R = B * N.
// State, initialised by the caller: hbuf (2, L, R, H) and cbuf
// (2, L, R, H) with h0 / c0 (repeated N times per utterance) in slot 0,
// htbuf (2, R, A) = 0, tok_in (R) = GO, score (R) = 0 for slot 0 of each
// utterance and NEG_INF for the others, fin (R) = 0, done (1) = 0.
// Scratch: parent (R), q, cv (R, H), logits (R, V), cand_val, cand_tok
// (R, K).  Outputs: tok_out, par_out, val_out (stop, R) int32; score
// holds the final scores.
AST_EXPORT int k6_beam_decode(
    const float* enc, const float* embed, const float* wx0,
    const float* wx_rest, const float* wh, const float* bias,
    const float* wa, const float* wa_b, const float* ctx_w,
    const float* ctx_b, const float* out_w, const float* out_b, float* hbuf,
    float* cbuf, float* htbuf, int* tok_in, float* score, int* fin,
    int* done, int* parent, float* q, float* cv, float* logits,
    float* cand_val, int* cand_tok, int* tok_out, int* par_out,
    int* val_out, int B, int N, int K, int T, int H, int L, int E, int A,
    int V, int stop, void* stream) {
  if (N > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ast::DecoderWeights w = {embed, wx0,   wx_rest, wh,    bias, wa,
                                 wa_b,  ctx_w, ctx_b,   out_w, out_b, L,
                                 H,     E,     A,       V};
  const int R = B * N;
  const long state = (long)L * R * H;
  float* h_cur = hbuf;
  float* h_nxt = hbuf + state;
  float* c_cur = cbuf;
  float* c_nxt = cbuf + state;
  float* ht_cur = htbuf;
  float* ht_nxt = htbuf + (long)R * A;
  const int topk_rows = 8;  // warps per top-K block
  for (int t = 0; t < stop; ++t) {
    ast::DecoderStep st = {};
    st.tok = tok_in;
    st.ht_in = ht_cur;
    st.h_in = h_cur;
    st.c_in = c_cur;
    st.h_out = h_nxt;
    st.c_out = c_nxt;
    st.q = q;
    st.cv = cv;
    st.ht_out = ht_nxt;
    st.logits = logits;
    AST_RETURN_IF_ERR(ast::decoder_step(w, enc, T, N, st, R, done, s));
    beam_topk_kernel<<<(R + topk_rows - 1) / topk_rows, 32 * topk_rows, 0,
                       s>>>(logits, R, V, K, score, fin, cand_val, cand_tok,
                            done);
    AST_RETURN_IF_ERR(cudaGetLastError());
    const long off = (long)t * R;
    beam_select_kernel<<<1, 1024, 0, s>>>(cand_val, cand_tok, B, N, K, score,
                                          fin, tok_in, parent, tok_out + off,
                                          par_out + off, val_out + off, done);
    AST_RETURN_IF_ERR(cudaGetLastError());
    // parents' states become the next step's inputs
    gather_rows_kernel<<<dim3(R, L), 128, 0, s>>>(h_nxt, h_cur, parent, R, H,
                                                  done);
    AST_RETURN_IF_ERR(cudaGetLastError());
    gather_rows_kernel<<<dim3(R, L), 128, 0, s>>>(c_nxt, c_cur, parent, R, H,
                                                  done);
    AST_RETURN_IF_ERR(cudaGetLastError());
    gather_rows_kernel<<<dim3(R, 1), 128, 0, s>>>(ht_nxt, ht_cur, parent, R,
                                                  A, done);
    AST_RETURN_IF_ERR(cudaGetLastError());
  }
  return (int)cudaGetLastError();
}
