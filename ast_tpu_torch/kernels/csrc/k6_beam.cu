// K6: fused beam search frontier.
//
// Replaces ast_tpu/ops/fused_infer.py _beam_kernel (via
// beam_decode_fused; its step is _lstm_stack, _step_core and
// _context_out): per step, the decoder step for all R = B * N
// hypotheses, log-softmax over the vocabulary, top-K continuations per
// live hypothesis (ties to the lowest index), a frozen hypothesis
// contributing one candidate (score unchanged, token EOS), and N of the
// N * K candidates per utterance by (value desc, index asc) over
// distinct candidates.  It streams int32 tokens, parents and validity
// per step; backtracking and compaction run outside, as on the TPU.
//
// What bounds it on the H100: at R = 160 rows the step's products are
// f32 FMA-bound (2.4 GFLOP a step, 36 us at 67 TFLOP/s on 132 SMs; the
// cells run on 96 SMs, see decode_step.cu) and their input rows' loads,
// which share the SM's load path with the products' shared-memory reads;
// then launch latency: L + 5 launches a step.  About 132 MB of L2
// traffic a step.  Design: the step is decode_step.cu's, over R rows
// with N rows per utterance -- attention by one cluster of 3 blocks per
// utterance reads each encoder row once a pass for its N hypotheses.  The
// next step's products read h, c and ht at each row's parent (exact
// integer row indices, not one-hot products), so no gather runs between
// steps; state ping-pongs between two slots.  One block per utterance
// (beam_step_kernel, B blocks of N warps) does the rest of a step: warp
// n the log-softmax and K selection passes of hypothesis n, then warp 0
// the N-of-N*K selection, each pass taking the best candidate strictly
// after the previous one in (value desc, index asc) order -- distinct
// candidates without a taken-mask, even when N > K.  The device-side
// done flag ends the work once every hypothesis has finished (the last
// block of a step counts the utterances whose slots have all finished);
// later steps stream EOS, identity parents and valid = 0.  Every launch
// is a programmatic dependent launch.
//
// bfloat16 (k6_beam_decode_bf16; ast_tpu's compute_dtype bfloat16): the
// packed matrices and the encoder states in bf16, the embedding and the
// biases f32 holding bf16 values; h, c, ht, the logits, the log-softmax,
// top-K and the scores in f32 (decode_step.cu's step at W =
// __nv_bfloat16).  Its products run on the tensor cores (mma.sync
// m16n8k16 bf16 -> f32, weight tiles packed once per model in the
// B-fragment order), which removes the FMA time that bound the R = 160
// cells at f32.  What bounds it now: the cells, half of the call's
// device time (27 us a launch, 40 at f32); a cell launch's own 21 us
// past the dependent-launch wait: 11.5 in the 12-tile pipeline (the tile
// barriers and the next tile's row gather 4.9, the rounding into the
// bf16 tile 2.7, mma 3.2), 1.8 filling the ring and 7.6 in the cluster
// barriers and the DSMEM epilogue (scripts/torch_prod_phases.py;
// PERF.md); then the chain of L + 5 launches a step.  A deeper
// ring did not help (PERF.md).
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

// One block of N warps per utterance b.  Warp n: log-softmax of row
// r = b N + n over V, then K passes, each taking the best log-prob
// strictly after the previous pick in (value desc, index asc) order:
// candidates score + logp (for a finished row, score for k = 0 and
// score + NEG_INF after it, with token EOS).  Then warp 0 picks N of the
// N * K candidates, updates score / fin / next token / parent row and
// writes the step's output streams.  count (2) is zero between steps:
// the utterances whose slots have all finished, and the blocks done with
// this step; the last block sets *done when every utterance is finished
// and zeroes both.  Dynamic shared memory: N * K floats and ints.
__global__ void beam_step_kernel(const float* logits, int V, int N, int K,
                                 float* score, int* fin, int* tok_in,
                                 int* parent, int* tok_out, int* par_out,
                                 int* val_out, int* count, int* done) {
  ast::grid_dep_wait();
  const int b = blockIdx.x, lane = threadIdx.x & 31, n = threadIdx.x >> 5;
  const int r = b * N + n, NK = N * K;
  if (*done) {
    if (lane == 0) {
      tok_out[r] = ast::EOS_ID;
      par_out[r] = n;
      val_out[r] = 0;
    }
    return;
  }
  ast::grid_dep_launch();
  extern __shared__ float cand[];
  float* cval = cand;
  int* ctok = reinterpret_cast<int*>(cand + NK);
  const float sc = score[r];
  if (fin[r]) {
    for (int k = lane; k < K; k += 32) {
      cval[n * K + k] = sc + (k == 0 ? 0.f : ast::NEG_INF);
      ctok[n * K + k] = ast::EOS_ID;
    }
  } else {
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
        cval[n * K + k] = sc + bv;
        ctok[n * K + k] = bi;
      }
    }
  }
  __syncthreads();
  if (n != 0) return;

  float pv = INFINITY;
  int pi = -1;
  float my_v = 0.f;
  int my_m = 0;
  for (int j = 0; j < N; ++j) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int m = lane; m < NK; m += 32) {
      const float v = cval[m];
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
    tok = ctok[my_m];
    pfin = fin[b * N + par];
  }
  __syncwarp();  // every parent's fin is read before any slot's is written
  int now_fin = 1;
  if (lane < N) {
    const int rr = b * N + lane;
    now_fin = (pfin || tok == ast::EOS_ID) ? 1 : 0;
    score[rr] = my_v;
    fin[rr] = now_fin;
    tok_in[rr] = tok;
    parent[rr] = b * N + par;
    tok_out[rr] = tok;
    par_out[rr] = par;
    val_out[rr] = 1 - pfin;
  }
  const bool all = __all_sync(FULL, now_fin != 0);
  if (lane == 0) {
    if (all) atomicAdd(&count[0], 1);
    __threadfence();
    if (atomicAdd(&count[1], 1) == (int)gridDim.x - 1) {
      if (atomicAdd(&count[0], 0) == (int)gridDim.x) *done = 1;
      count[0] = 0;
      count[1] = 0;
    }
  }
}

// enc: (B, T, He); weights as in ast::StepWeightsT<W>; R = B * N.
// State, initialised by the caller: hbuf and cbuf (2, L, R, H) with h0 /
// c0 (repeated N times per utterance) in slot 0, htbuf (2, R, A) with 0
// in slot 0, tok_in (R) = GO, score (R) = 0 for slot 0 of each utterance
// and NEG_INF for the others, fin (R) = 0, done (1) = 0, parent (R) =
// 0 .. R-1, count (2) = 0.  Scratch: q, cv (R, He), logits (R, V).
// Outputs: tok_out, par_out, val_out (stop, R) int32; score holds the
// final scores.
template <typename W>
int beam_decode(const W* enc, const float* embed, const W* cell,
                const float* bias, const W* wa, const float* wa_b,
                const W* ctx_w, const float* ctx_b, const W* out_w,
                const float* out_b, float* hbuf, float* cbuf, float* htbuf,
                int* tok_in, float* score, int* fin, int* done, int* parent,
                int* count, float* q, float* cv, float* logits, int* tok_out,
                int* par_out, int* val_out, int B, int N, int K, int T,
                int H, int L, int E, int A, int V, int stop, int He,
                void* stream) {
  if (N > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ast::StepWeightsT<W> w = {embed, cell,  bias,  wa, wa_b, ctx_w,
                                  ctx_b, out_w, out_b, L,  H,    E,
                                  A,     V,     He};
  const int R = B * N;
  const long state = (long)L * R * H;
  const size_t cand_bytes = (size_t)N * K * (sizeof(float) + sizeof(int));
  for (int t = 0; t < stop; ++t) {
    const int i = t & 1, o = i ^ 1;
    ast::DecoderStep st = {};
    st.tok = tok_in;
    st.parent = parent;
    st.ht_in = htbuf + i * (long)R * A;
    st.h_in = hbuf + i * state;
    st.c_in = cbuf + i * state;
    st.h_out = hbuf + o * state;
    st.c_out = cbuf + o * state;
    st.q = q;
    st.cv = cv;
    st.ht_out = htbuf + o * (long)R * A;
    st.logits = logits;
    AST_RETURN_IF_ERR(ast::decode_step(w, enc, T, N, st, R, done, s));
    const long off = (long)t * R;
    AST_RETURN_IF_ERR(ast::launch_ex(
        beam_step_kernel, dim3(B), dim3(32 * N), cand_bytes, 1, s,
        logits, V, N, K, score, fin, tok_in, parent, tok_out + off,
        par_out + off, val_out + off, count, done));
  }
  return (int)cudaGetLastError();
}

}  // namespace

AST_EXPORT int k6_beam_decode(
    const float* enc, const float* embed, const float* cell,
    const float* bias, const float* wa, const float* wa_b,
    const float* ctx_w, const float* ctx_b, const float* out_w,
    const float* out_b, float* hbuf,
    float* cbuf, float* htbuf, int* tok_in, float* score, int* fin,
    int* done, int* parent, int* count, float* q, float* cv, float* logits,
    int* tok_out, int* par_out, int* val_out, int B, int N, int K, int T,
    int H, int L, int E, int A, int V, int stop, int He, void* stream) {
  return beam_decode(enc, embed, cell, bias, wa, wa_b, ctx_w, ctx_b, out_w,
                     out_b, hbuf, cbuf, htbuf, tok_in, score, fin, done,
                     parent, count, q, cv, logits, tok_out, par_out, val_out,
                     B, N, K, T, H, L, E, A, V, stop, He, stream);
}

// The same with enc, cell, wa, ctx_w and out_w in bfloat16.
AST_EXPORT int k6_beam_decode_bf16(
    const __nv_bfloat16* enc, const float* embed, const __nv_bfloat16* cell,
    const float* bias, const __nv_bfloat16* wa, const float* wa_b,
    const __nv_bfloat16* ctx_w, const float* ctx_b,
    const __nv_bfloat16* out_w, const float* out_b, float* hbuf,
    float* cbuf, float* htbuf, int* tok_in, float* score, int* fin,
    int* done, int* parent, int* count, float* q, float* cv, float* logits,
    int* tok_out, int* par_out, int* val_out, int B, int N, int K, int T,
    int H, int L, int E, int A, int V, int stop, int He, void* stream) {
  return beam_decode(enc, embed, cell, bias, wa, wa_b, ctx_w, ctx_b, out_w,
                     out_b, hbuf, cbuf, htbuf, tok_in, score, fin, done,
                     parent, count, q, cv, logits, tok_out, par_out, val_out,
                     B, N, K, T, H, L, E, A, V, stop, He, stream);
}
