// Shared declarations of the hand-written Hopper kernels (sm_90a).
//
// decode_step.cu holds the one product every kernel runs on (each weight
// read once a launch: packed tiles by bulk copy, the input axis split over
// a thread-block cluster, the cell's gate math or a linear layer's bias
// and activation in the epilogue) and attention by a cluster per utterance.
// It is launched three ways: as the decode step of K5 (k5_greedy.cu) and
// K6 (k6_beam.cu); one product at a time, through the launchers declared
// below, by the host time loops of decoder training (k3_decoder_fwd.cu,
// k4_decoder_bwd.cu); and as a wave -- up to MAX_WAVE_GROUPS independent
// products of one launch -- by the encoder (k1_encoder.cu,
// k2_encoder_bwd.cu), whose cells (step t, layer l) with equal t + l do
// not depend on one another.  Everything is float32 with FMA accumulation;
// no library GEMM is called.  The eval products (K1 eval, K5, K6) also run
// with bfloat16 weights (W = __nv_bfloat16, ast_tpu's compute_dtype
// bfloat16): the packed matrices in bf16, each input value rounded to bf16
// where the product reads it (__float2bfloat16_rn), and the sums in f32
// FMAs -- a product of two bf16 values is exact in f32, so only the order
// of the sum differs from ast_tpu's f32-accumulated bf16 dot.
//
// Every exported entry point launches on the caller's stream, never
// synchronises, allocates nothing, and returns cudaGetLastError() as an
// int (0 = every launch was accepted).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <utility>

#define AST_EXPORT extern "C" __attribute__((visibility("default")))

#define AST_RETURN_IF_ERR(expr)                    \
  do {                                             \
    cudaError_t err_ = (expr);                     \
    if (err_ != cudaSuccess) return (int)err_;     \
  } while (0)

namespace ast {

constexpr float NEG_INF = -1e30f;
constexpr int PAD_ID = 0;
constexpr int GO_ID = 1;
constexpr int EOS_ID = 2;
constexpr unsigned FULL_MASK = 0xffffffffu;

// The counter hash of ast_tpu's dropout (ops/fused_lstm.py _drop_mask),
// in uint32: an element with flat index `flat` is kept when
// drop_hash(flat, seed) >= int(rate * 2**32).
static __device__ __forceinline__ unsigned drop_hash(unsigned flat,
                                                     unsigned seed) {
  unsigned x = flat + seed * 2654435761u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

static __device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

static __device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// Row argmax by one warp: the largest of x[0 .. V-1], ties to the lowest
// index, in every lane; 0 for an all-NaN row, so a gather by it stays in
// bounds.
static __device__ __forceinline__ int warp_argmax(const float* x, int V) {
  const int lane = threadIdx.x & 31;
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int v = lane; v < V; v += 32) {
    const float xv = x[v];
    if (xv > bv) {
      bv = xv;
      bi = v;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL_MASK, bv, o);
    const int oi = __shfl_xor_sync(FULL_MASK, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  return bi < V ? bi : 0;
}

// One input segment of a row-wise product.  Row r of the segment is
// src + row(r) * K, with row(r) = idx ? idx[r] : r.
struct Seg {
  const float* src;
  const int* idx;
  int K;
};

// Backward of one LSTM cell step, elementwise over (R, H)
// (ast_tpu/ops/fused_decoder.py _bwd_kernel's gate backward), as the
// epilogue of K4's products runs it (BwdEpilogue):  cons, the gradient
// arriving from above, goes through the forward's dropout mask (kept
// values times keep_scale), dh = dh_carry + cons,
//   dc = dc + dh * o * (1 - tanh(c)^2),  dz = [dc g i(1-i) |
//   dc c_prev f(1-f) | dc i (1-g^2) | dh tanh(c) o(1-o)],  dc <- dc * f.
// dh is read from rows of dh_ld floats (column 0 .. H-1).
struct CellBwdArgs {
  const float* dh; int dh_ld;
  const float* acts;      // (R, 4H)
  const float* c_new;     // (R, H)
  const float* c_prev;    // (R, H); nullptr = 0
  float* dc;              // (R, H) carry, in place
  float* dz;              // (R, 4H)
  unsigned seed, threshold;
  float keep_scale;
  int R, H;
};

// One product of decode_step.cu:  z = [seg0 | seg1 | seg2] @ W, W packed
// as (column blocks, ktot, 64) with its columns zero-padded to a multiple
// of 64, in float32 or (the eval products) bfloat16, as the launch says.  A linear layer writes out = act(z + bias) (R, N), bias nullptr
// = none.  A cell (N = H; packed column q * 16 + u of block cb is gate q
// of unit 16 cb + u) takes the gates [i, f, g, o] of z + bias, c_out =
// f * c_in[c_idx[r]] + i * g, out = h = o * tanh(c_out).  Every segment's
// K is a multiple of 32, every source 16-byte aligned; out and c_out must
// not alias an input.  The launch returns at once while *done != 0.
struct Prod {
  Seg seg[3];
  int nseg;
  const void* w;  // float or __nv_bfloat16, by the launch
  const float* bias;
  int R, N, act_tanh;
  float* out;
  const float* c_in;
  const int* c_idx;  // nullptr = row r
  float* c_out;
  const int* done;
};

// The train mode of a cell product (a separate kernel, so the eval launch
// is unchanged): acts (R, 4H) gets the post-activation gates [i|f|g|o],
// Prod::out the pre-dropout h, and x_drop (R, H) the layer's output
// x = drop_hash(r * H + j, seed) < threshold ? 0 : h / div (threshold 0:
// x = h).
struct CellTrainOut {
  float* acts;
  float* x_drop;
  unsigned seed, threshold;
  float div;
};

// The backward mode of a linear product (K4; no bias, no activation),
// which finishes in its epilogue what the summed row z feeds, element by
// element, so nothing takes a second pass over memory.  Columns [0,
// n_carry) go to Prod::out (R, n_carry): the dh carry.  The columns after
// them are the gradient arriving at the layer below.  With cell.dz set
// they are H wide and the `cons` of that layer's cell backward `cell`
// (CellBwdArgs), run here.  Else (layer 0's product) the next E columns,
// through the step's embedding dropout mask (seed over (R, E), kept
// values times inv), go to d_emb (R, E), and the
// A columns after them, the input-feeding gradient, give the step
// before's d_pre = (d_ht + z) (1 - ht^2) (R, A) -- unless d_pre is
// nullptr (step 0).
struct BwdEpilogue {
  int n_carry;
  CellBwdArgs cell;
  float* d_emb;
  int E, A;
  unsigned seed, threshold;
  float inv;
  const float* d_ht;
  const float* ht;
  float* d_pre;
};

// What an encoder cell's epilogue adds to a cell product (K1; a kernel of
// its own for eval and for train mode, so the decoders' cells compile
// without it): `pre` (R, 4H, gates [i|f|g|o] as in the unpacked weights)
// joins z + bias -- layer 0's input projection, hoisted out of the
// recurrence -- and the layer's output also goes to y_out (R, H), the top
// layer's row of `outs`.  Eval: the output is h, and c_in may be c_out
// (one thread reads and writes an element).  Train: acts (R, 4H) gets the
// gates, Prod::out the pre-dropout h, and x_drop (R, H) the output
// x = drop_hash(flat0 + r * H + j, seed) < threshold ? 0 : h * keep_scale
// (threshold 0: x = h); flat0 places the rows in the mask's flat index
// (the direction's d * B * H).
struct EncCell {
  const float* pre;  // nullptr = none
  float* y_out;      // nullptr = none
  float* acts;
  float* x_drop;
  unsigned seed, threshold, flat0;
  float keep_scale;
};

struct NoExtra {};

// One launch's independent products: product g is p[g] with the epilogue
// extra x[g], all of one kind and with equal R.  The launcher fills
// cb_end (the column blocks of products 0 .. g), by which a block finds
// its product.
constexpr int MAX_WAVE_GROUPS = 8;
template <typename Extra>
struct Wave {
  int n;
  int cb_end[MAX_WAVE_GROUPS];
  Prod p[MAX_WAVE_GROUPS];
  Extra x[MAX_WAVE_GROUPS];
};

// The decoder weights of the decode step (decode_step.cu), the products'
// matrices packed by ops/fused_infer.pack_step_weights as (column
// blocks, K, 64) in W (float or __nv_bfloat16): the cell's [wx; wh] of
// layer l (K = E + A + H for layer 0, 2H after; packed column q * 16 + u
// of block cb is gate q of unit 16 cb + u), one layer after another, and
// wa (H, H), ctx_w (2H, A), out_w (A, V) with their columns padded to a
// multiple of 64.  The embedding and the biases are float32 (at bf16,
// holding bf16-rounded values).
template <typename W>
struct StepWeightsT {
  const float* embed;    // (V, E)
  const W* cell;         // the L packed cell matrices
  const float* bias;     // (L, 4H)
  const W* wa;           // packed (H, H)
  const float* wa_b;     // (H)
  const W* ctx_w;        // packed (2H, A)
  const float* ctx_b;    // (A)
  const W* out_w;        // packed (A, V)
  const float* out_b;    // (V)
  int L, H, E, A, V;
};

// Per-step scratch and state of a decoder run over R rows.  Row r
// continues the state of row parent[r] of the previous step (nullptr:
// of row r), so no state is copied between steps; the outputs must not
// alias the inputs.
struct DecoderStep {
  const int* tok;      // (R) input token of this step
  const int* parent;   // (R) or nullptr
  const float* ht_in;  // (R, A) attentional state of the previous step
  const float* h_in;   // (L, R, H)
  const float* c_in;   // (L, R, H)
  float* h_out;        // (L, R, H)
  float* c_out;        // (L, R, H)
  float* q;            // (R, H) attention query
  float* cv;           // (R, H) context vector
  float* ht_out;       // (R, A)
  float* logits;       // (R, V)
};

// The encoder's waves (decode_step.cu), programmatic dependent launches:
// w.n <= MAX_WAVE_GROUPS cell products in eval or train mode (K1), or
// linear products without bias (K2); launch_cell_wave_bf16: eval cells
// whose packed weights are bfloat16.
cudaError_t launch_cell_wave(Wave<EncCell>& w, bool train, cudaStream_t s);
cudaError_t launch_cell_wave_bf16(Wave<EncCell>& w, cudaStream_t s);
cudaError_t launch_linear_wave(Wave<NoExtra>& w, cudaStream_t s);
// The products and attention of decoder training (decode_step.cu), all
// programmatic dependent launches.  A linear product, a cell product in
// train mode, and a linear product in backward mode:
cudaError_t launch_linear_prod(const Prod& a, cudaStream_t s);
cudaError_t launch_cell_train_prod(const Prod& a, const CellTrainOut& tr,
                                   cudaStream_t s);
cudaError_t launch_bwd_prod(const Prod& a, const BwdEpilogue& e,
                            cudaStream_t s);
// cv[r] = softmax(enc[r] @ q[r]) @ enc[r] for the R rows of enc (R, T, H),
// also writing the softmax weights to alphas (R, T); a cluster of blocks
// per row splits T.
cudaError_t launch_attention_train(const float* enc, const float* q,
                                   float* cv, float* alphas, int R, int T,
                                   int H, cudaStream_t s);
// Its backward by the same clusters: d_alphas[t] = enc[r, t] . d_cv[r],
// d_scores = alphas (d_alphas - <d_alphas, alphas>) (R, T), d_q =
// d_scores @ enc[r] (R, H).
cudaError_t launch_attention_bwd(const float* enc, const float* alphas,
                                 const float* d_cv, float* d_scores,
                                 float* d_q, int R, int T, int H,
                                 cudaStream_t s);
// One decoder step for R rows, rows_per_utt of them per utterance of enc
// (decode_step.cu): embedding gather + input feeding, the L-layer LSTM
// stack, attention, ht = tanh(ctx([cv; h])), logits.  E, A and H must be
// multiples of 32.  Every kernel returns at once while *done != 0.  W
// (float or __nv_bfloat16) is the type of the products' matrices and of
// the encoder states; at bf16 attention rounds its softmax weights to
// bf16 before the context sum, as ast_tpu's _dot_c0 does.
template <typename W>
cudaError_t decode_step(const StepWeightsT<W>& w, const W* enc, int T,
                        int rows_per_utt, const DecoderStep& st, int R,
                        const int* done, cudaStream_t s);

// Programmatic dependent launch: wait for the grids this one depends on
// (their writes visible), and let the next grid launch.  Both are no-ops
// in a launch made without the attribute.
static __device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

static __device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// kernel<<<grid, block, smem, s>>>(args...) in clusters of `cluster`
// blocks along x, as a programmatic dependent launch: the grid may start
// while the one before it in the stream runs, and waits for it in
// grid_dep_wait().
template <typename... KArgs, typename... Args>
cudaError_t launch_ex(void (*kernel)(KArgs...), dim3 grid, dim3 block,
                      size_t smem, int cluster, cudaStream_t s,
                      Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

}  // namespace ast
