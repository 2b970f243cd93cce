// Per-step building blocks of the encoder kernels (K1, K2): the LSTM cell
// step, its elementwise backward and the row-wise linear layer.  (The
// decoder's products and attention, for decoding and for training, are
// decode_step.cu's.)
//
// Replaces the in-kernel products of ast_tpu/ops/fused_lstm.py
// (_fwd_kernel, _bwd_kernel).  On the TPU those kernels kept all weights
// in one core's VMEM for the whole sequence; here blocks run in
// parallel, so each kernel covers one (step, layer), and the time loop
// runs on the host (see k1_encoder.cu, k2_encoder_bwd.cu).
//
// What bounds them on the H100: at batch 32 every step re-reads the
// encoder's weights (4 MB in f32, L2-resident), and each output column's
// products are a few hundred FMAs per row -- the kernels are bound by
// the latency of dependent weight loads from L2 and by launch latency,
// not by FLOPs.  Design: a block owns COLS = 32 output columns (one
// hidden unit j per lane for the LSTM, computing all four gate columns
// j, H+j, 2H+j, 3H+j so the gate math fuses into the epilogue) and ROWS
// = 8 rows, so each weight value loaded serves 8 rows (4 rows when 8
// would leave SMs without a block, as at B = 32).  Its KSPLIT = 16 warps
// split the input axis, so each thread walks only 1/16 of it in one
// unrolled loop with many loads in flight.  The block's input rows are
// staged whole in shared memory once (one barrier, not one per tile);
// the same memory then holds the warps' partial sums, where warp w
// finishes row w.  Weight loads are coalesced along the column axis.  No
// tensor cores yet (f32 FMA).  A backward product x @ W^T runs as the
// same linear layer on a transposed copy of W that the wrapper makes
// once per call, so its weight loads stay coalesced.
#include <math.h>

#include "common.cuh"

namespace ast {
namespace {

constexpr int KSPLIT = 16;  // warps per block, splitting the input axis
constexpr int COLS = 32;    // output columns per block, one per lane
constexpr int THREADS = COLS * KSPLIT;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// xs[rr * ld + off + k] = seg[r0 + rr, k] (0 past the last row)
template <int ROWS>
__device__ __forceinline__ void stage(float* xs, int ld, int off,
                                      const Seg& sg, int g, int r0, int R) {
  if (sg.src == nullptr || sg.K == 0) return;
  const float* base = sg.src + g * sg.g_stride;
  const int tid = threadIdx.y * COLS + threadIdx.x;
  for (int i = tid; i < ROWS * sg.K; i += THREADS) {
    const int rr = i / sg.K, k = i % sg.K, r = r0 + rr;
    float v = 0.f;
    if (r < R) {
      const long row = sg.idx ? (long)sg.idx[r] : (long)r;
      v = base[row * sg.K + k];
    }
    xs[rr * ld + off + k] = v;
  }
}

// acc[rr][q] += sum over this warp's share of k < K of
//               xs[rr * ld + off + k] * W[k, col + q * qstride]
template <int ROWS, int NQ>
__device__ __forceinline__ void accumulate(
    float (&acc)[ROWS][NQ], const float* xs, int ld, int off, int K,
    const float* W, long ldw, long qstride, int col) {
#pragma unroll 4
  for (int k = threadIdx.y; k < K; k += KSPLIT) {
    const float* wrow = W + (long)k * ldw + col;
    float w[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) w[q] = __ldg(wrow + q * qstride);
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const float x = xs[rr * ld + off + k];
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[rr][q] = fmaf(x, w[q], acc[rr][q]);
    }
  }
}

// Sums the KSPLIT warps' partial sums: warp w < ROWS gets row w's NQ
// values for column threadIdx.x.  red: [KSPLIT][ROWS][NQ][COLS] floats,
// reusing the staged inputs' memory (hence the leading barrier).
template <int ROWS, int NQ>
__device__ __forceinline__ void reduce_split(const float (&acc)[ROWS][NQ],
                                             float* red, float (&out)[NQ]) {
  const int w = threadIdx.y, lane = threadIdx.x;
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      red[((w * ROWS + rr) * NQ + q) * COLS + lane] = acc[rr][q];
  __syncthreads();
  if (w >= ROWS) return;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < KSPLIT; ++k)
      s += red[((k * ROWS + w) * NQ + q) * COLS + lane];
    out[q] = s;
  }
}

// Dynamic shared memory of a block: the staged input rows, or the
// partial sums, whichever is larger.
template <int ROWS, int NQ>
size_t smem_bytes(int k_total) {
  const size_t in = (size_t)ROWS * k_total;
  const size_t red = (size_t)KSPLIT * ROWS * NQ * COLS;
  return (in > red ? in : red) * sizeof(float);
}

// The LSTM step; TRAIN adds the residual stores and dropout of CellTrain
// to the epilogue.
template <int ROWS, bool TRAIN>
__device__ __forceinline__ void lstm_cell_body(const CellArgs& a,
                                               const CellTrain& tr) {
  if (a.done && *a.done) return;
  extern __shared__ float smem[];
  const int g = blockIdx.z, H = a.H;
  const long H4 = 4L * H;
  const int j = blockIdx.x * COLS + threadIdx.x;
  const int r0 = blockIdx.y * ROWS;
  const int ka = a.xa.src ? a.xa.K : 0, kb = a.xb.src ? a.xb.K : 0;
  const int ld = ka + kb + H;
  stage<ROWS>(smem, ld, 0, a.xa, g, r0, a.R);
  stage<ROWS>(smem, ld, ka, a.xb, g, r0, a.R);
  stage<ROWS>(smem, ld, ka + kb, a.hp, g, r0, a.R);
  __syncthreads();

  float acc[ROWS][4];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[rr][q] = 0.f;
  if (j < H) {
    const float* wx = a.wx + g * a.wx_g;
    if (ka + kb) accumulate<ROWS, 4>(acc, smem, ld, 0, ka + kb, wx, H4, H, j);
    accumulate<ROWS, 4>(acc, smem, ld, ka + kb, H, a.wh + g * a.wh_g, H4, H,
                        j);
  }
  float z[4];
  reduce_split<ROWS, 4>(acc, smem, z);
  const int r = r0 + threadIdx.y;
  if (threadIdx.y >= ROWS || j >= H || r >= a.R) return;

  const float* bias = a.bias + g * a.b_g;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    z[q] += bias[q * H + j];
    if (a.pre) z[q] += a.pre[g * a.pre_g + (long)r * H4 + q * H + j];
  }
  const float ig = sigmoidf(z[0]), fg = sigmoidf(z[1]);
  const float gg = tanhf(z[2]), og = sigmoidf(z[3]);
  const long ci = g * a.c_g + (long)r * H + j;
  const float c = fg * a.c_in[ci] + ig * gg;
  const float h = og * tanhf(c);
  a.c_out[ci] = c;
  a.h_out[g * a.h_g + (long)r * H + j] = h;
  float x = h;
  if constexpr (TRAIN) {
    if (tr.acts_out) {
      float* ao = tr.acts_out + g * tr.acts_g + (long)r * H4 + j;
      ao[0] = ig;
      ao[H] = fg;
      ao[2 * H] = gg;
      ao[3 * H] = og;
    }
    if (tr.threshold) {
      const unsigned flat = (unsigned)(g * tr.mask_g + (long)r * H + j);
      x = drop_hash(flat, tr.seed) < tr.threshold ? 0.f : h * tr.keep_scale;
    }
    if (tr.x_out) tr.x_out[g * tr.x_g + (long)r * H + j] = x;
  }
  if (a.y_out) a.y_out[g * a.y_g + (long)r * H + j] = x;
}

template <int ROWS>
__global__ void __launch_bounds__(THREADS) lstm_cell_kernel(CellArgs a) {
  lstm_cell_body<ROWS, false>(a, CellTrain{});
}

template <int ROWS>
__global__ void __launch_bounds__(THREADS)
    lstm_cell_train_kernel(CellArgs a, CellTrain tr) {
  lstm_cell_body<ROWS, true>(a, tr);
}

// One thread per (row, unit) of one group (blockIdx.y).
__global__ void lstm_cell_bwd_kernel(CellBwdArgs a) {
  const int g = blockIdx.y, H = a.H;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)a.R * H) return;
  const int r = (int)(idx / H), j = (int)(idx % H);
  const long H4 = 4L * H;
  float cons = a.cons ? a.cons[g * a.cons_g + (long)r * a.cons_ld + j] : 0.f;
  if (a.threshold) {
    const unsigned flat = (unsigned)(g * a.mask_g + (long)r * H + j);
    cons = drop_hash(flat, a.seed) < a.threshold ? 0.f : cons * a.keep_scale;
  }
  const float dh = a.dh[g * a.dh_g + (long)r * a.dh_ld + j] + cons;
  const float* ac = a.acts + g * a.acts_g + (long)r * H4 + j;
  const float ig = ac[0], fg = ac[H], gg = ac[2 * H], og = ac[3 * H];
  const float tc = tanhf(a.c_new[g * a.c_g + (long)r * H + j]);
  const float cp = a.c_prev ? a.c_prev[g * a.cp_g + (long)r * H + j] : 0.f;
  float* dcp = a.dc + g * a.dc_g + (long)r * H + j;
  const float dc = *dcp + dh * og * (1.f - tc * tc);
  *dcp = dc * fg;
  float* dz = a.dz + g * a.dz_g + (long)r * H4 + j;
  dz[0] = dc * gg * ig * (1.f - ig);
  dz[H] = dc * cp * fg * (1.f - fg);
  dz[2 * H] = dc * ig * (1.f - gg * gg);
  dz[3 * H] = dh * tc * og * (1.f - og);
}

// The row-wise linear layer; GROUPED runs group blockIdx.z at the strides
// of LinearArgs.  The group index is a template flag, not read at run
// time for one group: that read alone cost the decoders' one-group
// launches 0.5 % (K5 / K6 on the H100).
template <int ROWS, bool GROUPED>
__global__ void __launch_bounds__(THREADS) linear_kernel(LinearArgs a) {
  if (a.done && *a.done) return;
  extern __shared__ float smem[];
  const int g = GROUPED ? blockIdx.z : 0;
  const int n = blockIdx.x * COLS + threadIdx.x;
  const int r0 = blockIdx.y * ROWS;
  const int ka = a.xa.K, kb = a.xb.src ? a.xb.K : 0;
  const int ld = ka + kb;
  stage<ROWS>(smem, ld, 0, a.xa, g, r0, a.R);
  stage<ROWS>(smem, ld, ka, a.xb, g, r0, a.R);
  __syncthreads();
  float acc[ROWS][1];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) acc[rr][0] = 0.f;
  if (n < a.N)
    accumulate<ROWS, 1>(acc, smem, ld, 0, ld, a.w + g * a.w_g, a.N, 0, n);
  float v[1];
  reduce_split<ROWS, 1>(acc, smem, v);
  const int r = r0 + threadIdx.y;
  if (threadIdx.y >= ROWS || n >= a.N || r >= a.R) return;
  float y = v[0];
  if (a.bias) y += a.bias[n];
  if (a.act_tanh) y = tanhf(y);
  a.out[g * a.out_g + (long)r * a.N + n] = y;
}

// Rows per block: 8 (each weight load serves 8 rows) when that still
// gives at least one block per SM, else 4, so small batches fill the card.
bool few_blocks(long col_blocks, int R, int groups) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return col_blocks * ((R + 7) / 8) * groups < sms;
}

// Launch kernel<ROWS> with `bytes` of dynamic shared memory, opting in
// above the 48 KB default.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t bytes, cudaStream_t s,
                   const Args&... args) {
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, dim3(COLS, KSPLIT), bytes, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_lstm_cell(const CellArgs& a, int groups, cudaStream_t s,
                             const CellTrain* train) {
  const int col_blocks = (a.H + COLS - 1) / COLS;
  const int k_total = (a.xa.src ? a.xa.K : 0) + (a.xb.src ? a.xb.K : 0) + a.H;
  const bool four = few_blocks(col_blocks, a.R, groups);
  const dim3 grid(col_blocks, four ? (a.R + 3) / 4 : (a.R + 7) / 8, groups);
  const size_t bytes = four ? smem_bytes<4, 4>(k_total)
                            : smem_bytes<8, 4>(k_total);
  if (train)
    return four ? launch(lstm_cell_train_kernel<4>, grid, bytes, s, a, *train)
                : launch(lstm_cell_train_kernel<8>, grid, bytes, s, a, *train);
  return four ? launch(lstm_cell_kernel<4>, grid, bytes, s, a)
              : launch(lstm_cell_kernel<8>, grid, bytes, s, a);
}

cudaError_t launch_lstm_cell_bwd(const CellBwdArgs& a, int groups,
                                 cudaStream_t s) {
  constexpr int kThreads = 256;
  const long n = (long)a.R * a.H;
  lstm_cell_bwd_kernel<<<dim3((unsigned)((n + kThreads - 1) / kThreads),
                              groups), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_linear(const LinearArgs& a, cudaStream_t s, int groups) {
  const int col_blocks = (a.N + COLS - 1) / COLS;
  const int k_total = a.xa.K + (a.xb.src ? a.xb.K : 0);
  const bool four = few_blocks(col_blocks, a.R, groups);
  const dim3 grid(col_blocks, four ? (a.R + 3) / 4 : (a.R + 7) / 8, groups);
  const size_t bytes = four ? smem_bytes<4, 1>(k_total)
                            : smem_bytes<8, 1>(k_total);
  if (groups > 1)
    return four ? launch(linear_kernel<4, true>, grid, bytes, s, a)
                : launch(linear_kernel<8, true>, grid, bytes, s, a);
  return four ? launch(linear_kernel<4, false>, grid, bytes, s, a)
              : launch(linear_kernel<8, false>, grid, bytes, s, a);
}

}  // namespace ast
