// The step kernels of K1-K6: one product design and attention.  The
// decode step of K5 (greedy) and K6 (beam): one decoder step for R rows --
// embedding gather + input feeding, the L-layer LSTM stack, the attention
// query, Luong attention, ht = tanh(ctx([cv; h])), logits.  Launched one
// by one from the host loops of k3_decoder_fwd.cu and k4_decoder_bwd.cu,
// the same products and attention for decoder training: the cell with a
// train epilogue (gates, c, h and the dropped h to the residual streams),
// attention that also writes its weights, and its backward.  And for the
// encoder (k1_encoder.cu, k2_encoder_bwd.cu) the same product as a wave
// (wave_kernel): one launch runs up to MAX_WAVE_GROUPS independent
// products -- the cells (step t, layer l, direction d) of equal t + l,
// each with its own inputs, packed weights, state and epilogue (eval or
// train cell with layer 0's hoisted projection added in, or the backward's
// linear product) -- whose column blocks lie side by side in the grid; a
// block finds its product from its index in a table passed by value.
//
// Replaces the per-step body that ast_tpu/ops/fused_infer.py's
// _greedy_kernel and _beam_kernel share (_lstm_stack, _step_core,
// _context_out).  On the TPU one core held every weight in VMEM for the
// whole decode; here a step is L + 4 launches of the two kernels below,
// issued by the host loops of k5_greedy.cu and k6_beam.cu, and each
// launch reads every weight element from L2 once.
//
// What bounds it on the H100 (f32, no tensor cores: TF32 would break the
// 1e-4 token tolerance): FMAs at K6's R = 160 (0.75 GFLOP a layer-0
// cell); at K5's R = 32 the bytes in flight per SM -- with one block of
// 256 threads an SM, a block's own loads (or cp.async) reach only a small
// share of L2's bandwidth.  So tiles move ahead of use through a ring in
// shared memory, and the weight tiles, the bulk of the bytes, by TMA bulk
// copy (cp.async.bulk, completion on an mbarrier).
//
// Products (prod_kernel, the three cells and the q, ctx and logits
// linears).  A block owns NC = 64 output columns -- for a cell, all four
// gates of 16 hidden units, so the gate epilogue stays fused -- for ALL
// R rows of the step (up to 256; more in 256-row chunks).  The weights
// are packed once per model (ops/fused_infer.pack_step_weights, through
// models/seq2seq.decode_weights; in training, where they change every
// step, once per K3 call, and K4's transposed matrices once per K4 call
// by ops/fused_decoder.pack_backward_weights) as [column block][k][64],
// so a block's tile of KT = 32 input rows is one contiguous 8 KB bulk
// copy; the input rows are gathered through each segment's row index by
// the threads' 16-byte cp.async.  The ring holds
// 8 tiles at 32 rows, 4 at 64, 3 from 128 (ProdShape).  Register tile:
// TR rows x 4 columns a thread, 16 column groups x RGN row groups x KGN
// input-axis groups = 256 threads (R = 32: 8 rows, 4 row groups, 4
// k-groups; R = 160: 10 rows, 16 row groups), the inputs read as float4
// along k.  Too few column slices fill 132 SMs at H = 512 (32 for a
// cell, 8 for q and ctx, 18 for the logits), so the input axis is also
// split across the CS blocks of a thread-block cluster.  CS is the
// largest cluster (<= 8) of which all the launch's clusters run at once
// with one block per SM (cudaOccupancyMaxActiveClusters; every block asks
// for >= 116 KB of shared memory, so no SM runs two): on the H100 only
// 30 clusters of 4 fit its GPCs, so the cells' 32 slices run as clusters
// of 3 (96 SMs), q and ctx as clusters of 8 (64 SMs).  The partial sums
// go to each block's shared memory; after cluster.sync() block c of the
// cluster sums rows [c R / CS, (c+1) R / CS) over its k-groups and all
// CS blocks through distributed shared memory and runs the epilogue
// (gates, or bias + tanh).  No atomics, no second pass.
//
// Per-step L2 traffic at es_en_20h width (H = A = 512, E = 128, L = 3,
// V = 1,098, T' = 160, B = 32): the weights once, 31.6 MB; the inputs
// once per column slice, (1152 + 1024 + 1024) x 32 slices x R x 4 B for
// the cells plus R x (512 x 8 + 1024 x 8 + 512 x 18) x 4 B for the
// linears -- 15.9 MB at R = 32 (K5), 79.4 MB at R = 160 (K6); the
// encoder states twice (scores, then context), 21 MB.  Total about 68 MB
// (K5) and 132 MB (K6) a step, against 31.6 MB of weights alone.
//
// Attention (attention_kernel): one cluster of CS blocks per utterance
// serves its N rows (N = 1 greedy, the N hypotheses of a beam), so each
// encoder row is read once a pass for all N queries; the CS blocks split
// T' (3 at B = 32: 96 blocks) and read their rows twice, for the scores
// and for the context, with 16-32 loads in flight a thread.  The softmax
// max and sum, and the context vector's partial sums, are reduced
// through distributed shared memory.
//
// Rows continue a parent's state through DecoderStep::parent (beam
// search): the products read h, c and ht of the previous step at the
// parent row, so no gather runs between steps.
//
// Every launch is a programmatic dependent launch: each kernel waits for
// its predecessor (griddepcontrol.wait) before it reads anything, then
// lets its successor launch, so launch latency hides behind the previous
// kernel's tail (K5 -12.7 %, K6 -2.6 % against plain launches, measured
// on the H100 when this was chosen; PERF.md).
//
// bfloat16 (ast_tpu's compute_dtype bfloat16; K1 eval, K5, K6): the eval
// products and attention are templates over W, the element type of the
// packed matrices and of the encoder states.  At W = __nv_bfloat16 a
// weight tile is one 4 KB bulk copy (8 KB in f32) and widens to f32 in
// registers; each thread rounds the input values it staged to bf16
// (__float2bfloat16_rn) before the tile is read, which are ast_tpu's
// rounding points (_dot casts the left operand to the weight's dtype);
// the sums stay f32 FMAs.  Attention reads bf16 encoder rows, keeps the
// query and the softmax in f32, and rounds the normalised weights to
// bf16 before the context sum (ast_tpu's _dot_c0).  A step then reads
// half the bytes of weights and encoder states.
#include <cooperative_groups.h>
#include <math.h>

#include <mutex>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

#define STEP_RETURN_IF_ERR(expr)               \
  do {                                         \
    const cudaError_t err_ = (expr);           \
    if (err_ != cudaSuccess) return err_;      \
  } while (0)

namespace ast {
namespace {

constexpr int THREADS = 256;
constexpr int KT = 32;           // input-axis tile
constexpr int NC = 64;           // output columns per block
constexpr int UNITS = NC / 4;    // hidden units per cell block
constexpr int XLD = KT + 4;      // padded row of a staged input tile
constexpr int MAX_CLUSTER = 8;   // portable cluster size
constexpr int NQ = 8;            // queries scored together in attention
// shared memory a block asks for at least: more than half an SM's, so
// that each SM runs one block of a launch
constexpr size_t EXCLUSIVE_SMEM = 116 * 1024;
constexpr int TU = 4;            // encoder rows a warp scores together
constexpr int TC = 8;            // encoder rows in flight per context thread

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

template <typename W>
constexpr bool IS_BF16 = std::is_same<W, __nv_bfloat16>::value;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Four consecutive elements of W at p (16-byte aligned for float, 8 for
// bf16) as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// The same through the read-only cache: group i of four (encoder rows)
__device__ __forceinline__ float4 ldg4(const float* p, long i) {
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}

__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p, long i) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p) + i);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// make the initialised barriers visible to the bulk-copy (async) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` of bulk copies on the barrier's phase
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned ok = 0;
  while (!ok) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// global -> this block's shared memory, `bytes` (a multiple of 16, both
// addresses 16-byte aligned), completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 16 bytes global -> shared, asynchronously (this thread's cp.async
// group)
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A block's tiles: a ring of 8 stages up to 32 rows (latency is what a
// few rows run into), 4 up to 64, 3 from 128 (160 rows: 94 KB); a stage
// holds the f32 input rows and a weight tile of W.
template <int TR, int RGN, typename W = float>
struct ProdShape {
  static constexpr int KGN = 16 / RGN;     // input-axis groups
  static constexpr int RB = TR * RGN;      // rows of a block
  static constexpr int STAGES = RB <= 32 ? 8 : RB <= 64 ? 4 : 3;
  static constexpr int XS = RB * XLD;      // staged input floats
  static constexpr int WTILE = KT * NC * (int)sizeof(W);  // bytes
  static constexpr int STAGE = XS + WTILE / (int)sizeof(float);
  static constexpr int RING = STAGES * STAGE;
  static constexpr int PART = KGN * RB * NC;
  static constexpr size_t NEED =
      (size_t)(RING > PART ? RING : PART) * sizeof(float);
  static constexpr size_t BYTES =
      NEED > EXCLUSIVE_SMEM ? NEED : EXCLUSIVE_SMEM;
};

// What a product's epilogue does with the summed rows (see Prod,
// CellTrainOut, BwdEpilogue and EncCell in common.cuh).  The PROD_WAVE_*
// modes are one product of a wave (Wave): the encoder's cell in eval and
// train mode, and a linear product.
enum {
  PROD_LINEAR = 0,
  PROD_CELL = 1,
  PROD_CELL_TRAIN = 2,
  PROD_BWD = 3,
  PROD_WAVE_CELL = 4,
  PROD_WAVE_CELL_TRAIN = 5,
  PROD_WAVE_LINEAR = 6
};

// Element (r, j) of the cell backward `a` (CellBwdArgs, one group) given
// the gradient `cons` arriving from above, before its dropout mask; the
// thread that owns the element reads and writes its dc.  The encoder's
// cell backward (k2_encoder_bwd.cu) is a kernel of its own with the same
// arithmetic: sharing this function with it cost K2 1.7-2.0 % (H100,
// same-call A/B).
__device__ __forceinline__ void cell_bwd_element(const CellBwdArgs& a, int r,
                                                 int j, float cons) {
  const int H = a.H;
  const long H4 = 4L * H;
  if (a.threshold)
    cons = drop_hash((unsigned)(r * H + j), a.seed) < a.threshold
               ? 0.f
               : cons * a.keep_scale;
  const float dh = a.dh[(long)r * a.dh_ld + j] + cons;
  const float* ac = a.acts + (long)r * H4 + j;
  const float ig = ac[0], fg = ac[H], gg = ac[2 * H], og = ac[3 * H];
  const float tc = tanhf(a.c_new[(long)r * H + j]);
  const float cp = a.c_prev ? a.c_prev[(long)r * H + j] : 0.f;
  float* dcp = a.dc + (long)r * H + j;
  const float dc = *dcp + dh * og * (1.f - tc * tc);
  *dcp = dc * fg;
  float* dz = a.dz + (long)r * H4 + j;
  dz[0] = dc * gg * ig * (1.f - ig);
  dz[H] = dc * cp * fg * (1.f - fg);
  dz[2 * H] = dc * ig * (1.f - gg * gg);
  dz[3 * H] = dh * tc * og * (1.f - og);
}

// ex: the CellTrainOut of PROD_CELL_TRAIN, the BwdEpilogue of PROD_BWD,
// the EncCell of the wave's cells.  wave_cb: in a wave, the block's column
// block within its product (else the block index gives it).  W: the
// packed matrix's element type (bf16 only for the eval modes).
template <int TR, int RGN, int MODE, typename W, typename Extra>
__device__ __forceinline__ void prod_body(const Prod& a, const Extra& ex,
                                          int wave_cb = 0) {
  constexpr bool WAVE = MODE >= PROD_WAVE_CELL;
  constexpr bool ENC_CELL =
      MODE == PROD_WAVE_CELL || MODE == PROD_WAVE_CELL_TRAIN;
  constexpr bool CELL =
      MODE == PROD_CELL || MODE == PROD_CELL_TRAIN || ENC_CELL;
  using S = ProdShape<TR, RGN, W>;
  constexpr int KGN = S::KGN, RB = S::RB, STAGES = S::STAGES;
  grid_dep_wait();
  if (a.done && *a.done) return;  // every block of the launch alike
  grid_dep_launch();
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ unsigned long long full[STAGES];
  const int tid = threadIdx.x;
  const int cb = WAVE ? wave_cb : blockIdx.x / cs;  // column block
  const int r0 = blockIdx.y * RB;
  const int rows = min(RB, a.R - r0);
  int ktot = 0;
  for (int s = 0; s < a.nseg; ++s) ktot += a.seg[s].K;
  const int nch = ktot / KT;
  const int c_beg = rank * nch / cs;
  const int n_ch = (rank + 1) * nch / cs - c_beg;
  const W* wb = static_cast<const W*>(a.w) + (long)cb * ktot * NC;

  // rows past R stay zero in every stage (no copy lands there)
  for (int i = tid; i < STAGES * (RB - rows) * XLD; i += THREADS) {
    const int st = i / ((RB - rows) * XLD), j = i % ((RB - rows) * XLD);
    smem[st * S::STAGE + rows * XLD + j] = 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s]);
    mbar_fence_init();
  }
  __syncthreads();

  // a stage: the weight tile by one bulk copy (thread 0), the input rows
  // by every thread's 16-byte cp.async (gathered through the row index)
  auto issue = [&](int stage, int ch) {
    float* xs = smem + stage * S::STAGE;
    const int k = ch * KT;
    if (tid == 0) {
      mbar_expect(&full[stage], S::WTILE);
      bulk_copy(xs + S::XS, wb + (long)k * NC, S::WTILE, &full[stage]);
    }
    int s = 0, off = 0;
    while (k >= off + a.seg[s].K) off += a.seg[s++].K;
    const Seg& sg = a.seg[s];
    const int kin = k - off;
    for (int i = tid; i < rows * (KT / 4); i += THREADS) {
      const int rr = i / (KT / 4), f = i % (KT / 4), r = r0 + rr;
      const long row = sg.idx ? (long)sg.idx[r] : (long)r;
      cp_async16(xs + rr * XLD + f * 4, sg.src + row * sg.K + kin + f * 4);
    }
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_ch) issue(s, c_beg + s);
    cp_commit();
  }

  // thread tile: rows rg + RGN p (p < TR) x columns 4 cg .. 4 cg + 3,
  // over the input quads k = 4 (kg + KGN j)
  float acc[TR][4];
#pragma unroll
  for (int p = 0; p < TR; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[p][e] = 0.f;
  const int cgp = tid & 15, g = tid >> 4;
  const int rg = g % RGN, kg = g / RGN;

  for (int i = 0; i < n_ch; ++i) {
    __syncthreads();  // chunk i - 1's stage is free again
    if (i + STAGES - 1 < n_ch)
      issue((i + STAGES - 1) % STAGES, c_beg + i + STAGES - 1);
    cp_commit();
    cp_wait<STAGES - 1>();  // this thread's rows of chunk i
    float* xs = smem + (i % STAGES) * S::STAGE;
    if constexpr (IS_BF16<W>) {
      // the values this thread staged, rounded to bf16 in place
      for (int e = tid; e < rows * (KT / 4); e += THREADS) {
        float4* v = reinterpret_cast<float4*>(xs + (e / (KT / 4)) * XLD +
                                              (e % (KT / 4)) * 4);
        float4 x = *v;
        x.x = bf16_round(x.x);
        x.y = bf16_round(x.y);
        x.z = bf16_round(x.z);
        x.w = bf16_round(x.w);
        *v = x;
      }
    }
    __syncthreads();        // everyone's
    mbar_wait(&full[i % STAGES], (unsigned)(i / STAGES) & 1u);
    const W* ws = reinterpret_cast<const W*>(xs + S::XS);
#pragma unroll
    for (int j = 0; j < KT / 4 / KGN; ++j) {
      const int kk = (kg + j * KGN) * 4;
      float4 xv[TR];
#pragma unroll
      for (int p = 0; p < TR; ++p)
        xv[p] = *reinterpret_cast<const float4*>(xs + (rg + RGN * p) * XLD +
                                                 kk);
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const float4 wv = load4(ws + (kk + d) * NC + cgp * 4);
#pragma unroll
        for (int p = 0; p < TR; ++p) {
          const float x = d == 0 ? xv[p].x
                          : d == 1 ? xv[p].y
                          : d == 2 ? xv[p].z
                                   : xv[p].w;
          acc[p][0] = fmaf(x, wv.x, acc[p][0]);
          acc[p][1] = fmaf(x, wv.y, acc[p][1]);
          acc[p][2] = fmaf(x, wv.z, acc[p][2]);
          acc[p][3] = fmaf(x, wv.w, acc[p][3]);
        }
      }
    }
  }
  __syncthreads();  // the ring is read; its memory takes the partials

  // partial sums (KGN, RB, NC); a cell's four gates of a unit side by side
  float* P = smem + kg * RB * NC;
#pragma unroll
  for (int p = 0; p < TR; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = cgp * 4 + e;
      const int pc = CELL ? (col % UNITS) * 4 + col / UNITS : col;
      P[(rg + RGN * p) * NC + pc] = acc[p][e];
    }
  cluster.sync();

  const int e0 = rank * rows / cs, e1 = (rank + 1) * rows / cs;
  if constexpr (MODE == PROD_BWD) {
    // one column a thread: an element's loads (the cell backward's gates,
    // c, dc and carry) wait on no other element's stores
    for (int it = tid; it < (e1 - e0) * NC; it += THREADS) {
      const int rr = e0 + it / NC, n = cb * NC + it % NC;
      if (n >= a.N) continue;
      float z = 0.f;
      for (int s = 0; s < cs; ++s) {
        const float* ps = cluster.map_shared_rank(smem, s);
#pragma unroll
        for (int q = 0; q < KGN; ++q) z += ps[(q * RB + rr) * NC + it % NC];
      }
      const int r = r0 + rr;
      const int m = n - ex.n_carry;  // column of the gradient below
      if (m < 0) {
        a.out[(long)r * ex.n_carry + n] = z;
      } else if (ex.cell.dz) {
        cell_bwd_element(ex.cell, r, m, z);
      } else if (m < ex.E) {
        if (ex.threshold)
          z = drop_hash((unsigned)(r * ex.E + m), ex.seed) < ex.threshold
                  ? 0.f
                  : z * ex.inv;
        ex.d_emb[(long)r * ex.E + m] = z;
      } else if (ex.d_pre) {
        const long i = (long)r * ex.A + m - ex.E;
        const float h = ex.ht[i];
        ex.d_pre[i] = (ex.d_ht[i] + z) * (1.f - h * h);
      }
    }
    cluster.sync();  // no block leaves while another reads its partials
    return;
  }
  for (int it = tid; it < (e1 - e0) * (NC / 4); it += THREADS) {
    const int rr = e0 + it / (NC / 4), c4 = it % (NC / 4);
    float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < cs; ++s) {
      const float4* ps =
          reinterpret_cast<const float4*>(cluster.map_shared_rank(smem, s));
#pragma unroll
      for (int q = 0; q < KGN; ++q) {
        const float4 v = ps[(q * RB + rr) * (NC / 4) + c4];
        z.x += v.x;
        z.y += v.y;
        z.z += v.z;
        z.w += v.w;
      }
    }
    const int r = r0 + rr;
    if constexpr (CELL) {
      const int H = a.N, j = cb * UNITS + c4;
      z.x += a.bias[j];
      z.y += a.bias[H + j];
      z.z += a.bias[2 * H + j];
      z.w += a.bias[3 * H + j];
      if constexpr (ENC_CELL) {
        if (ex.pre) {
          const float* pre = ex.pre + (long)r * 4 * H + j;
          z.x += pre[0];
          z.y += pre[H];
          z.z += pre[2 * H];
          z.w += pre[3 * H];
        }
      }
      const float ig = sigmoidf(z.x);
      const float fg = sigmoidf(z.y);
      const float gg = tanhf(z.z);
      const float og = sigmoidf(z.w);
      const long prow = a.c_idx ? (long)a.c_idx[r] : (long)r;
      const float c = fg * a.c_in[prow * H + j] + ig * gg;
      const float h = og * tanhf(c);
      a.c_out[(long)r * H + j] = c;
      a.out[(long)r * H + j] = h;
      if constexpr (ENC_CELL) {
        float x = h;
        if constexpr (MODE == PROD_WAVE_CELL_TRAIN) {
          float* ao = ex.acts + (long)r * 4 * H + j;
          ao[0] = ig;
          ao[H] = fg;
          ao[2 * H] = gg;
          ao[3 * H] = og;
          if (ex.threshold)
            x = drop_hash(ex.flat0 + (unsigned)(r * H + j), ex.seed) <
                        ex.threshold
                    ? 0.f
                    : h * ex.keep_scale;
          ex.x_drop[(long)r * H + j] = x;
        }
        if (ex.y_out) ex.y_out[(long)r * H + j] = x;
      }
      if constexpr (MODE == PROD_CELL_TRAIN) {
        float* ao = ex.acts + (long)r * 4 * H + j;
        ao[0] = ig;
        ao[H] = fg;
        ao[2 * H] = gg;
        ao[3 * H] = og;
        float xd = h;
        if (ex.threshold)
          xd = drop_hash((unsigned)(r * H + j), ex.seed) < ex.threshold
                   ? 0.f
                   : h / ex.div;
        ex.x_drop[(long)r * H + j] = xd;
      }
    } else {
      const float zv[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = cb * NC + c4 * 4 + e;
        if (n >= a.N) break;
        float y = zv[e];
        if (a.bias) y += a.bias[n];
        if (a.act_tanh) y = tanhf(y);
        a.out[(long)r * a.N + n] = y;
      }
    }
  }
  cluster.sync();  // no block leaves while another reads its partials
}

template <int TR, int RGN, bool CELL, typename W>
__global__ void __launch_bounds__(THREADS) prod_kernel(Prod a) {
  prod_body<TR, RGN, CELL ? PROD_CELL : PROD_LINEAR, W>(a, NoExtra{});
}

template <int TR, int RGN>
__global__ void __launch_bounds__(THREADS)
    prod_train_kernel(Prod a, CellTrainOut tr) {
  prod_body<TR, RGN, PROD_CELL_TRAIN, float>(a, tr);
}

template <int TR, int RGN>
__global__ void __launch_bounds__(THREADS)
    prod_bwd_kernel(Prod a, BwdEpilogue e) {
  prod_body<TR, RGN, PROD_BWD, float>(a, e);
}

// A wave: the cluster's slot among the launch's column blocks gives its
// product (the first whose cb_end lies past it) and its column block
// there.
template <int TR, int RGN, int MODE, typename Extra, typename W>
__global__ void __launch_bounds__(THREADS) wave_kernel(Wave<Extra> w) {
  const int slot = blockIdx.x / (int)cg::this_cluster().num_blocks();
  int g = 0;
  while (slot >= w.cb_end[g]) ++g;
  prod_body<TR, RGN, MODE, W>(w.p[g], w.x[g],
                              slot - (g ? w.cb_end[g - 1] : 0));
}

// cv[b N + n] = softmax(enc[b] @ q[b N + n]) @ enc[b] for the N rows of
// utterance b, by the cluster of blocks blockIdx.x / CS; block c of it
// takes encoder rows [c Tc, (c+1) Tc), read straight from L2 with many
// independent loads in flight per thread (TU rows per warp for the
// scores, TC rows per thread for the context).  Dynamic shared memory:
// the queries, later the first half's context partials (N H), the
// second half's (N H), scores (N Tc), max and sum (2 N).
//
// Training (N = 1, a cluster per row) runs two more modes of the same
// body.  ATTN_TRAIN also writes the softmax weights, alphas (B N, T).
// ATTN_BWD is the backward: q holds d_cv, the "scores" are d_alphas[t] =
// enc[b, t] . d_cv, their inner product with alphas is summed over the
// cluster where the forward takes the max, d_scores = alphas (d_alphas -
// inner) is stored and takes the place of the softmax numerators, and cv
// gets d_q = d_scores @ enc[b], not normalised.
struct Attn {
  const void* enc;   // (B, T, H), float or (eval) __nv_bfloat16
  const float* q;    // (B N, H)
  float* cv;         // (B N, H)
  int N, T, H;
  const int* done;
};

enum { ATTN_EVAL = 0, ATTN_TRAIN = 1, ATTN_BWD = 2 };

// Training's streams (B N, T): alphas, read by ATTN_BWD; and t_out,
// ATTN_TRAIN's alphas or ATTN_BWD's d_scores.
struct AttnAux {
  const float* alphas;
  float* t_out;
};

// W: the encoder states' element type; at bf16 (eval only) the
// normalised softmax weights are rounded to bf16 before the context sum,
// which then needs no division.
template <int MODE, typename W>
__device__ __forceinline__ void attention_body(const Attn& a,
                                               const AttnAux& x) {
  constexpr bool ROUND = IS_BF16<W>;
  grid_dep_wait();
  if (a.done && *a.done) return;
  grid_dep_launch();
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  const int N = a.N, H = a.H, H4 = H / 4;
  const int tcf = (a.T + cs - 1) / cs;
  const int t0 = rank * tcf;
  const int tc = max(0, min(a.T - t0, tcf));
  extern __shared__ float4 sm4[];
  float4* qs = sm4;                       // (N, H / 4); then partials 0
  float4* pc1 = qs + N * H4;              // partials 1
  float* S = reinterpret_cast<float*>(pc1 + N * H4);  // (N, tcf)
  float* mx = S + N * tcf;
  float* sm = mx + N;
  const W* E4 = static_cast<const W*>(a.enc) + ((long)b * a.T + t0) * H;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  constexpr int NW = THREADS / 32;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  const float4* q4 = reinterpret_cast<const float4*>(a.q) + (long)b * N * H4;
  for (int i = tid; i < N * H4; i += THREADS) qs[i] = q4[i];
  __syncthreads();
  // scores: a warp per TU encoder rows, NQ queries per pass over them
  for (int tb = w * TU; tb < tc; tb += NW * TU) {
    for (int g = 0; g < N; g += NQ) {
      float acc[TU][NQ];
#pragma unroll
      for (int u = 0; u < TU; ++u)
#pragma unroll
        for (int n = 0; n < NQ; ++n) acc[u][n] = 0.f;
#pragma unroll 4
      for (int h = lane; h < H4; h += 32) {
        float4 ev[TU];
#pragma unroll
        for (int u = 0; u < TU; ++u)
          ev[u] = tb + u < tc ? ldg4(E4, (long)(tb + u) * H4 + h) : zero;
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          if (g + n < N) {
            const float4 qv = qs[(g + n) * H4 + h];
#pragma unroll
            for (int u = 0; u < TU; ++u) {
              acc[u][n] = fmaf(ev[u].x, qv.x, acc[u][n]);
              acc[u][n] = fmaf(ev[u].y, qv.y, acc[u][n]);
              acc[u][n] = fmaf(ev[u].z, qv.z, acc[u][n]);
              acc[u][n] = fmaf(ev[u].w, qv.w, acc[u][n]);
            }
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        if (g + n >= N) break;
#pragma unroll
        for (int u = 0; u < TU; ++u) {
          const float v = warp_sum(acc[u][n]);
          if (lane == 0 && tb + u < tc) S[(g + n) * tcf + tb + u] = v;
        }
      }
    }
  }
  __syncthreads();
  if constexpr (MODE == ATTN_BWD) {
    for (int n = w; n < N; n += NW) {
      const float* al = x.alphas + ((long)b * N + n) * a.T + t0;
      float p = 0.f;
      for (int t = lane; t < tc; t += 32) p = fmaf(S[n * tcf + t], al[t], p);
      p = warp_sum(p);
      if (lane == 0) mx[n] = p;
    }
    cluster.sync();
    for (int n = w; n < N; n += NW) {
      float inner = 0.f;
      for (int s = 0; s < cs; ++s)
        inner += *cluster.map_shared_rank(mx + n, s);
      const float* al = x.alphas + ((long)b * N + n) * a.T + t0;
      float* ds = x.t_out + ((long)b * N + n) * a.T + t0;
      for (int t = lane; t < tc; t += 32) {
        const float v = al[t] * (S[n * tcf + t] - inner);
        S[n * tcf + t] = v;
        ds[t] = v;
      }
    }
  } else {
    for (int n = w; n < N; n += NW) {
      float m = -INFINITY;
      for (int t = lane; t < tc; t += 32) m = fmaxf(m, S[n * tcf + t]);
      m = warp_max(m);
      if (lane == 0) mx[n] = m;
    }
    cluster.sync();
    for (int n = w; n < N; n += NW) {
      float m = -INFINITY;
      for (int s = 0; s < cs; ++s)
        m = fmaxf(m, *cluster.map_shared_rank(mx + n, s));
      float sum = 0.f;
      for (int t = lane; t < tc; t += 32) {
        const float e = expf(S[n * tcf + t] - m);
        S[n * tcf + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) sm[n] = sum;
    }
    if constexpr (ROUND) {
      cluster.sync();
      for (int n = w; n < N; n += NW) {
        float z = 0.f;
        for (int s = 0; s < cs; ++s) z += *cluster.map_shared_rank(sm + n, s);
        for (int t = lane; t < tc; t += 32)
          S[n * tcf + t] = bf16_round(S[n * tcf + t] / z);
      }
    }
  }
  __syncthreads();
  // unnormalised context partials: the two halves of the block take
  // alternate encoder rows; the queries' memory holds the first half's
  const int half = tid / (THREADS / 2);
  float4* part = half ? pc1 : qs;
  for (int g = 0; g < N; g += NQ) {
    for (int h = tid % (THREADS / 2); h < H4; h += THREADS / 2) {
      float4 acc[NQ];
#pragma unroll
      for (int n = 0; n < NQ; ++n) acc[n] = zero;
      for (int t = half; t < tc; t += 2 * TC) {
        float4 ev[TC];
#pragma unroll
        for (int u = 0; u < TC; ++u)
          ev[u] = t + 2 * u < tc ? ldg4(E4, (long)(t + 2 * u) * H4 + h)
                                 : zero;
#pragma unroll
        for (int u = 0; u < TC; ++u) {
          if (t + 2 * u >= tc) break;
#pragma unroll
          for (int n = 0; n < NQ; ++n) {
            if (g + n < N) {
              const float p = S[(g + n) * tcf + t + 2 * u];
              acc[n].x = fmaf(p, ev[u].x, acc[n].x);
              acc[n].y = fmaf(p, ev[u].y, acc[n].y);
              acc[n].z = fmaf(p, ev[u].z, acc[n].z);
              acc[n].w = fmaf(p, ev[u].w, acc[n].w);
            }
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n)
        if (g + n < N) part[(g + n) * H4 + h] = acc[n];
    }
  }
  cluster.sync();
  // block c finishes columns [c Hc, (c+1) Hc) of every row
  const int hc = (H + cs - 1) / cs;
  for (int i = tid; i < N * hc; i += THREADS) {
    const int n = i / hc, h = rank * hc + i % hc;
    if (h >= H) continue;
    float z = 0.f, v = 0.f;
    for (int s = 0; s < cs; ++s) {
      if constexpr (MODE != ATTN_BWD && !ROUND)
        z += *cluster.map_shared_rank(sm + n, s);
      const float* p0 = reinterpret_cast<const float*>(
          cluster.map_shared_rank(qs, s));
      const float* p1 = reinterpret_cast<const float*>(
          cluster.map_shared_rank(pc1, s));
      v += p0[n * H + h] + p1[n * H + h];
    }
    if constexpr (MODE != ATTN_BWD && !ROUND) v *= 1.f / z;
    a.cv[((long)b * N + n) * H + h] = v;
  }
  if constexpr (MODE == ATTN_TRAIN) {
    // this block's part of the normalised weights
    for (int i = tid; i < N * tc; i += THREADS) {
      const int n = i / tc, t = i % tc;
      float z = 0.f;
      for (int s = 0; s < cs; ++s) z += *cluster.map_shared_rank(sm + n, s);
      x.t_out[((long)b * N + n) * a.T + t0 + t] = S[n * tcf + t] * (1.f / z);
    }
  }
  cluster.sync();
}

// One block an SM (every block asks for EXCLUSIVE_SMEM): registers up to
// 255 a thread, so the scores' and context's loads in flight do not spill.
template <typename W>
__global__ void __launch_bounds__(THREADS, 1) attention_kernel(Attn a) {
  attention_body<ATTN_EVAL, W>(a, AttnAux{});
}

__global__ void __launch_bounds__(THREADS, 1)
    attention_train_kernel(Attn a, AttnAux x) {
  attention_body<ATTN_TRAIN, float>(a, x);
}

__global__ void __launch_bounds__(THREADS, 1)
    attention_bwd_kernel(Attn a, AttnAux x) {
  attention_body<ATTN_BWD, float>(a, x);
}

// The launch state below is shared by every host thread of the process
// (a server decodes several batches at once, and ctypes calls run without
// Python's lock): the cluster sizes chosen so far, each device's SM count
// and each kernel's shared-memory opt-in.  g_mu guards all of it.
std::mutex g_mu;
constexpr int MAX_DEVICES = 64;

// The SMs of device `dev`; g_mu held.
int sm_count(int dev) {
  static int sms[MAX_DEVICES] = {};
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// A cluster size chosen for a launch shape on a device, kept for the next
// launch of the same shape and for ast_cluster_choices.  kind: a product's
// PROD_* mode (a wave's + 3), or 4 + the attention's ATTN_* mode; rows: a
// product block's rows (0 for attention).
struct ClusterChoice {
  const void* k;
  size_t smem;
  int blocks, limit, cs, kind, rows, dev;
};
constexpr int MAX_CHOICES = 1024;
ClusterChoice g_choices[MAX_CHOICES];
int g_n_choices = 0;

// The largest cluster, up to MAX_CLUSTER blocks and `limit`, of which
// `blocks` clusters run at once, one block per SM (the shared memory a
// block asks for is at least EXCLUSIVE_SMEM), so that no SM runs two
// blocks of a launch while another idles: at 4 blocks a cluster only 30
// clusters fit the H100's GPCs, so 32 column slices take clusters of 3.
// Cached per (kernel, shared memory, blocks, limit, device); g_mu held.
template <typename Kernel>
int cluster_size(Kernel kernel, size_t smem, int blocks, int limit, int kind,
                 int rows, int dev) {
  for (int i = 0; i < g_n_choices; ++i) {
    const ClusterChoice& e = g_choices[i];
    if (e.k == (const void*)kernel && e.smem == smem && e.blocks == blocks &&
        e.limit == limit && e.dev == dev)
      return e.cs;
  }
  int cs = min(MAX_CLUSTER, max(1, limit));
  for (; cs > 1; --cs) {
    if (blocks * cs > sm_count(dev)) continue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks * cs);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = cs;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    int fit = 0;
    if (cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg) == cudaSuccess &&
        fit >= blocks)
      break;
  }
  cudaGetLastError();  // a refused query leaves no error behind
  if (g_n_choices < MAX_CHOICES)
    g_choices[g_n_choices++] = ClusterChoice{
        (const void*)kernel, smem, blocks, limit, cs, kind, rows, dev};
  return cs;
}

// kernel<<<(slices * cs, grid_y), THREADS, bytes>>>(args...) as a
// programmatic dependent launch in clusters of cs blocks along x, cs
// chosen by cluster_size for slices * grid_y clusters, on the calling
// thread's current device.  opted[dev]: the dynamic shared memory this
// kernel has been opted in for on device dev (an attribute of a device's
// copy of the function).
template <typename... KArgs, typename... Args>
cudaError_t launch_clustered(void (*kernel)(KArgs...), size_t* opted,
                             int kind, int rows, size_t bytes, int slices,
                             int grid_y, int limit, cudaStream_t s,
                             const Args&... args) {
  int dev = 0;
  STEP_RETURN_IF_ERR(cudaGetDevice(&dev));
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int cs;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (bytes > opted[dev]) {
      STEP_RETURN_IF_ERR(cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
      opted[dev] = bytes;
    }
    cs = cluster_size(kernel, bytes, slices * grid_y, limit, kind, rows, dev);
  }
  return launch_ex(kernel, dim3(slices * cs, grid_y), dim3(THREADS), bytes,
                   cs, s, args...);
}

// extra: the CellTrainOut of a PROD_CELL_TRAIN launch, the BwdEpilogue of
// a PROD_BWD one, else nothing.
template <int TR, int RGN, int MODE, typename W, typename... Extra>
cudaError_t launch_prod_tile(const Prod& a, int col_blocks, cudaStream_t s,
                             const Extra&... extra) {
  using S = ProdShape<TR, RGN, W>;
  static size_t opted[MAX_DEVICES] = {};  // of this (tile, mode, W)'s kernel
  int ktot = 0;
  for (int i = 0; i < a.nseg; ++i) ktot += a.seg[i].K;
  const int row_chunks = (a.R + S::RB - 1) / S::RB;
  if constexpr (MODE == PROD_CELL_TRAIN)
    return launch_clustered(prod_train_kernel<TR, RGN>, opted, MODE, S::RB,
                            S::BYTES, col_blocks, row_chunks, ktot / KT, s, a,
                            extra...);
  else if constexpr (MODE == PROD_BWD)
    return launch_clustered(prod_bwd_kernel<TR, RGN>, opted, MODE, S::RB,
                            S::BYTES, col_blocks, row_chunks, ktot / KT, s, a,
                            extra...);
  else
    return launch_clustered(prod_kernel<TR, RGN, MODE == PROD_CELL, W>,
                            opted, MODE, S::RB, S::BYTES, col_blocks,
                            row_chunks, ktot / KT, s, a);
}

// Rows per thread and row groups by R: all rows in one block up to 256,
// the input quads of a tile split over KGN = 16 / RGN thread groups.
template <int MODE, typename W = float, typename... Extra>
cudaError_t launch_prod(const Prod& a, cudaStream_t s,
                        const Extra&... extra) {
  const int cols = MODE == PROD_CELL || MODE == PROD_CELL_TRAIN
                       ? a.N / UNITS
                       : (a.N + NC - 1) / NC;
  const int R = a.R;
  if (R <= 16) return launch_prod_tile<4, 4, MODE, W>(a, cols, s, extra...);
  if (R <= 32) return launch_prod_tile<8, 4, MODE, W>(a, cols, s, extra...);
  if (R <= 64) return launch_prod_tile<8, 8, MODE, W>(a, cols, s, extra...);
  if (R <= 128)
    return launch_prod_tile<8, 16, MODE, W>(a, cols, s, extra...);
  if (R <= 160)
    return launch_prod_tile<10, 16, MODE, W>(a, cols, s, extra...);
  return launch_prod_tile<16, 16, MODE, W>(a, cols, s, extra...);
}

// A wave in mode MODE at the row tiling <TR, RGN>: `cols` column blocks
// over all its products, whose shortest input axis has `tiles` tiles.
template <int TR, int RGN, int MODE, typename W, typename Extra>
cudaError_t launch_wave_tile(const Wave<Extra>& w, int cols, int tiles,
                             cudaStream_t s) {
  using S = ProdShape<TR, RGN, W>;
  static size_t opted[MAX_DEVICES] = {};  // of this (tile, mode, W)'s kernel
  const int row_chunks = (w.p[0].R + S::RB - 1) / S::RB;
  return launch_clustered(wave_kernel<TR, RGN, MODE, Extra, W>, opted,
                          MODE + 3, S::RB, S::BYTES, cols, row_chunks, tiles,
                          s, w);
}

// The wave's column blocks counted into cb_end, then launch_prod's row
// tilings.
template <int MODE, typename W = float, typename Extra>
cudaError_t launch_wave(Wave<Extra>& w, cudaStream_t s) {
  int cols = 0, tiles = 1 << 30;
  for (int g = 0; g < w.n; ++g) {
    const Prod& a = w.p[g];
    cols += MODE == PROD_WAVE_LINEAR ? (a.N + NC - 1) / NC : a.N / UNITS;
    w.cb_end[g] = cols;
    int ktot = 0;
    for (int i = 0; i < a.nseg; ++i) ktot += a.seg[i].K;
    tiles = min(tiles, ktot / KT);
  }
  const int R = w.p[0].R;
  if (R <= 16) return launch_wave_tile<4, 4, MODE, W>(w, cols, tiles, s);
  if (R <= 32) return launch_wave_tile<8, 4, MODE, W>(w, cols, tiles, s);
  if (R <= 64) return launch_wave_tile<8, 8, MODE, W>(w, cols, tiles, s);
  if (R <= 128) return launch_wave_tile<8, 16, MODE, W>(w, cols, tiles, s);
  if (R <= 160) return launch_wave_tile<10, 16, MODE, W>(w, cols, tiles, s);
  return launch_wave_tile<16, 16, MODE, W>(w, cols, tiles, s);
}

// Attention for B utterances of N rows each, in mode MODE over encoder
// states of W; extra: the AttnAux of the training modes.  Shared memory
// for one block per utterance, the most any cluster size needs.
template <int MODE, typename W, typename... KArgs, typename... Extra>
cudaError_t launch_attention_mode(void (*kernel)(KArgs...), const Attn& a,
                                  int B, cudaStream_t s,
                                  const Extra&... extra) {
  // of this (mode, W)'s one kernel: the two eval kernels share a
  // signature, so W keeps their opt-ins apart
  static size_t opted[MAX_DEVICES] = {};
  size_t bytes =
      ((size_t)2 * a.N * a.H + (size_t)a.N * a.T + 2 * a.N) * sizeof(float);
  if (bytes < EXCLUSIVE_SMEM) bytes = EXCLUSIVE_SMEM;
  return launch_clustered(kernel, opted, 4 + MODE, 0, bytes, B, 1, a.T, s,
                          a, extra...);
}

}  // namespace

template <typename W>
cudaError_t decode_step(const StepWeightsT<W>& w, const W* enc, int T,
                        int rows_per_utt, const DecoderStep& st, int R,
                        const int* done, cudaStream_t s) {
  const int H = w.H;
  const long H4 = 4L * H, RH = (long)R * H;
  const W* cell_w = w.cell;
  for (int l = 0; l < w.L; ++l) {
    // inputs [emb | ht_prev | h_prev] (layer 0) or [h_below | h_prev];
    // the previous step's state at the parent row
    Prod a = {};
    const Seg hp = Seg{st.h_in + l * RH, st.parent, H};
    if (l == 0) {
      a.seg[0] = Seg{w.embed, st.tok, w.E};
      a.seg[1] = Seg{st.ht_in, st.parent, w.A};
      a.seg[2] = hp;
      a.nseg = 3;
    } else {
      a.seg[0] = Seg{st.h_out + (l - 1) * RH, nullptr, H};
      a.seg[1] = hp;
      a.nseg = 2;
    }
    a.w = cell_w;
    cell_w += (l == 0 ? w.E + w.A + H : 2 * H) * H4;
    a.bias = w.bias + l * H4;
    a.R = R;
    a.N = H;
    a.out = st.h_out + l * RH;
    a.c_in = st.c_in + l * RH;
    a.c_idx = st.parent;
    a.c_out = st.c_out + l * RH;
    a.done = done;
    STEP_RETURN_IF_ERR((launch_prod<PROD_CELL, W>(a, s)));
  }
  const float* top = st.h_out + (w.L - 1) * RH;

  Prod q = {};
  q.seg[0] = Seg{top, nullptr, H};
  q.nseg = 1;
  q.w = w.wa;
  q.bias = w.wa_b;
  q.R = R;
  q.N = H;
  q.out = st.q;
  q.done = done;
  STEP_RETURN_IF_ERR((launch_prod<PROD_LINEAR, W>(q, s)));

  const int N = rows_per_utt;
  STEP_RETURN_IF_ERR((launch_attention_mode<ATTN_EVAL, W>(
      attention_kernel<W>, Attn{enc, st.q, st.cv, N, T, H, done}, R / N,
      s)));

  Prod c = {};
  c.seg[0] = Seg{st.cv, nullptr, H};
  c.seg[1] = Seg{top, nullptr, H};
  c.nseg = 2;
  c.w = w.ctx_w;
  c.bias = w.ctx_b;
  c.R = R;
  c.N = w.A;
  c.act_tanh = 1;
  c.out = st.ht_out;
  c.done = done;
  STEP_RETURN_IF_ERR((launch_prod<PROD_LINEAR, W>(c, s)));

  Prod o = {};
  o.seg[0] = Seg{st.ht_out, nullptr, w.A};
  o.nseg = 1;
  o.w = w.out_w;
  o.bias = w.out_b;
  o.R = R;
  o.N = w.V;
  o.out = st.logits;
  o.done = done;
  return launch_prod<PROD_LINEAR, W>(o, s);
}

template cudaError_t decode_step<float>(const StepWeightsT<float>&,
                                        const float*, int, int,
                                        const DecoderStep&, int, const int*,
                                        cudaStream_t);
template cudaError_t decode_step<__nv_bfloat16>(
    const StepWeightsT<__nv_bfloat16>&, const __nv_bfloat16*, int, int,
    const DecoderStep&, int, const int*, cudaStream_t);

cudaError_t launch_linear_prod(const Prod& a, cudaStream_t s) {
  return launch_prod<PROD_LINEAR>(a, s);
}

cudaError_t launch_cell_train_prod(const Prod& a, const CellTrainOut& tr,
                                   cudaStream_t s) {
  return launch_prod<PROD_CELL_TRAIN, float>(a, s, tr);
}

cudaError_t launch_bwd_prod(const Prod& a, const BwdEpilogue& e,
                            cudaStream_t s) {
  return launch_prod<PROD_BWD, float>(a, s, e);
}

cudaError_t launch_cell_wave(Wave<EncCell>& w, bool train, cudaStream_t s) {
  return train ? launch_wave<PROD_WAVE_CELL_TRAIN>(w, s)
               : launch_wave<PROD_WAVE_CELL>(w, s);
}

cudaError_t launch_cell_wave_bf16(Wave<EncCell>& w, cudaStream_t s) {
  return launch_wave<PROD_WAVE_CELL, __nv_bfloat16>(w, s);
}

cudaError_t launch_linear_wave(Wave<NoExtra>& w, cudaStream_t s) {
  return launch_wave<PROD_WAVE_LINEAR>(w, s);
}

cudaError_t launch_attention_train(const float* enc, const float* q,
                                   float* cv, float* alphas, int R, int T,
                                   int H, cudaStream_t s) {
  return launch_attention_mode<ATTN_TRAIN, float>(
      attention_train_kernel, Attn{enc, q, cv, 1, T, H, nullptr}, R, s,
      AttnAux{nullptr, alphas});
}

cudaError_t launch_attention_bwd(const float* enc, const float* alphas,
                                 const float* d_cv, float* d_scores,
                                 float* d_q, int R, int T, int H,
                                 cudaStream_t s) {
  return launch_attention_mode<ATTN_BWD, float>(
      attention_bwd_kernel, Attn{enc, d_cv, d_q, 1, T, H, nullptr}, R, s,
      AttnAux{alphas, d_scores});
}

}  // namespace ast

// The cluster sizes chosen so far in this process, one record of 7 ints a
// launch shape: kind (0 linear product, 1 cell, 2 train cell, 3 backward
// product, 4 attention, 5 train attention, 6 attention backward, 7 a wave
// of encoder cells, 8 of train-mode encoder cells, 9 of linear products),
// a product block's rows, the
// clusters of a launch, the input tiles (attention: T'), the shared
// memory in KB, the cluster size, and clusters * size (the SMs a launch
// fills).  Writes up to `cap` records to out; returns how many exist.
AST_EXPORT int ast_cluster_choices(int* out, int cap) {
  std::lock_guard<std::mutex> lock(ast::g_mu);
  const int n = ast::g_n_choices;
  for (int i = 0; i < n && i < cap; ++i) {
    const ast::ClusterChoice& e = ast::g_choices[i];
    const int rec[7] = {e.kind,   e.rows, e.blocks, e.limit, (int)(e.smem >> 10),
                        e.cs,     e.blocks * e.cs};
    for (int j = 0; j < 7; ++j) out[i * 7 + j] = rec[j];
  }
  return n;
}
