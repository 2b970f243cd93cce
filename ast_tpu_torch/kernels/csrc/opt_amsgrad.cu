// The training step's optimizer on the card: the chain of
// ast_tpu_torch/train/optimizer.py (L2 added to the gradient -> global-
// norm clip -> annealed gradient noise -> AMSGrad as optax's
// scale_by_amsgrad, or nothing (SGD) -> times -lr) and the in-place add of
// the update to the parameters, over every trainable leaf in two launches.
//
// It replaces no Pallas kernel: ast_tpu's Adam step is plain XLA.  The
// port's chain on lists of tensors (torch._foreach_*) makes some 17 passes
// over the leaves and 30-45 launches a step, and what it costs is the
// host's time to issue them.  The work itself is bound by bytes: launch 1
// reads g and p (8 bytes an element), launch 2 reads g, p, mu, nu and
// nu_max and writes p, mu, nu and nu_max (36 bytes an element with f32
// moments): about 0.54 GB a step at es_en_20h's 12.33 M parameters, each
// byte moved once a launch.
//
// Launch 1 (norm_kernel) sums the squares of g' = g + l2 p, the clip
// norm's input, into one partial per block and class (replicated leaves,
// vocab shards) on a fixed grid of OPT_BLOCKS blocks, each walking fixed
// chunks of the leaves in a fixed order.  There are no float atomics, so
// the sums repeat bit for bit from run to run and on every rank of a data
// axis, whose parameters stay identical.  Its first thread also advances
// the AMSGrad and noise counts in place; launch 2 reads them in stream
// order.
//
// Launch 2 (update_kernel): each block reduces the partials in one fixed
// order to the global norm (or reads it from norm_in: under a model axis
// the host sums the vocab shards' squares over the model group between
// the launches), then updates each element in float32 in the chain's
// order of operations, every rounding explicit (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn) so that no FMA contraction changes one:
//   g' = (g + p l2) scale, + sigma z with the noise z;
//   mu = g' (1 - b1) + mu b1   (at bf16 moments: mu b1 in f32 with b1
//        rounded to bf16, rounded to bf16, and mu stored rounded);
//   nu = (g' g') (1 - b2) + nu b2;  nu_max = max(nu_max, nu / bc2);
//   p += ((mu / bc1) / (sqrt(nu_max) + eps)) (-lr)   (SGD: p += g' (-lr)).
// Given the same norm an element equals the foreach chain's bit for bit.
//
// The links (L2, clip, noise) are runtime flags, uniform over the grid:
// branches on them cost nothing in a pass bound by bytes.  Only the mode
// (SGD, AMSGrad, AMSGrad with bf16 mu), which changes mu's storage type,
// is a template parameter.
//
// The leaves (at most OPT_MAX_LEAVES a launch, more in several) travel by
// value in the kernel's parameters; a leaf whose pointers are all 16-byte
// aligned (8 for bf16 moments) is read in 16-byte vectors, with a scalar
// tail, any other one element by element.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int OPT_MAX_LEAVES = 48;
constexpr int OPT_BLOCKS = 528;           // fixed: the sums' order
constexpr int OPT_THREADS = 256;
constexpr int OPT_CHUNK = 4096;           // elements a block takes at once
constexpr int OPT_VEC_ITERS = OPT_CHUNK / (4 * OPT_THREADS);

// flags: the chain's links and the moments' dtype
constexpr int F_L2 = 1, F_CLIP = 2, F_NOISE = 4;
constexpr int MODE_SHIFT = 3;
enum Mode { SGD = 0, ADAM = 1, ADAM_MU_BF16 = 2 };

}  // namespace

// One trainable leaf as the host passes it (ctypes' OptLeafArgs): mu is
// float or __nv_bfloat16; mu, nu and nu_max are null under SGD, noise
// without gradient noise.
struct OptLeafArgs {
  float* p;
  const float* g;
  void* mu;
  float* nu;
  float* nu_max;
  const float* noise;
  long long n;
  int sharded;
  int pad_;
};

// The chain's float32 constants, each rounded from the host's double as
// torch rounds a Python scalar: b1_mu is b1 rounded to bf16 at bf16
// moments (else b1).
struct OptConsts {
  float l2, clip, b1, one_minus_b1, b1_mu, b2, one_minus_b2, eps, neg_lr;
};

namespace {

struct Leaf {
  float* p;
  const float* g;
  void* mu;
  float* nu;
  float* nu_max;
  const float* noise;
  long long n;
  long long chunk0;       // the leaf's first chunk in the launch
  int vec;
  int sharded;
};

struct Table {
  Leaf leaf[OPT_MAX_LEAVES];
  long long n_chunks;
  int n_leaves;
};

// The chunk's leaf, advancing ``leaf`` (a block's chunks only increase).
__device__ __forceinline__ const Leaf& leaf_of(const Table& t, long long c,
                                               int& leaf) {
  while (leaf + 1 < t.n_leaves && c >= t.leaf[leaf + 1].chunk0) ++leaf;
  return t.leaf[leaf];
}

__device__ __forceinline__ float add_l2(float g, float p, float l2) {
  return __fadd_rn(g, __fmul_rn(p, l2));
}

__global__ void __launch_bounds__(OPT_THREADS)
    norm_kernel(const __grid_constant__ Table t, float l2, int flags,
                float* partials, int n_partials, int* count,
                int* noise_count) {
  const bool with_l2 = flags & F_L2;
  float acc_rep = 0.f, acc_shard = 0.f;
  int leaf = 0;
  for (long long c = blockIdx.x; c < t.n_chunks; c += gridDim.x) {
    const Leaf& L = leaf_of(t, c, leaf);
    const float* __restrict__ g = L.g;
    const float* __restrict__ p = L.p;
    const long long start = (c - L.chunk0) * OPT_CHUNK;
    const long long end = min(L.n, start + OPT_CHUNK);
    float a = 0.f;
    long long i = start;
    if (L.vec) {
      const long long nv = (end - start) >> 2;
      if (nv == OPT_CHUNK / 4) {
        float4 gv[OPT_VEC_ITERS], pv[OPT_VEC_ITERS];
#pragma unroll
        for (int j = 0; j < OPT_VEC_ITERS; ++j) {
          const long long e = start + 4ll * (j * OPT_THREADS + threadIdx.x);
          gv[j] = *reinterpret_cast<const float4*>(g + e);
          if (with_l2) pv[j] = *reinterpret_cast<const float4*>(p + e);
        }
#pragma unroll
        for (int j = 0; j < OPT_VEC_ITERS; ++j) {
          float x0 = gv[j].x, x1 = gv[j].y, x2 = gv[j].z, x3 = gv[j].w;
          if (with_l2) {
            x0 = add_l2(x0, pv[j].x, l2);
            x1 = add_l2(x1, pv[j].y, l2);
            x2 = add_l2(x2, pv[j].z, l2);
            x3 = add_l2(x3, pv[j].w, l2);
          }
          a = fmaf(x0, x0, a);
          a = fmaf(x1, x1, a);
          a = fmaf(x2, x2, a);
          a = fmaf(x3, x3, a);
        }
      } else {
        for (long long v = threadIdx.x; v < nv; v += OPT_THREADS) {
          const long long e = start + 4 * v;
          float4 gv = *reinterpret_cast<const float4*>(g + e);
          if (with_l2) {
            const float4 pv = *reinterpret_cast<const float4*>(p + e);
            gv.x = add_l2(gv.x, pv.x, l2);
            gv.y = add_l2(gv.y, pv.y, l2);
            gv.z = add_l2(gv.z, pv.z, l2);
            gv.w = add_l2(gv.w, pv.w, l2);
          }
          a = fmaf(gv.x, gv.x, a);
          a = fmaf(gv.y, gv.y, a);
          a = fmaf(gv.z, gv.z, a);
          a = fmaf(gv.w, gv.w, a);
        }
      }
      i = start + 4 * nv;
    }
    for (i += threadIdx.x; i < end; i += OPT_THREADS) {
      float x = g[i];
      if (with_l2) x = add_l2(x, p[i], l2);
      a = fmaf(x, x, a);
    }
    if (L.sharded)
      acc_shard += a;
    else
      acc_rep += a;
  }
  // the block's sums in a fixed tree: each warp's, then warp 0 over them
  __shared__ float part[2][OPT_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < 2; ++k) {
    const float s = ast::warp_sum(k == 0 ? acc_rep : acc_shard);
    if (lane == 0) part[k][warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    for (int k = 0; k < 2; ++k) {
      float s = lane < OPT_THREADS / 32 ? part[k][lane] : 0.f;
      s = ast::warp_sum(s);
      if (lane == 0 && partials != nullptr)
        partials[k * n_partials + blockIdx.x] = s;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (count != nullptr) *count += 1;
    if (noise_count != nullptr) *noise_count += 1;
  }
}

struct Step {
  float scale, sigma, bc1, bc2;
};

// One element through the chain.  mu arrives widened (at bf16 moments
// the stored value) and leaves unrounded; the caller stores it.
template <int MODE>
__device__ __forceinline__ void update_one(float& p, float g, float& mu,
                                           float& nu, float& vmax, float z,
                                           int flags, const OptConsts& k,
                                           const Step& s) {
  if (flags & F_L2) g = add_l2(g, p, k.l2);
  if (flags & F_CLIP) g = __fmul_rn(g, s.scale);
  // torch's _foreach_add(g, noise, alpha=sigma): one rounding
  if (flags & F_NOISE) g = __fmaf_rn(s.sigma, z, g);
  float u;
  if (MODE == SGD) {
    u = g;
  } else {
    float old;
    if (MODE == ADAM_MU_BF16)
      old = __bfloat162float(__float2bfloat16_rn(__fmul_rn(mu, k.b1_mu)));
    else
      old = __fmul_rn(mu, k.b1);
    mu = __fadd_rn(__fmul_rn(g, k.one_minus_b1), old);
    nu = __fadd_rn(__fmul_rn(__fmul_rn(g, g), k.one_minus_b2),
                   __fmul_rn(nu, k.b2));
    const float r = __fdiv_rn(nu, s.bc2);
    // torch.maximum: NaN wins
    vmax = (vmax != vmax || r != r) ? __int_as_float(0x7fffffff)
                                    : fmaxf(vmax, r);
    u = __fdiv_rn(__fdiv_rn(mu, s.bc1), __fadd_rn(__fsqrt_rn(vmax), k.eps));
  }
  p = __fadd_rn(p, __fmul_rn(u, k.neg_lr));
}

template <int MODE>
struct MuIO;

template <>
struct MuIO<ADAM> {
  static __device__ __forceinline__ float4 load4(const void* mu,
                                                 long long e) {
    return *reinterpret_cast<const float4*>(
        static_cast<const float*>(mu) + e);
  }
  static __device__ __forceinline__ void store4(void* mu, long long e,
                                                float4 v) {
    *reinterpret_cast<float4*>(static_cast<float*>(mu) + e) = v;
  }
  static __device__ __forceinline__ float load(const void* mu, long long e) {
    return static_cast<const float*>(mu)[e];
  }
  static __device__ __forceinline__ void store(void* mu, long long e,
                                               float v) {
    static_cast<float*>(mu)[e] = v;
  }
};

template <>
struct MuIO<ADAM_MU_BF16> {
  static __device__ __forceinline__ float4 load4(const void* mu,
                                                 long long e) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(mu) + e);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                       __high2float(hi));
  }
  static __device__ __forceinline__ void store4(void* mu, long long e,
                                                float4 v) {
    uint2 raw;
    *reinterpret_cast<__nv_bfloat162*>(&raw.x) =
        __halves2bfloat162(__float2bfloat16_rn(v.x), __float2bfloat16_rn(v.y));
    *reinterpret_cast<__nv_bfloat162*>(&raw.y) =
        __halves2bfloat162(__float2bfloat16_rn(v.z), __float2bfloat16_rn(v.w));
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(mu) + e) = raw;
  }
  static __device__ __forceinline__ float load(const void* mu, long long e) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(mu)[e]);
  }
  static __device__ __forceinline__ void store(void* mu, long long e,
                                               float v) {
    static_cast<__nv_bfloat16*>(mu)[e] = __float2bfloat16_rn(v);
  }
};

template <>
struct MuIO<SGD> {
  static __device__ __forceinline__ float4 load4(const void*, long long) {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void store4(void*, long long, float4) {}
  static __device__ __forceinline__ float load(const void*, long long) {
    return 0.f;
  }
  static __device__ __forceinline__ void store(void*, long long, float) {}
};

template <int MODE>
__global__ void __launch_bounds__(OPT_THREADS)
    update_kernel(const __grid_constant__ Table t,
                  const __grid_constant__ OptConsts k, float sigma,
                  int flags, const float* partials, int n_partials,
                  const float* norm_in, float* norm_out, const int* count) {
  constexpr bool ADAMW = MODE != SGD;
  const bool noise = flags & F_NOISE;
  __shared__ Step s_step;
  if (threadIdx.x < 32) {
    float scale = 1.f;
    if (flags & F_CLIP) {
      float norm;
      if (norm_in != nullptr) {
        norm = *norm_in;
      } else {
        float a = 0.f, b = 0.f;
        for (int i = threadIdx.x; i < n_partials; i += 32) {
          a += partials[i];
          b += partials[n_partials + i];
        }
        norm = __fsqrt_rn(__fadd_rn(ast::warp_sum(a), ast::warp_sum(b)));
      }
      // where(norm < clip, 1, reciprocal(norm) * clip), as torch
      // evaluates the chain's ``clip / norm``
      scale = norm < k.clip ? 1.f : __fmul_rn(__fdiv_rn(1.f, norm), k.clip);
      if (norm_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
        *norm_out = norm;
    }
    if (threadIdx.x == 0) {
      Step st = {scale, sigma, 1.f, 1.f};
      if (ADAMW) {
        const float n = static_cast<float>(*count);
        st.bc1 = __fsub_rn(1.f, powf(k.b1, n));
        st.bc2 = __fsub_rn(1.f, powf(k.b2, n));
      }
      s_step = st;
    }
  }
  __syncthreads();
  const Step s = s_step;
  int leaf = 0;
  for (long long c = blockIdx.x; c < t.n_chunks; c += gridDim.x) {
    const Leaf& L = leaf_of(t, c, leaf);
    float* __restrict__ p = L.p;
    const float* __restrict__ g = L.g;
    void* mu = L.mu;
    float* __restrict__ nu = L.nu;
    float* __restrict__ vm = L.nu_max;
    const float* __restrict__ z = L.noise;
    const long long start = (c - L.chunk0) * OPT_CHUNK;
    const long long end = min(L.n, start + OPT_CHUNK);
    long long i = start;
    if (L.vec) {
      const long long nv = (end - start) >> 2;
      for (long long v = threadIdx.x; v < nv; v += OPT_THREADS) {
        const long long e = start + 4 * v;
        float4 pv = *reinterpret_cast<const float4*>(p + e);
        const float4 gv = *reinterpret_cast<const float4*>(g + e);
        float4 mv = MuIO<MODE>::load4(mu, e);
        float4 nv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv = nv4;
        if (ADAMW) {
          nv4 = *reinterpret_cast<const float4*>(nu + e);
          vv = *reinterpret_cast<const float4*>(vm + e);
        }
        float4 zv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (noise) zv = *reinterpret_cast<const float4*>(z + e);
        update_one<MODE>(pv.x, gv.x, mv.x, nv4.x, vv.x, zv.x, flags, k,
                         s);
        update_one<MODE>(pv.y, gv.y, mv.y, nv4.y, vv.y, zv.y, flags, k,
                         s);
        update_one<MODE>(pv.z, gv.z, mv.z, nv4.z, vv.z, zv.z, flags, k,
                         s);
        update_one<MODE>(pv.w, gv.w, mv.w, nv4.w, vv.w, zv.w, flags, k,
                         s);
        *reinterpret_cast<float4*>(p + e) = pv;
        if (ADAMW) {
          MuIO<MODE>::store4(mu, e, mv);
          *reinterpret_cast<float4*>(nu + e) = nv4;
          *reinterpret_cast<float4*>(vm + e) = vv;
        }
      }
      i = start + 4 * nv;
    }
    for (i += threadIdx.x; i < end; i += OPT_THREADS) {
      float pi = p[i], mi = MuIO<MODE>::load(mu, i), ni = 0.f, vi = 0.f;
      if (ADAMW) {
        ni = nu[i];
        vi = vm[i];
      }
      update_one<MODE>(pi, g[i], mi, ni, vi, noise ? z[i] : 0.f, flags, k,
                       s);
      p[i] = pi;
      if (ADAMW) {
        MuIO<MODE>::store(mu, i, mi);
        nu[i] = ni;
        vm[i] = vi;
      }
    }
  }
}

bool aligned(const void* ptr, unsigned bytes) {
  return ptr == nullptr || reinterpret_cast<unsigned long long>(ptr) %
                               bytes == 0;
}

// The launch table of leaves [first, first + n): chunks numbered from 0.
Table make_table(const OptLeafArgs* leaves, int first, int n, int mode) {
  Table t = {};
  long long chunks = 0;
  for (int j = 0; j < n; ++j) {
    const OptLeafArgs& a = leaves[first + j];
    Leaf& L = t.leaf[j];
    L.p = a.p;
    L.g = a.g;
    L.mu = a.mu;
    L.nu = a.nu;
    L.nu_max = a.nu_max;
    L.noise = a.noise;
    L.n = a.n;
    L.chunk0 = chunks;
    L.sharded = a.sharded != 0;
    L.vec = aligned(a.p, 16) && aligned(a.g, 16) && aligned(a.nu, 16) &&
            aligned(a.nu_max, 16) && aligned(a.noise, 16) &&
            aligned(a.mu, mode == ADAM_MU_BF16 ? 8 : 16);
    chunks += (a.n + OPT_CHUNK - 1) / OPT_CHUNK;
  }
  t.n_chunks = chunks;
  t.n_leaves = n;
  return t;
}

int n_groups(int n_leaves) {
  return (n_leaves + OPT_MAX_LEAVES - 1) / OPT_MAX_LEAVES;
}

}  // namespace

// The rows of the partials buffer a tree of n_leaves takes: the buffer
// is float32 (2, opt_partials(n_leaves)), row 0 the replicated leaves'
// squares by block, row 1 the vocab shards'.
AST_EXPORT int opt_partials(int n_leaves) {
  return n_groups(n_leaves) * OPT_BLOCKS;
}

// Launch 1: the partial sums of squares of g + l2 p (when flags has
// F_CLIP; else no element is read) and count += 1, noise_count += 1 on
// the counts given (either may be null).
AST_EXPORT int opt_amsgrad_norm(const OptLeafArgs* leaves, int n_leaves,
                                float l2, int flags, float* partials,
                                int* count, int* noise_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mode = flags >> MODE_SHIFT;
  const int n_partials = n_groups(n_leaves) * OPT_BLOCKS;
  if (!(flags & F_CLIP)) {
    const Table t = {};
    norm_kernel<<<1, OPT_THREADS, 0, s>>>(t, 0.f, 0, nullptr, 0, count,
                                          noise_count);
    return (int)cudaGetLastError();
  }
  for (int first = 0, grp = 0; first < n_leaves;
       first += OPT_MAX_LEAVES, ++grp) {
    const Table t = make_table(leaves, first,
                               std::min(OPT_MAX_LEAVES, n_leaves - first), mode);
    int* c = grp == 0 ? count : nullptr;
    int* nc = grp == 0 ? noise_count : nullptr;
    float* part = partials + grp * OPT_BLOCKS;
    norm_kernel<<<OPT_BLOCKS, OPT_THREADS, 0, s>>>(t, l2, flags, part,
                                                   n_partials, c, nc);
    AST_RETURN_IF_ERR(cudaGetLastError());
  }
  return 0;
}

// Launch 2: every element's update, in place.  count: the AMSGrad count
// launch 1 advanced (unread under SGD); norm_in: the global norm, else
// (null) the partials reduced; norm_out (may be null): the norm used.
AST_EXPORT int opt_amsgrad_update(const OptLeafArgs* leaves, int n_leaves,
                                  const OptConsts* k, float sigma, int flags,
                                  const float* partials,
                                  const float* norm_in, float* norm_out,
                                  const int* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mode = flags >> MODE_SHIFT;
  const int n_partials = n_groups(n_leaves) * OPT_BLOCKS;
  for (int first = 0; first < n_leaves; first += OPT_MAX_LEAVES) {
    const Table t = make_table(leaves, first,
                               std::min(OPT_MAX_LEAVES, n_leaves - first), mode);
    float* out = first == 0 ? norm_out : nullptr;
    switch (mode) {
      case SGD:
        update_kernel<SGD><<<OPT_BLOCKS, OPT_THREADS, 0, s>>>(
            t, *k, sigma, flags, partials, n_partials, norm_in, out, count);
        break;
      case ADAM:
        update_kernel<ADAM><<<OPT_BLOCKS, OPT_THREADS, 0, s>>>(
            t, *k, sigma, flags, partials, n_partials, norm_in, out, count);
        break;
      case ADAM_MU_BF16:
        update_kernel<ADAM_MU_BF16><<<OPT_BLOCKS, OPT_THREADS, 0, s>>>(
            t, *k, sigma, flags, partials, n_partials, norm_in, out, count);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
    AST_RETURN_IF_ERR(cudaGetLastError());
  }
  return 0;
}
