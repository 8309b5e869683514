// Grouped sparse-row kernels for the PartialFC class table on NVIDIA Hopper
// (sm_90a): the gather of the sampled row groups and the in-place
// SGD-momentum and AdamW updates of those groups.
//
// Replaces the TPU kernels of fr_tpu/ops/sparse_rows.py:
//   grouped_gather        ← grouped_gather        (pallas_call :85)
//   grouped_update_sgd    ← grouped_update_sgd    (pallas_call :141)
//   grouped_update_adamw  ← grouped_update_adamw  (pallas_call :208)
// Their contract is that file's jnp fallbacks (take / put on the expanded
// row index). Under block-aligned sampling the head draws `ng` aligned
// groups of `block` consecutive class rows, so with gidx (ng,) the sorted
// unique group ids, group i is the contiguous run of block·D floats at
// element gidx[i]·block·D of the (C, D) table and at i·block·D of the dense
// (ng·block, D) array:
//   gather:  out[i] = table[gidx[i]]
//   SGD:     g += wd·w;  buf = mom·buf + g;  w −= lr·buf
//   AdamW:   w ·= 1 − lr·wd;  m = β1·m + (1−β1)·g;  v = β2·v + (1−β2)·g²;
//            w −= (lr/bc1)·m / (√v/√bc2 + eps)
// written back to the same rows of the table and its slots. Rows outside
// the sampled groups are never read or written.
//
// What bounds them on the card: bytes. They do a handful of flops per
// element; at WebFace42M (C = 2,059,968, D = 512, 3,218 groups of 64) the
// gather moves 843.6 MB, SGD 2,108.9 MB and AdamW 2,952.5 MB. The TPU
// design (one (block, D) BlockSpec per sequential grid step, ids by scalar
// prefetch, input_output_aliases for the write in place) answers
// constraints this card does not have. Here a CUDA block takes one chunk
// of one group: it reads its group id itself, every thread moves 16-byte
// vectors with neighbouring threads on neighbouring addresses, and each
// thread issues all its loads before its first store so that several
// requests per thread are in flight. The tensors are updated in place
// because the caller hands the same pointers in and out.
//
// Every element offset is 64-bit: the last row of the WebFace42M table
// starts at element 1.05e9 and byte 4.2e9. The groups must be unique; two
// equal ids would make two blocks update the same rows at once. A group id
// outside [0, C/block) is skipped, so a wrong index cannot write outside
// the table.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                       // vectors per thread
constexpr int kChunk = kThreads * kUnroll;       // vectors per CUDA block

// One vector of V floats: float4 when a group's length is a multiple of 4
// floats (so every group starts on a 16-byte boundary), else float.
template <int V> struct Vec;
template <> struct Vec<4> { using type = float4; };
template <> struct Vec<1> { using type = float; };

// Which chunk of which group this CUDA block owns. vpg: vectors per group;
// cpg: chunks per group. Returns false for a group id outside the table.
struct Where {
  int64_t table;   // vector offset of the chunk in the (C, D) table
  int64_t dense;   // vector offset of the chunk in the dense array
  int64_t left;    // vectors of the group from the chunk's start on
};

__device__ __forceinline__ bool locate(const int64_t* __restrict__ gidx,
                                       int64_t n_groups, int64_t vpg,
                                       int cpg, Where* w) {
  const int64_t b = blockIdx.x;
  const int64_t i = b / cpg;
  const int64_t start = (b - i * cpg) * kChunk;
  const int64_t g = gidx[i];
  if (g < 0 || g >= n_groups) return false;
  w->table = g * vpg + start;
  w->dense = i * vpg + start;
  w->left = vpg - start;
  return true;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
grouped_gather_kernel(const typename Vec<V>::type* __restrict__ table,
                      const int64_t* __restrict__ gidx,
                      typename Vec<V>::type* __restrict__ out,
                      int64_t n_groups, int64_t vpg, int cpg) {
  using T = typename Vec<V>::type;
  Where w;
  if (!locate(gidx, n_groups, vpg, cpg, &w)) return;
  T r[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int64_t o = threadIdx.x + j * kThreads;
    if (o < w.left) r[j] = table[w.table + o];
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int64_t o = threadIdx.x + j * kThreads;
    if (o < w.left) out[w.dense + o] = r[j];
  }
}

struct Sgd {
  float lr, wd, mom;
  __device__ __forceinline__ void operator()(float& w, float& b,
                                             float g) const {
    g = g + wd * w;
    b = mom * b + g;
    w = w - lr * b;
  }
};

struct AdamW {
  float decay, b1, omb1, b2, omb2, step, sqrt_bc2, eps;
  __device__ __forceinline__ void operator()(float& w, float& m, float& v,
                                             float g) const {
    w = w * decay;
    m = b1 * m + omb1 * g;
    v = b2 * v + omb2 * (g * g);
    w = w - step * m / (sqrtf(v) / sqrt_bc2 + eps);
  }
};

__device__ __forceinline__ void apply(const Sgd& f, float& w, float& b,
                                      const float& g) { f(w, b, g); }
__device__ __forceinline__ void apply(const Sgd& f, float4& w, float4& b,
                                      const float4& g) {
  f(w.x, b.x, g.x); f(w.y, b.y, g.y); f(w.z, b.z, g.z); f(w.w, b.w, g.w);
}
__device__ __forceinline__ void apply(const AdamW& f, float& w, float& m,
                                      float& v, const float& g) {
  f(w, m, v, g);
}
__device__ __forceinline__ void apply(const AdamW& f, float4& w, float4& m,
                                      float4& v, const float4& g) {
  f(w.x, m.x, v.x, g.x); f(w.y, m.y, v.y, g.y);
  f(w.z, m.z, v.z, g.z); f(w.w, m.w, v.w, g.w);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
grouped_sgd_kernel(typename Vec<V>::type* __restrict__ weight,
                   typename Vec<V>::type* __restrict__ momentum,
                   const int64_t* __restrict__ gidx,
                   const typename Vec<V>::type* __restrict__ grad, Sgd f,
                   int64_t n_groups, int64_t vpg, int cpg) {
  using T = typename Vec<V>::type;
  Where w;
  if (!locate(gidx, n_groups, vpg, cpg, &w)) return;
  T rw[kUnroll], rb[kUnroll], rg[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int64_t o = threadIdx.x + j * kThreads;
    if (o < w.left) {
      rw[j] = weight[w.table + o];
      rb[j] = momentum[w.table + o];
      rg[j] = grad[w.dense + o];
    }
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int64_t o = threadIdx.x + j * kThreads;
    if (o < w.left) {
      apply(f, rw[j], rb[j], rg[j]);
      weight[w.table + o] = rw[j];
      momentum[w.table + o] = rb[j];
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
grouped_adamw_kernel(typename Vec<V>::type* __restrict__ weight,
                     typename Vec<V>::type* __restrict__ exp_avg,
                     typename Vec<V>::type* __restrict__ exp_avg_sq,
                     const int64_t* __restrict__ gidx,
                     const typename Vec<V>::type* __restrict__ grad, AdamW f,
                     int64_t n_groups, int64_t vpg, int cpg) {
  using T = typename Vec<V>::type;
  Where w;
  if (!locate(gidx, n_groups, vpg, cpg, &w)) return;
  T rw[kUnroll], rm[kUnroll], rv[kUnroll], rg[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int64_t o = threadIdx.x + j * kThreads;
    if (o < w.left) {
      rw[j] = weight[w.table + o];
      rm[j] = exp_avg[w.table + o];
      rv[j] = exp_avg_sq[w.table + o];
      rg[j] = grad[w.dense + o];
    }
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int64_t o = threadIdx.x + j * kThreads;
    if (o < w.left) {
      apply(f, rw[j], rm[j], rv[j], rg[j]);
      weight[w.table + o] = rw[j];
      exp_avg[w.table + o] = rm[j];
      exp_avg_sq[w.table + o] = rv[j];
    }
  }
}

// The launch geometry shared by the three entry points. group_elems =
// block·D floats per group. Fails (cudaErrorInvalidValue) on empty or
// oversized problems instead of launching.
struct Geometry {
  int vec;         // 4 or 1
  int64_t vpg;     // vectors per group
  int cpg;         // chunks (CUDA blocks) per group
  unsigned grid;
  bool ok;
};

Geometry geometry(int64_t ng, int64_t group_elems) {
  Geometry g{};
  if (ng <= 0 || group_elems <= 0) return g;
  g.vec = group_elems % 4 == 0 ? 4 : 1;
  g.vpg = group_elems / g.vec;
  const int64_t cpg = (g.vpg + kChunk - 1) / kChunk;
  const int64_t blocks = ng * cpg;
  if (cpg > INT32_MAX || blocks > 2147483647LL) return g;
  g.cpg = static_cast<int>(cpg);
  g.grid = static_cast<unsigned>(blocks);
  g.ok = true;
  return g;
}

}  // namespace

// table (n_groups·block, D) f32, gidx (ng,) int64, out (ng·block, D) f32;
// group_elems = block·D. Returns the launch's cudaGetLastError(); the
// kernel runs asynchronously on `stream`.
extern "C" int grouped_gather(const void* table, const void* gidx, void* out,
                              long long n_groups, long long ng,
                              long long group_elems, void* stream) {
  const Geometry g = geometry(ng, group_elems);
  if (!g.ok) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto ids = static_cast<const int64_t*>(gidx);
  if (g.vec == 4) {
    grouped_gather_kernel<4><<<g.grid, kThreads, 0, s>>>(
        static_cast<const float4*>(table), ids, static_cast<float4*>(out),
        n_groups, g.vpg, g.cpg);
  } else {
    grouped_gather_kernel<1><<<g.grid, kThreads, 0, s>>>(
        static_cast<const float*>(table), ids, static_cast<float*>(out),
        n_groups, g.vpg, g.cpg);
  }
  return cudaGetLastError();
}

// weight and momentum (n_groups·block, D) f32, updated in place on the rows
// of the ng groups; grad (ng·block, D) f32.
extern "C" int grouped_update_sgd(void* weight, void* momentum,
                                  const void* gidx, const void* grad,
                                  long long n_groups, long long ng,
                                  long long group_elems, double lr, double wd,
                                  double mom, void* stream) {
  const Geometry g = geometry(ng, group_elems);
  if (!g.ok) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto ids = static_cast<const int64_t*>(gidx);
  const Sgd f{static_cast<float>(lr), static_cast<float>(wd),
              static_cast<float>(mom)};
  if (g.vec == 4) {
    grouped_sgd_kernel<4><<<g.grid, kThreads, 0, s>>>(
        static_cast<float4*>(weight), static_cast<float4*>(momentum), ids,
        static_cast<const float4*>(grad), f, n_groups, g.vpg, g.cpg);
  } else {
    grouped_sgd_kernel<1><<<g.grid, kThreads, 0, s>>>(
        static_cast<float*>(weight), static_cast<float*>(momentum), ids,
        static_cast<const float*>(grad), f, n_groups, g.vpg, g.cpg);
  }
  return cudaGetLastError();
}

// weight, exp_avg and exp_avg_sq (n_groups·block, D) f32, updated in place;
// bc1 = 1 − β1ᵗ and bc2 = 1 − β2ᵗ of the head's step count t come from the
// caller. The derived scalars are formed in double and rounded to f32 once,
// as a host scalar is when it meets an f32 tensor.
extern "C" int grouped_update_adamw(void* weight, void* exp_avg,
                                    void* exp_avg_sq, const void* gidx,
                                    const void* grad, long long n_groups,
                                    long long ng, long long group_elems,
                                    double lr, double wd, double b1,
                                    double b2, double eps, double bc1,
                                    double bc2, void* stream) {
  const Geometry g = geometry(ng, group_elems);
  if (!g.ok) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto ids = static_cast<const int64_t*>(gidx);
  const AdamW f{static_cast<float>(1.0 - lr * wd), static_cast<float>(b1),
                static_cast<float>(1.0 - b1), static_cast<float>(b2),
                static_cast<float>(1.0 - b2), static_cast<float>(lr / bc1),
                static_cast<float>(std::sqrt(bc2)), static_cast<float>(eps)};
  if (g.vec == 4) {
    grouped_adamw_kernel<4><<<g.grid, kThreads, 0, s>>>(
        static_cast<float4*>(weight), static_cast<float4*>(exp_avg),
        static_cast<float4*>(exp_avg_sq), ids,
        static_cast<const float4*>(grad), f, n_groups, g.vpg, g.cpg);
  } else {
    grouped_adamw_kernel<1><<<g.grid, kThreads, 0, s>>>(
        static_cast<float*>(weight), static_cast<float*>(exp_avg),
        static_cast<float*>(exp_avg_sq), ids,
        static_cast<const float*>(grad), f, n_groups, g.vpg, g.cpg);
  }
  return cudaGetLastError();
}
