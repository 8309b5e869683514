// BatchNorm for NVIDIA Hopper (sm_90a): flax's BatchNorm over an activation
// kept in its own dtype (bf16 or f32), with the statistics, the
// normalisation and the affine in f32 registers.
//
// Replaces no TPU kernel. fr_tpu's BatchNorm is flax's
// (fr_tpu/models/common.py:61-81): it casts x to f32, normalises with f32
// batch statistics (eps 1e-5), rounds the output to x's dtype and updates
// the running statistics as 0.9·R + 0.1·batch with the biased variance. On
// the TPU, XLA fuses the casts into the normalisation. Done with library
// calls on the card, the same arithmetic wrote an f32 copy of every
// activation and read it back, forward and backward, and took about ten
// small launches a BatchNorm. These kernels read and write the activation
// in its own dtype and round at the same points: x → f32 in registers, the
// output rounded once to x's dtype (round to nearest even), the gradient
// dx computed in f32 and rounded once.
//
// The activation is an (M, C) row-major matrix: the M = N·H·W rows of a
// channels_last NCHW tensor, or the (N, C) input of a BN1d. Five kernels:
//   bn_stats       per-channel mean and biased variance (Welford in each
//                  thread, Chan's pairwise combination across threads and
//                  CTAs); its epilogue writes mean, rstd = rsqrt(var + eps),
//                  scale = γ·rstd, updates the running mean and variance
//                  and increments num_batches_tracked;
//   bn_apply       y = T((x − mean)·scale + β), flax's _normalize order;
//   bn_bwd_reduce  Σdy and Σdy·x̂ per channel, x̂ = (x − mean)·rstd: these
//                  are dβ and dγ; its epilogue writes them and the three
//                  coefficients of bn_bwd_apply;
//   bn_bwd_apply   dx = T(γ·rstd·(dy − Σdy/M − x̂·Σdy·x̂/M));
//   bn_eval        y = T((x − R_mean)·(γ·rsqrt(R_var + eps)) + β), one pass.
// In eval mode under autograd the backward pair runs with the running
// statistics and `frozen` set: dx = T(γ·rstd·dy). Three entry points,
// each setting the device it is given for the call: bn_forward (bn_stats,
// then bn_apply), bn_backward (the backward pair) and bn_eval.
//
// What bounds them on the card: bytes. A training BatchNorm moves 6 B an
// element forward (stats reads x; apply reads x, writes y) and 10 B
// backward in bf16, against a few flops an element. The design follows:
//  - 16-byte loads and stores: a thread holds V = 16 / sizeof(T) channels
//    of a row (8 in bf16, 4 in f32) where C % V == 0 and every activation
//    pointer is 16-byte aligned, else one channel (the scalar path).
//  - A CTA of kThreads threads covers a slab of at most kSlab channel
//    vectors (512 B of a bf16 row) and rpp = kThreads / slab rows at a time
//    (a tile); CTAs walk the tiles grid-strided, kUnroll tiles' loads in
//    flight per thread. Wider C takes more slabs (gridDim.y).
//  - The reductions combine without atomics on values and in a fixed
//    order, so two runs give the same bits: each thread's state, then a
//    tree over the CTA's rows in shared memory, then one partial a CTA in
//    `part`; the CTA that finishes last (an atomic ticket after
//    __threadfence) combines the partials, each thread a contiguous run of
//    CTAs in CTA order, then the same tree. The ticket counter wraps to 0
//    at the last CTA (atomicInc), so the caller zeroes it once. A
//    reduction's grid is the CTAs the card holds at once, cut so that each
//    takes kMinTiles tiles at least. That final combination is the
//    reductions' fixed cost, ~7 µs on an H100. It reads the partials as
//    16-byte loads that a warp coalesces: scalar loads that skip L1 would
//    fetch each 32-byte sector eight times, ~20 µs.
//  - The apply kernels walk the tiles in the reverse order of their
//    reduction, so the rows read last are still in the 50 MB L2.
// Statistics are Welford/Chan and never E[x²] − E[x]²: the stem of
// IR-ResNet100 at batch 256 reduces 3.2 M rows a channel in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 512;
constexpr int kSlab = 32;        // channel vectors a CTA covers at most
constexpr int kUnroll = 4;       // tiles a thread loads before it uses them
constexpr int kMinTiles = 4;     // tiles a reduction's CTA takes at least
constexpr int kPrefetch = 4;     // partials a final combination loads at once
constexpr int kMaxSlabs = 256;   // ticket counters the caller provides
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------------------
// V elements of T at p, as f32
// ---------------------------------------------------------------------------

template <typename T, int V> struct Io;

__device__ __forceinline__ void unpack(unsigned w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
         | (static_cast<unsigned>(
                __bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

template <> struct Io<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&f)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    unpack(u.x, f[0], f[1]);
    unpack(u.y, f[2], f[3]);
    unpack(u.z, f[4], f[5]);
    unpack(u.w, f[6], f[7]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&f)[8]) {
    uint4 u;
    u.x = pack(f[0], f[1]);
    u.y = pack(f[2], f[3]);
    u.z = pack(f[4], f[5]);
    u.w = pack(f[6], f[7]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <> struct Io<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&f)[1]) {
    f[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&f)[1]) {
    *p = __float2bfloat16_rn(f[0]);
  }
};

template <> struct Io<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&f)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <> struct Io<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&f)[1]) {
    f[0] = *p;
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&f)[1]) {
    *p = f[0];
  }
};

// ---------------------------------------------------------------------------
// Geometry and the thread's place in it
// ---------------------------------------------------------------------------

struct Geo {
  int64_t m;       // rows
  int c;           // channels
  int cv;          // channel vectors, c / V
  int slab;        // channel vectors a CTA covers
  int rpp;         // rows a tile covers, kThreads / slab
  int64_t tiles;   // ceil(m / rpp)
};

struct Lane {
  int r;      // row within a tile; in a final combination, the run of CTAs
  int ch0;    // first channel
  bool on;    // r < rpp and the channel vector exists
};

__device__ __forceinline__ Lane lane(const Geo& g, int v) {
  const int cvi = blockIdx.y * g.slab + threadIdx.x % g.slab;
  Lane l;
  l.r = threadIdx.x / g.slab;
  l.ch0 = cvi * v;
  l.on = l.r < g.rpp && cvi < g.cv;
  return l;
}

// ---------------------------------------------------------------------------
// Combining per-channel states: (n, mean, M2) by Chan's pairwise formula, or
// (Σa, Σb) by addition
// ---------------------------------------------------------------------------

template <bool kChan, int V>
__device__ __forceinline__ void combine(float& na, float (&a)[V],
                                        float (&b)[V], float nb,
                                        const float (&ob_a)[V],
                                        const float (&ob_b)[V]) {
  if (kChan) {
    if (nb == 0.f) return;
    const float n = na + nb;
    const float fb = nb / n;
    const float w = na * fb;   // na·nb / n
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = ob_a[j] - a[j];
      a[j] += d * fb;
      b[j] += ob_b[j] + d * d * w;
    }
    na = n;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a[j] += ob_a[j];
      b[j] += ob_b[j];
    }
  }
}

// V f32 of a partial, through L2 only (other CTAs wrote them): one 16-byte
// load for every 4, so that a warp's loads of neighbouring vectors coalesce
template <int V>
__device__ __forceinline__ void load_partial(const float* p, float (&f)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 u = __ldcg(reinterpret_cast<const float4*>(p) + q);
      f[4 * q] = u.x;
      f[4 * q + 1] = u.y;
      f[4 * q + 2] = u.z;
      f[4 * q + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = __ldcg(p + j);
  }
}

template <int V>
__device__ __forceinline__ void store_partial(float* p, const float (&f)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      reinterpret_cast<float4*>(p)[q] =
          make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = f[j];
  }
}

template <int V> struct Shared {
  float n[kThreads];
  float a[V][kThreads];
  float b[V][kThreads];
  bool last;
};

// Combines the states of the rpp threads of each channel vector in a fixed
// tree over r; thread r = 0 ends with the result. Every thread of the CTA
// calls it.
template <bool kChan, int V>
__device__ void cta_tree(const Geo& g, const Lane& l, Shared<V>& s, float& n,
                         float (&a)[V], float (&b)[V]) {
  const int t = threadIdx.x;
  s.n[t] = n;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s.a[j][t] = a[j];
    s.b[j][t] = b[j];
  }
  int p2 = 1;
  while (p2 < g.rpp) p2 <<= 1;
  for (int half = p2 >> 1; half > 0; half >>= 1) {
    __syncthreads();
    if (l.r < half && l.r + half < g.rpp) {
      const int o = t + half * g.slab;
      float oa[V], ob[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        oa[j] = s.a[j][o];
        ob[j] = s.b[j][o];
      }
      combine<kChan, V>(n, a, b, s.n[o], oa, ob);
      s.n[t] = n;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s.a[j][t] = a[j];
        s.b[j][t] = b[j];
      }
    }
  }
  __syncthreads();
}

// After the CTA's own tree: writes its partial, takes a ticket, and in the
// CTA that finishes last combines all partials of its slab in CTA order.
// Returns true in that CTA only, where thread r = 0 then holds the result.
// part: a at [b·C + ch], b at [G·C + b·C + ch], n at [2·G·C + y·G + b].
template <bool kChan, int V>
__device__ bool grid_combine(const Geo& g, const Lane& l, Shared<V>& s,
                             float* __restrict__ part,
                             unsigned* __restrict__ tickets, float& n,
                             float (&a)[V], float (&b)[V]) {
  const int64_t G = gridDim.x;
  const int64_t gc = G * g.c;
  if (l.on && l.r == 0) {
    float* pa = part + blockIdx.x * static_cast<int64_t>(g.c) + l.ch0;
    store_partial<V>(pa, a);
    store_partial<V>(pa + gc, b);
    if (threadIdx.x == 0) part[2 * gc + blockIdx.y * G + blockIdx.x] = n;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s.last = atomicInc(tickets + blockIdx.y,
                       static_cast<unsigned>(G - 1)) == G - 1;
  }
  __syncthreads();
  if (!s.last) return false;
  __threadfence();

  n = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) a[j] = b[j] = 0.f;
  if (l.on) {
    // kPrefetch partials' loads in flight before they are combined in order;
    // an absent one weighs nothing (Chan) or adds zeros
    const int64_t lo = l.r * G / g.rpp, hi = (l.r + 1) * G / g.rpp;
    const float* pn = part + 2 * gc + blockIdx.y * G;
    for (int64_t c0 = lo; c0 < hi; c0 += kPrefetch) {
      float nb[kPrefetch], oa[kPrefetch][V], ob[kPrefetch][V];
#pragma unroll
      for (int k = 0; k < kPrefetch; ++k) {
        const int64_t cta = c0 + k;
        if (cta < hi) {
          const float* pa = part + cta * g.c + l.ch0;
          nb[k] = __ldcg(pn + cta);
          load_partial<V>(pa, oa[k]);
          load_partial<V>(pa + gc, ob[k]);
        } else {
          nb[k] = 0.f;
#pragma unroll
          for (int j = 0; j < V; ++j) oa[k][j] = ob[k][j] = 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < kPrefetch; ++k)
        combine<kChan, V>(n, a, b, nb[k], oa[k], ob[k]);
    }
  }
  cta_tree<kChan, V>(g, l, s, n, a, b);
  return true;
}

// Tile indices of this CTA, kUnroll at a time: forward from blockIdx.x, or
// from the last tile backward.
template <bool kReverse>
__device__ __forceinline__ int64_t tile_of(const Geo& g, int64_t i) {
  return kReverse ? g.tiles - 1 - i : i;
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const T* __restrict__ x, Geo g,
                const float* __restrict__ weight,
                float* __restrict__ running_mean,
                float* __restrict__ running_var,
                long long* __restrict__ batches, float* __restrict__ stats,
                float* __restrict__ part, unsigned* __restrict__ tickets,
                float keep, float take, float eps) {
  __shared__ Shared<V> s;
  const Lane l = lane(g, V);
  float n = 0.f, mean[V], m2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0.f;
  if (l.on) {
    const int64_t G = gridDim.x;
    for (int64_t i0 = blockIdx.x; i0 < g.tiles; i0 += G * kUnroll) {
      float v[kUnroll][V];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t row = (i0 + u * G) * g.rpp + l.r;
        ok[u] = row < g.m;
        if (ok[u]) Io<T, V>::load(x + row * g.c + l.ch0, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!ok[u]) continue;
        n += 1.f;
        const float rn = 1.f / n;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = v[u][j] - mean[j];
          mean[j] += d * rn;
          m2[j] += d * (v[u][j] - mean[j]);
        }
      }
    }
  }
  cta_tree<true, V>(g, l, s, n, mean, m2);
  if (!grid_combine<true, V>(g, l, s, part, tickets, n, mean, m2)) return;
  if (!(l.on && l.r == 0)) return;
  // stats: mean at [0, C), rstd at [C, 2C), scale γ·rstd at [2C, 3C)
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = l.ch0 + j;
    const float var = m2[j] / n;   // biased, as flax's
    const float rstd = rsqrtf(var + eps);
    stats[ch] = mean[j];
    stats[g.c + ch] = rstd;
    stats[2 * g.c + ch] = weight[ch] * rstd;
    running_mean[ch] = keep * running_mean[ch] + take * mean[j];
    running_var[ch] = keep * running_var[ch] + take * var;
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) *batches += 1;
}

template <typename T, int V, bool kEval>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ x, T* __restrict__ y, Geo g,
                const float* __restrict__ mean,
                const float* __restrict__ scale_or_var,
                const float* __restrict__ weight,
                const float* __restrict__ bias, float eps) {
  const Lane l = lane(g, V);
  if (!l.on) return;
  // training: bn_stats' mean and scale; eval: the running mean and variance
  float mu[V], sc[V], be[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = l.ch0 + j;
    mu[j] = mean[ch];
    sc[j] = kEval ? rsqrtf(scale_or_var[ch] + eps) * weight[ch]
                  : scale_or_var[ch];
    be[j] = bias[ch];
  }
  const int64_t G = gridDim.x;
  for (int64_t i0 = blockIdx.x; i0 < g.tiles; i0 += G * kUnroll) {
    float v[kUnroll][V];
    int64_t off[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * G;
      const int64_t row = tile_of<!kEval>(g, i) * g.rpp + l.r;
      ok[u] = i < g.tiles && row < g.m;
      off[u] = row * g.c + l.ch0;
      if (ok[u]) Io<T, V>::load(x + off[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[u][j] = __fadd_rn(__fmul_rn(v[u][j] - mu[j], sc[j]), be[j]);
      Io<T, V>::store(y + off[u], v[u]);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     Geo g, const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const float* __restrict__ weight,
                     float* __restrict__ dweight, float* __restrict__ dbias,
                     float* __restrict__ coef, float* __restrict__ part,
                     unsigned* __restrict__ tickets, float inv_m,
                     int frozen) {
  __shared__ Shared<V> s;
  const Lane l = lane(g, V);
  float n = 0.f, sdy[V], sdyx[V], mu[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sdy[j] = sdyx[j] = 0.f;
    mu[j] = l.on ? mean[l.ch0 + j] : 0.f;
  }
  if (l.on) {
    const int64_t G = gridDim.x;
    for (int64_t i0 = blockIdx.x; i0 < g.tiles; i0 += G * kUnroll) {
      float xv[kUnroll][V], dv[kUnroll][V];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t row = (i0 + u * G) * g.rpp + l.r;
        ok[u] = row < g.m;
        if (ok[u]) {
          Io<T, V>::load(x + row * g.c + l.ch0, xv[u]);
          Io<T, V>::load(dy + row * g.c + l.ch0, dv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!ok[u]) continue;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          sdy[j] += dv[u][j];
          sdyx[j] += dv[u][j] * (xv[u][j] - mu[j]);
        }
      }
    }
  }
  cta_tree<false, V>(g, l, s, n, sdy, sdyx);
  if (!grid_combine<false, V>(g, l, s, part, tickets, n, sdy, sdyx)) return;
  if (!(l.on && l.r == 0)) return;
  // coef: γ·rstd at [0, C), Σdy/M at [C, 2C), rstd·Σdy·x̂/M at [2C, 3C)
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = l.ch0 + j;
    const float rs = rstd[ch];
    const float dw = sdyx[j] * rs;   // Σdy·x̂
    dbias[ch] = sdy[j];
    dweight[ch] = dw;
    coef[ch] = weight[ch] * rs;
    coef[g.c + ch] = frozen ? 0.f : sdy[j] * inv_m;
    coef[2 * g.c + ch] = frozen ? 0.f : dw * rs * inv_m;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    T* __restrict__ dx, Geo g,
                    const float* __restrict__ mean,
                    const float* __restrict__ coef) {
  const Lane l = lane(g, V);
  if (!l.on) return;
  float mu[V], gr[V], ca[V], cb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = l.ch0 + j;
    mu[j] = mean[ch];
    gr[j] = coef[ch];
    ca[j] = coef[g.c + ch];
    cb[j] = coef[2 * g.c + ch];
  }
  const int64_t G = gridDim.x;
  for (int64_t i0 = blockIdx.x; i0 < g.tiles; i0 += G * kUnroll) {
    float xv[kUnroll][V], dv[kUnroll][V];
    int64_t off[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * G;
      const int64_t row = tile_of<true>(g, i) * g.rpp + l.r;
      ok[u] = i < g.tiles && row < g.m;
      off[u] = row * g.c + l.ch0;
      if (ok[u]) {
        Io<T, V>::load(x + off[u], xv[u]);
        Io<T, V>::load(dy + off[u], dv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int j = 0; j < V; ++j)
        dv[u][j] = gr[j] * ((dv[u][j] - ca[j]) - (xv[u][j] - mu[j]) * cb[j]);
      Io<T, V>::store(dx + off[u], dv[u]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

enum Kind { kStats, kApply, kEvalKind, kBwdReduce, kBwdApply };

// CTAs of `kernel` (kind K at T, V) the current device holds at once,
// cached per device
template <int K, typename T, int V>
int resident_ctas(const void* kernel) {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  int ctas = cache[dev].load(std::memory_order_relaxed);
  if (ctas > 0) return ctas;
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
          != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       kThreads, 0)
             != cudaSuccess)
    return 0;
  ctas = std::max(1, sms * per_sm);
  cache[dev].store(ctas, std::memory_order_relaxed);
  return ctas;
}

template <typename T, int V> struct Tag {
  using type = T;
  static constexpr int v = V;
};

// Calls f(Tag<T, V>{}) for the element type (0 = float32, 1 = bfloat16) and
// the vector width: 16 bytes where C allows it and every activation
// pointer is 16-byte aligned, else one element.
template <typename F>
int by_type(int dtype, long long c, bool aligned, F&& f) {
  if (dtype == 1) {
    return aligned && c % 8 == 0 ? f(Tag<__nv_bfloat16, 8>{})
                                 : f(Tag<__nv_bfloat16, 1>{});
  }
  if (dtype == 0) {
    return aligned && c % 4 == 0 ? f(Tag<float, 4>{}) : f(Tag<float, 1>{});
  }
  return cudaErrorInvalidValue;
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// The geometry at vector width v; false for an empty or oversized problem.
bool plan(long long m, long long c, int v, Geo* g, int* slabs) {
  if (m <= 0 || c <= 0 || c > INT32_MAX / 4) return false;
  g->m = m;
  g->c = static_cast<int>(c);
  g->cv = static_cast<int>(c / v);
  g->slab = std::min(g->cv, kSlab);
  g->rpp = kThreads / g->slab;
  g->tiles = (m + g->rpp - 1) / g->rpp;
  *slabs = (g->cv + g->slab - 1) / g->slab;
  return *slabs <= kMaxSlabs;
}

// Floats of `part` a reduction's grid fills, in grid_combine's layout: a
// and b for each CTA and channel, n for each CTA.
int64_t part_size(const Geo& g, dim3 grid) {
  return (2 * static_cast<int64_t>(g.c) + grid.y) * grid.x;
}

// Grid of an apply kernel: one CTA per tile at most, no more than the card
// holds at once.
dim3 apply_grid(const Geo& g, int slabs, int resident) {
  const int64_t per_slab = std::max(1, resident / slabs);
  return dim3(static_cast<unsigned>(std::min<int64_t>(per_slab, g.tiles)),
              slabs);
}

// Grid of a reduction: as an apply kernel's, but kMinTiles tiles a CTA at
// least; fails if `part` cannot hold its partials.
bool reduce_grid(const Geo& g, int slabs, int resident,
                 long long part_floats, dim3* grid) {
  const int64_t per_slab = std::max(1, resident / slabs);
  const int64_t want = (g.tiles + kMinTiles - 1) / kMinTiles;
  *grid = dim3(static_cast<unsigned>(std::max<int64_t>(
                   1, std::min(per_slab, want))), slabs);
  return part_size(g, *grid) <= part_floats;
}

// Resident CTAs of a reduction kernel
template <int K, typename T, int V>
int reduce_ctas() {
  if (K == kStats)
    return resident_ctas<K, T, V>(
        reinterpret_cast<const void*>(bn_stats_kernel<T, V>));
  return resident_ctas<K, T, V>(
      reinterpret_cast<const void*>(bn_bwd_reduce_kernel<T, V>));
}

// Floats of `part` the reduction K at vector width V fills at the most over
// C channels: its grid at a problem of more tiles than the card holds at
// once. 0 where the path takes no such C, -1 on a CUDA error.
template <int K, typename T, int V>
int64_t reduce_part_size(long long c) {
  Geo g;
  int slabs;
  dim3 grid;
  if (!plan(int64_t{1} << 48, c, V, &g, &slabs)) return 0;
  const int resident = reduce_ctas<K, T, V>();
  if (resident <= 0) return -1;
  reduce_grid(g, slabs, resident, 0, &grid);
  return part_size(g, grid);
}

// The five launches; each returns its cudaGetLastError().

int launch_stats(const void* x, int dtype, long long m, long long c,
                 const void* weight, void* running_mean, void* running_var,
                 void* batches, void* stats, void* part,
                 long long part_floats, void* tickets, double keep,
                 double take, double eps, void* stream) {
  return by_type(dtype, c, aligned16({x}), [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(tag)::v;
    Geo g;
    int slabs;
    dim3 grid;
    if (!plan(m, c, V, &g, &slabs)
        || !reduce_grid(g, slabs, reduce_ctas<kStats, T, V>(), part_floats,
                        &grid))
      return static_cast<int>(cudaErrorInvalidValue);
    bn_stats_kernel<T, V><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), g, static_cast<const float*>(weight),
        static_cast<float*>(running_mean), static_cast<float*>(running_var),
        static_cast<long long*>(batches), static_cast<float*>(stats),
        static_cast<float*>(part), static_cast<unsigned*>(tickets),
        static_cast<float>(keep), static_cast<float>(take),
        static_cast<float>(eps));
    return static_cast<int>(cudaGetLastError());
  });
}

// kEval: mean and var are the running statistics; else mean is bn_stats'
// stats (mean at 0, scale at 2C) and var unused
template <bool kEval>
int launch_apply(const void* x, void* y, int dtype, long long m, long long c,
                 const void* mean, const void* var, const void* weight,
                 const void* bias, double eps, void* stream) {
  return by_type(dtype, c, aligned16({x, y}), [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(tag)::v;
    Geo g;
    int slabs;
    const auto kernel = bn_apply_kernel<T, V, kEval>;
    if (!plan(m, c, V, &g, &slabs))
      return static_cast<int>(cudaErrorInvalidValue);
    const int resident = resident_ctas<kEval ? kEvalKind : kApply, T, V>(
        reinterpret_cast<const void*>(kernel));
    const float* mu = static_cast<const float*>(mean);
    kernel<<<apply_grid(g, slabs, resident), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<T*>(y), g, mu,
        kEval ? static_cast<const float*>(var) : mu + 2 * c,
        static_cast<const float*>(weight), static_cast<const float*>(bias),
        static_cast<float>(eps));
    return static_cast<int>(cudaGetLastError());
  });
}

int launch_bwd_reduce(const void* x, const void* dy, int dtype, long long m,
                      long long c, const void* mean, const void* rstd,
                      const void* weight, void* dweight, void* dbias,
                      void* coef, void* part, long long part_floats,
                      void* tickets, int frozen, void* stream) {
  return by_type(dtype, c, aligned16({x, dy}), [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(tag)::v;
    Geo g;
    int slabs;
    dim3 grid;
    if (!plan(m, c, V, &g, &slabs)
        || !reduce_grid(g, slabs, reduce_ctas<kBwdReduce, T, V>(),
                        part_floats, &grid))
      return static_cast<int>(cudaErrorInvalidValue);
    bn_bwd_reduce_kernel<T, V><<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), g,
        static_cast<const float*>(mean), static_cast<const float*>(rstd),
        static_cast<const float*>(weight), static_cast<float*>(dweight),
        static_cast<float*>(dbias), static_cast<float*>(coef),
        static_cast<float*>(part), static_cast<unsigned*>(tickets),
        static_cast<float>(1.0 / static_cast<double>(m)), frozen);
    return static_cast<int>(cudaGetLastError());
  });
}

int launch_bwd_apply(const void* x, const void* dy, void* dx, int dtype,
                     long long m, long long c, const void* mean,
                     const void* coef, void* stream) {
  return by_type(dtype, c, aligned16({x, dy, dx}), [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(tag)::v;
    Geo g;
    int slabs;
    const auto kernel = bn_bwd_apply_kernel<T, V>;
    if (!plan(m, c, V, &g, &slabs))
      return static_cast<int>(cudaErrorInvalidValue);
    const int resident = resident_ctas<kBwdApply, T, V>(
        reinterpret_cast<const void*>(kernel));
    kernel<<<apply_grid(g, slabs, resident), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy),
        static_cast<T*>(dx), g, static_cast<const float*>(mean),
        static_cast<const float*>(coef));
    return static_cast<int>(cudaGetLastError());
  });
}

// Makes `device` current for the scope of a call and restores the caller's.
struct DeviceGuard {
  int prev = -1;
  int dev;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) : dev(device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  }
  ~DeviceGuard() {
    if (err == cudaSuccess && prev != dev) cudaSetDevice(prev);
  }
};

}  // namespace

// The scratch a reduction over c channels takes on `device`, for either
// reduction and element type: *part_floats f32 for the partials and
// *tickets zeroed uint32 counters. Returns a CUDA error, or 0.
extern "C" int bn_scratch(int device, long long c, long long* part_floats,
                          int* tickets) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  int64_t most = 0;
  for (const int64_t floats : {
           reduce_part_size<kStats, __nv_bfloat16, 8>(c),
           reduce_part_size<kStats, __nv_bfloat16, 1>(c),
           reduce_part_size<kStats, float, 4>(c),
           reduce_part_size<kStats, float, 1>(c),
           reduce_part_size<kBwdReduce, __nv_bfloat16, 8>(c),
           reduce_part_size<kBwdReduce, __nv_bfloat16, 1>(c),
           reduce_part_size<kBwdReduce, float, 4>(c),
           reduce_part_size<kBwdReduce, float, 1>(c)}) {
    if (floats < 0) {
      const cudaError_t err = cudaGetLastError();
      return err != cudaSuccess ? err : cudaErrorUnknown;
    }
    most = std::max(most, floats);
  }
  if (most == 0) return cudaErrorInvalidValue;
  *part_floats = most;
  *tickets = kMaxSlabs;
  return cudaSuccess;
}

// Training forward: bn_stats, then bn_apply, on `stream` of `device`.
// x, y (M, C) rows of dtype (0 = float32, 1 = bfloat16); weight, bias,
// running_mean, running_var (C,) f32, the running pair updated in place as
// keep·R + take·batch (biased variance); batches: num_batches_tracked
// (int64), incremented; stats (3C,) f32 out: mean, rstd, scale γ·rstd;
// part: part_floats f32 and tickets: zeroed uint32, as bn_scratch sizes
// them, tickets left zeroed. Returns the first launch error
// (cudaGetLastError after each).
extern "C" int bn_forward(const void* x, void* y, int dtype, long long m,
                          long long c, const void* weight, const void* bias,
                          void* running_mean, void* running_var,
                          void* batches, void* stats, void* part,
                          long long part_floats, void* tickets, double keep,
                          double take, double eps, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const int err = launch_stats(x, dtype, m, c, weight, running_mean,
                               running_var, batches, stats, part, part_floats,
                               tickets, keep, take, eps, stream);
  if (err != cudaSuccess) return err;
  return launch_apply<false>(x, y, dtype, m, c, stats, nullptr, weight, bias,
                             eps, stream);
}

// Backward: bn_bwd_reduce, then bn_bwd_apply. dy (M, C) in x's layout and
// dtype; mean and rstd (C,) f32 (the forward's stats, or the running mean
// and rsqrt(R_var + eps) with frozen set); dweight, dbias (C,) f32 out;
// coef (3C,) f32 scratch; dx (M, C) out.
extern "C" int bn_backward(const void* x, const void* dy, void* dx,
                           int dtype, long long m, long long c,
                           const void* mean, const void* rstd,
                           const void* weight, void* dweight, void* dbias,
                           void* coef, void* part, long long part_floats,
                           void* tickets, int frozen, int device,
                           void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const int err = launch_bwd_reduce(x, dy, dtype, m, c, mean, rstd, weight,
                                    dweight, dbias, coef, part, part_floats,
                                    tickets, frozen, stream);
  if (err != cudaSuccess) return err;
  return launch_bwd_apply(x, dy, dx, dtype, m, c, mean, coef, stream);
}

// Eval: y = T((x − R_mean)·(γ·rsqrt(R_var + eps)) + β) in one launch.
extern "C" int bn_eval(const void* x, void* y, int dtype, long long m,
                       long long c, const void* running_mean,
                       const void* running_var, const void* weight,
                       const void* bias, double eps, int device,
                       void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  return launch_apply<true>(x, y, dtype, m, c, running_mean, running_var,
                            weight, bias, eps, stream);
}
