// Fused margin-softmax cross-entropy (PartialFC head) for NVIDIA Hopper
// (sm_90a): three kernels that never write the (N, K) logit matrix to
// device memory.
//
// Replaces the TPU kernels of fr_tpu/ops/fused_pfc.py::fused_margin_softmax_ce:
//   margin_ce_stats     ← _stats       (pallas_call :330, body _fwd_kernel)
//   margin_ce_grad_emb  ← _bwd_rule    (pallas_call :406, _bwd_emb_kernel)
//   margin_ce_grad_w    ← _bwd_rule    (pallas_call :425, _bwd_w_kernel)
// Their contract is that file's jnp twins _stats_jnp and _bwd_jnp. With the
// operands emb (N, D) and W (K, D) in the compute dtype T and every product
// accumulated in f32:
//   raw = emb·Wᵀ;  z = clamp(raw, −1, 1);  y = margin(z at the label
//   column)·s, −1e30 where col_valid is false;
//   stats:  m = max_j y, d = Σ_j exp(y − m), t = exp(y_label − m) per row;
//   coeff = g·(p − onehot)·margin′(z)·s, zero where raw left [−1, 1] or
//           the column is invalid, rounded to T;  p = exp(y − m)/d;
//   grad_emb = coeff·W,  grad_W = coeffᵀ·emb  (f32).
//
// What bounds it on the card: arithmetic. At the ms1m_arcface_122 shapes
// (N=128, D=512, K=26,007) W is 26.6 MB in bf16 and every kernel recomputes
// the 3.4 GFLOP logit product; the logits themselves (13 MB in f32) are
// never stored. The TPU kernels walk a sequential grid and carry sums from
// one grid step to the next; here blocks run in parallel, so
//   stats    splits the classes over blocks, each merging its own
//            online-softmax (m, d, t), and a second kernel merges the
//            per-split partials per row in a fixed order;
//   grad_emb gives each block a row tile and a range of class tiles,
//            accumulates coeff·W in shared memory, and a second kernel sums
//            the per-split partials in a fixed order;
//   grad_W   gives each block a class tile: it computes coeff for every row
//            into shared memory, then coeffᵀ·emb for its classes, and owns
//            its output rows, so it needs no second pass.
// The results do not depend on the schedule. This first version runs the
// products as register-tiled f32 FMAs on the CUDA cores (16×16 threads, a
// small micro-tile each); tensor cores (mma.sync/wgmma) and TMA are later
// steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 × 16
constexpr int kKC = 32;        // reduction (D) chunk of the logit product
constexpr float kMask = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

struct Margin {
  int kind;  // 0 ArcFace, 1 CosFace
  float s, cos_m, sin_m, theta, sinmm, m;
};

// _apply_margin_tile on one element; z already clamped.
__device__ __forceinline__ float apply_margin(float z, bool onehot,
                                              const Margin& mg) {
  if (!onehot) return z * mg.s;
  if (mg.kind == 0) {
    const float sq = 1.f - z * z;
    const float sin_theta = sq > 0.f ? sqrtf(sq) : 0.f;
    const float margined = z > mg.theta ? z * mg.cos_m - sin_theta * mg.sin_m
                                        : z - mg.sinmm;
    return margined * mg.s;
  }
  return (z - mg.m) * mg.s;
}

// _margin_deriv_tile on one element.
__device__ __forceinline__ float margin_deriv(float z, bool onehot,
                                              const Margin& mg) {
  if (!onehot || mg.kind != 0) return mg.s;
  const float sq = 1.f - z * z;
  float d = sq > 0.f ? mg.cos_m + mg.sin_m * z * rsqrtf(sq) : mg.cos_m;
  if (!(z > mg.theta)) d = 1.f;
  return d * mg.s;
}

// Shared tiles of one logit product step: A (emb) and B (W) chunks stored
// k-major with a padded row.
template <int BR, int BC>
struct LogitTiles {
  float a[kKC][BR + 1];
  float b[kKC][BC + 1];
};

// raw[i][j] = Σ_d emb[r0 + ty + 16i][d]·W[c0 + tx + 16j][d] for this
// thread's RM×RN elements (RM = BR/16, RN = BC/16). Rows ≥ N and classes
// ≥ K read as zero.
template <typename T, int BR, int BC>
__device__ __forceinline__ void tile_logits(
    const T* __restrict__ emb, const T* __restrict__ w, int N, int K, int D,
    int r0, int c0, LogitTiles<BR, BC>& t,
    float (&acc)[BR / 16][BC / 16]) {
  constexpr int RM = BR / 16;
  constexpr int RN = BC / 16;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += kKC) {
    for (int e = tid; e < BR * kKC; e += kThreads) {
      const int r = e / kKC;
      const int k = e - r * kKC;
      const int gr = r0 + r;
      const int gk = k0 + k;
      t.a[k][r] = (gr < N && gk < D)
                      ? to_f32<T>(emb[static_cast<size_t>(gr) * D + gk])
                      : 0.f;
    }
    for (int e = tid; e < BC * kKC; e += kThreads) {
      const int c = e / kKC;
      const int k = e - c * kKC;
      const int gc = c0 + c;
      const int gk = k0 + k;
      t.b[k][c] = (gc < K && gk < D)
                      ? to_f32<T>(w[static_cast<size_t>(gc) * D + gk])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kKC; ++k) {
      float av[RM];
      float bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = t.a[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = t.b[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Reductions over the 16 threads of one row group (lanes 0-15 or 16-31).
__device__ __forceinline__ float half_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// coeff of one element (_coeff_tile), rounded to T; 0 outside the matrix.
template <typename T>
__device__ __forceinline__ float coeff_at(float raw, int row, int col, int N,
                                          int K, const int* labels,
                                          const uint8_t* col_valid,
                                          const float* m_row,
                                          const float* d_row,
                                          const float* g_row,
                                          const Margin& mg) {
  if (row >= N || col >= K) return 0.f;
  const bool valid = col_valid[col] != 0;
  const bool clamp_pass = raw >= -1.f && raw <= 1.f;
  if (!valid || !clamp_pass) return 0.f;
  const float z = fminf(fmaxf(raw, -1.f), 1.f);
  const bool onehot = col == labels[row];
  const float y = apply_margin(z, onehot, mg);
  const float p = expf(y - m_row[row]) / d_row[row];
  const float dy = p - (onehot ? 1.f : 0.f);
  return round_to<T>(g_row[row] * dy * margin_deriv(z, onehot, mg));
}

// ---- stats -----------------------------------------------------------------
constexpr int kStatsBR = 32;
constexpr int kStatsBC = 64;

// grid (row tiles, splits); split s takes class tiles [s·per, (s+1)·per).
// Writes per-split (m, d, t) partials; m = −inf marks a split without
// columns.
template <typename T>
__global__ void __launch_bounds__(kThreads) margin_ce_stats_kernel(
    const T* __restrict__ emb, const T* __restrict__ w,
    const int* __restrict__ labels, const uint8_t* __restrict__ col_valid,
    int N, int K, int D, Margin mg, int tiles_per_split,
    float* __restrict__ pm, float* __restrict__ pd, float* __restrict__ pt) {
  constexpr int RM = kStatsBR / 16;
  constexpr int RN = kStatsBC / 16;
  __shared__ LogitTiles<kStatsBR, kStatsBC> tiles;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int r0 = blockIdx.x * kStatsBR;
  const int split = blockIdx.y;
  const int n_tiles = (K + kStatsBC - 1) / kStatsBC;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  float m[RM], d[RM], t[RM];
  int lab[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    d[i] = 0.f;
    t[i] = 0.f;
    const int row = r0 + ty + 16 * i;
    lab[i] = row < N ? labels[row] : -1;
  }
  float acc[RM][RN];
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int c0 = tile * kStatsBC;
    tile_logits<T, kStatsBR, kStatsBC>(emb, w, N, K, D, r0, c0, tiles, acc);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float y[RN];
      bool oh[RN];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = c0 + tx + 16 * j;
        oh[j] = col == lab[i];
        if (col < K) {
          const float z = fminf(fmaxf(acc[i][j], -1.f), 1.f);
          y[j] = col_valid[col] ? apply_margin(z, oh[j], mg) : kMask;
        } else {
          y[j] = -INFINITY;  // past the last class: not a column
        }
        tmax = fmaxf(tmax, y[j]);
      }
      // every tile holds column c0 < K, so tmax is finite for every row
      tmax = half_max(tmax);
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);
      float se = 0.f;
      float st = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float e = y[j] == -INFINITY ? 0.f : expf(y[j] - m_new);
        se += e;
        st += oh[j] ? e : 0.f;
      }
      se = half_sum(se);
      st = half_sum(st);
      d[i] = d[i] * alpha + se;
      t[i] = t[i] * alpha + st;
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = r0 + ty + 16 * i;
      if (row < N) {
        const size_t o = static_cast<size_t>(split) * N + row;
        pm[o] = m[i];
        pd[o] = d[i];
        pt[o] = t[i];
      }
    }
  }
}

// One thread per row: merge the splits' (m, d, t) in split order.
__global__ void margin_ce_merge_kernel(const float* __restrict__ pm,
                                       const float* __restrict__ pd,
                                       const float* __restrict__ pt, int N,
                                       int splits, float* __restrict__ m,
                                       float* __restrict__ d,
                                       float* __restrict__ t) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s)
    mx = fmaxf(mx, pm[static_cast<size_t>(s) * N + row]);
  float sd = 0.f;
  float st = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t o = static_cast<size_t>(s) * N + row;
    if (pm[o] == -INFINITY) continue;
    const float scale = expf(pm[o] - mx);
    sd += pd[o] * scale;
    st += pt[o] * scale;
  }
  m[row] = mx;
  d[row] = sd;
  t[row] = st;
}

// ---- grad_emb --------------------------------------------------------------
constexpr int kEmbBR = 16;
constexpr int kEmbBC = 64;
constexpr int kEmbDC = 64;  // D chunk of the coeff·W product

// grid (row tiles, splits). Dynamic shared memory: the (16, D) f32
// accumulator. Writes partial[split][row][d].
template <typename T>
__global__ void __launch_bounds__(kThreads) margin_ce_grad_emb_kernel(
    const T* __restrict__ emb, const T* __restrict__ w,
    const int* __restrict__ labels, const uint8_t* __restrict__ col_valid,
    const float* __restrict__ m_row, const float* __restrict__ d_row,
    const float* __restrict__ g_row, int N, int K, int D, Margin mg,
    int tiles_per_split, float* __restrict__ partial) {
  constexpr int RM = kEmbBR / 16;
  constexpr int RN = kEmbBC / 16;
  __shared__ LogitTiles<kEmbBR, kEmbBC> tiles;
  __shared__ float cs[kEmbBR][kEmbBC + 1];
  __shared__ float ws[kEmbBC][kEmbDC + 1];
  extern __shared__ float ge[];  // (kEmbBR, D)
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int r0 = blockIdx.x * kEmbBR;
  const int split = blockIdx.y;
  const int n_tiles = (K + kEmbBC - 1) / kEmbBC;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  for (int e = tid; e < kEmbBR * D; e += kThreads) ge[e] = 0.f;
  float acc[RM][RN];
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int c0 = tile * kEmbBC;
    tile_logits<T, kEmbBR, kEmbBC>(emb, w, N, K, D, r0, c0, tiles, acc);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        cs[ty + 16 * i][tx + 16 * j] = coeff_at<T>(
            acc[i][j], r0 + ty + 16 * i, c0 + tx + 16 * j, N, K, labels,
            col_valid, m_row, d_row, g_row, mg);
    __syncthreads();
    for (int d0 = 0; d0 < D; d0 += kEmbDC) {
      for (int e = tid; e < kEmbBC * kEmbDC; e += kThreads) {
        const int c = e / kEmbDC;
        const int dd = e - c * kEmbDC;
        const int gc = c0 + c;
        const int gd = d0 + dd;
        ws[c][dd] = (gc < K && gd < D)
                        ? to_f32<T>(w[static_cast<size_t>(gc) * D + gd])
                        : 0.f;
      }
      __syncthreads();
      // this thread's (row, d) pairs: row ty, d = d0 + tx + 16j
#pragma unroll
      for (int j = 0; j < kEmbDC / 16; ++j) {
        const int dd = tx + 16 * j;
        if (d0 + dd >= D) continue;
        float s = 0.f;
#pragma unroll 8
        for (int c = 0; c < kEmbBC; ++c) s = fmaf(cs[ty][c], ws[c][dd], s);
        ge[ty * D + d0 + dd] += s;
      }
      __syncthreads();
    }
  }
  float* out = partial + (static_cast<size_t>(split) * N + r0) * D;
  for (int e = tid; e < kEmbBR * D; e += kThreads) {
    const int r = e / D;
    if (r0 + r < N) out[e] = ge[e];
  }
}

// out[i] = Σ_s partial[s][i] in split order, i < N·D.
__global__ void split_sum_kernel(const float* __restrict__ partial,
                                 size_t count, int splits,
                                 float* __restrict__ out) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += partial[s * count + i];
  out[i] = acc;
}

// ---- grad_W ----------------------------------------------------------------
constexpr int kWBR = 32;   // rows per logit tile
constexpr int kWBC = 32;   // classes per block
constexpr int kWDC = 64;   // D chunk of the coeffᵀ·emb product

// grid (class tiles). Dynamic shared memory: coeff (N rounded up to 32,
// 33) for every row of this block's classes.
template <typename T>
__global__ void __launch_bounds__(kThreads) margin_ce_grad_w_kernel(
    const T* __restrict__ emb, const T* __restrict__ w,
    const int* __restrict__ labels, const uint8_t* __restrict__ col_valid,
    const float* __restrict__ m_row, const float* __restrict__ d_row,
    const float* __restrict__ g_row, int N, int K, int D, Margin mg,
    float* __restrict__ gw) {
  constexpr int RM = kWBR / 16;
  constexpr int RN = kWBC / 16;
  __shared__ LogitTiles<kWBR, kWBC> tiles;
  __shared__ float es[kWBR][kWDC + 1];
  extern __shared__ float cs[];  // (rows, kWBC + 1)
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int c0 = blockIdx.x * kWBC;
  const int n_row_tiles = (N + kWBR - 1) / kWBR;
  constexpr int ldc = kWBC + 1;

  float acc[RM][RN];
  for (int rt = 0; rt < n_row_tiles; ++rt) {
    const int r0 = rt * kWBR;
    tile_logits<T, kWBR, kWBC>(emb, w, N, K, D, r0, c0, tiles, acc);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        cs[(r0 + ty + 16 * i) * ldc + tx + 16 * j] = coeff_at<T>(
            acc[i][j], r0 + ty + 16 * i, c0 + tx + 16 * j, N, K, labels,
            col_valid, m_row, d_row, g_row, mg);
  }
  __syncthreads();

  // gw[c0 + ty + 16i][d0 + tx + 16j] = Σ_r coeff[r][c]·emb[r][d]
  constexpr int GI = kWBC / 16;
  constexpr int GJ = kWDC / 16;
  for (int d0 = 0; d0 < D; d0 += kWDC) {
    float g[GI][GJ];
#pragma unroll
    for (int i = 0; i < GI; ++i)
#pragma unroll
      for (int j = 0; j < GJ; ++j) g[i][j] = 0.f;
    for (int rt = 0; rt < n_row_tiles; ++rt) {
      const int r0 = rt * kWBR;
      for (int e = tid; e < kWBR * kWDC; e += kThreads) {
        const int r = e / kWDC;
        const int dd = e - r * kWDC;
        const int gr = r0 + r;
        const int gd = d0 + dd;
        es[r][dd] = (gr < N && gd < D)
                        ? to_f32<T>(emb[static_cast<size_t>(gr) * D + gd])
                        : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kWBR; ++r) {
        float cv[GI];
        float ev[GJ];
#pragma unroll
        for (int i = 0; i < GI; ++i) cv[i] = cs[(r0 + r) * ldc + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < GJ; ++j) ev[j] = es[r][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < GI; ++i)
#pragma unroll
          for (int j = 0; j < GJ; ++j) g[i][j] = fmaf(cv[i], ev[j], g[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < GI; ++i) {
      const int c = c0 + ty + 16 * i;
      if (c >= K) continue;
#pragma unroll
      for (int j = 0; j < GJ; ++j) {
        const int dd = d0 + tx + 16 * j;
        if (dd < D) gw[static_cast<size_t>(c) * D + dd] = g[i][j];
      }
    }
  }
}

Margin make_margin(int kind, float s, float cos_m, float sin_m, float theta,
                   float sinmm, float m) {
  return Margin{kind, s, cos_m, sin_m, theta, sinmm, m};
}

bool bad_shape(int N, int K, int D, int dtype, int kind) {
  return N <= 0 || K <= 0 || D <= 0 || dtype < 0 || dtype > 1 || kind < 0 ||
         kind > 1;
}

// Opt in to `bytes` of dynamic shared memory: the default cap is 48 KB
// less the kernel's static shared memory.
cudaError_t allow_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t stats(const void* emb, const void* w, const int* labels,
                  const uint8_t* cv, int N, int K, int D, Margin mg,
                  int splits, float* partial, float* m, float* d, float* t,
                  cudaStream_t stream) {
  const int n_tiles = (K + kStatsBC - 1) / kStatsBC;
  const int per = (n_tiles + splits - 1) / splits;
  float* pm = partial;
  float* pd = pm + static_cast<size_t>(splits) * N;
  float* pt = pd + static_cast<size_t>(splits) * N;
  const dim3 grid((N + kStatsBR - 1) / kStatsBR, splits);
  margin_ce_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(emb), static_cast<const T*>(w), labels, cv, N, K,
      D, mg, per, pm, pd, pt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  margin_ce_merge_kernel<<<(N + 127) / 128, 128, 0, stream>>>(pm, pd, pt, N,
                                                            splits, m, d, t);
  return cudaGetLastError();
}

template <typename T>
cudaError_t grad_emb(const void* emb, const void* w, const int* labels,
                     const uint8_t* cv, const float* m, const float* d,
                     const float* g, int N, int K, int D, Margin mg,
                     int splits, float* partial, float* out,
                     cudaStream_t stream) {
  const size_t smem = sizeof(float) * kEmbBR * static_cast<size_t>(D);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(margin_ce_grad_emb_kernel<T>), smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (K + kEmbBC - 1) / kEmbBC;
  const int per = (n_tiles + splits - 1) / splits;
  const dim3 grid((N + kEmbBR - 1) / kEmbBR, splits);
  margin_ce_grad_emb_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(emb), static_cast<const T*>(w), labels, cv, m, d,
      g, N, K, D, mg, per, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t count = static_cast<size_t>(N) * D;
  split_sum_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0,
                     stream>>>(partial, count, splits, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t grad_w(const void* emb, const void* w, const int* labels,
                   const uint8_t* cv, const float* m, const float* d,
                   const float* g, int N, int K, int D, Margin mg, float* out,
                   cudaStream_t stream) {
  const int rows = (N + kWBR - 1) / kWBR * kWBR;
  const size_t smem = sizeof(float) * static_cast<size_t>(rows) * (kWBC + 1);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(margin_ce_grad_w_kernel<T>), smem);
  if (err != cudaSuccess) return err;
  margin_ce_grad_w_kernel<T><<<(K + kWBC - 1) / kWBC, kThreads, smem,
                               stream>>>(
      static_cast<const T*>(emb), static_cast<const T*>(w), labels, cv, m, d,
      g, N, K, D, mg, out);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (emb and w alike); kind: 0 = ArcFace,
// 1 = CosFace. labels int32 (N,), −1 for no target; col_valid uint8 (K,).
// partial: 3·splits·N floats of scratch. Writes m, d, t (N,) f32.
extern "C" int margin_ce_stats(const void* emb, const void* w,
                               const void* labels, const void* col_valid,
                               int N, int K, int D, int dtype, int kind,
                               float s, float cos_m, float sin_m, float theta,
                               float sinmm, float m, int splits,
                               void* partial, void* out_m, void* out_d,
                               void* out_t, void* stream) {
  if (bad_shape(N, K, D, dtype, kind) || splits <= 0 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Margin mg = make_margin(kind, s, cos_m, sin_m, theta, sinmm, m);
  auto* st = static_cast<cudaStream_t>(stream);
  auto* lab = static_cast<const int*>(labels);
  auto* cv = static_cast<const uint8_t*>(col_valid);
  auto* p = static_cast<float*>(partial);
  auto* om = static_cast<float*>(out_m);
  auto* od = static_cast<float*>(out_d);
  auto* ot = static_cast<float*>(out_t);
  if (dtype == 0)
    return stats<float>(emb, w, lab, cv, N, K, D, mg, splits, p, om, od, ot,
                        st);
  return stats<__nv_bfloat16>(emb, w, lab, cv, N, K, D, mg, splits, p, om, od,
                              ot, st);
}

// m, d, g: (N,) f32 from the forward (g already zero where p < 1e-30).
// partial: splits·N·D floats of scratch. Writes grad_emb (N, D) f32.
extern "C" int margin_ce_grad_emb(const void* emb, const void* w,
                                  const void* labels, const void* col_valid,
                                  const void* m_row, const void* d_row,
                                  const void* g_row, int N, int K, int D,
                                  int dtype, int kind, float s, float cos_m,
                                  float sin_m, float theta, float sinmm,
                                  float m, int splits, void* partial,
                                  void* out, void* stream) {
  if (bad_shape(N, K, D, dtype, kind) || splits <= 0 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Margin mg = make_margin(kind, s, cos_m, sin_m, theta, sinmm, m);
  auto* st = static_cast<cudaStream_t>(stream);
  auto* lab = static_cast<const int*>(labels);
  auto* cv = static_cast<const uint8_t*>(col_valid);
  auto* mr = static_cast<const float*>(m_row);
  auto* dr = static_cast<const float*>(d_row);
  auto* gr = static_cast<const float*>(g_row);
  auto* p = static_cast<float*>(partial);
  auto* o = static_cast<float*>(out);
  if (dtype == 0)
    return grad_emb<float>(emb, w, lab, cv, mr, dr, gr, N, K, D, mg, splits,
                           p, o, st);
  return grad_emb<__nv_bfloat16>(emb, w, lab, cv, mr, dr, gr, N, K, D, mg,
                                 splits, p, o, st);
}

// Writes grad_W (K, D) f32.
extern "C" int margin_ce_grad_w(const void* emb, const void* w,
                                const void* labels, const void* col_valid,
                                const void* m_row, const void* d_row,
                                const void* g_row, int N, int K, int D,
                                int dtype, int kind, float s, float cos_m,
                                float sin_m, float theta, float sinmm,
                                float m, void* out, void* stream) {
  if (bad_shape(N, K, D, dtype, kind))
    return static_cast<int>(cudaErrorInvalidValue);
  const Margin mg = make_margin(kind, s, cos_m, sin_m, theta, sinmm, m);
  auto* st = static_cast<cudaStream_t>(stream);
  auto* lab = static_cast<const int*>(labels);
  auto* cv = static_cast<const uint8_t*>(col_valid);
  auto* mr = static_cast<const float*>(m_row);
  auto* dr = static_cast<const float*>(d_row);
  auto* gr = static_cast<const float*>(g_row);
  auto* o = static_cast<float*>(out);
  if (dtype == 0)
    return grad_w<float>(emb, w, lab, cv, mr, dr, gr, N, K, D, mg, o, st);
  return grad_w<__nv_bfloat16>(emb, w, lab, cv, mr, dr, gr, N, K, D, mg, o,
                               st);
}
