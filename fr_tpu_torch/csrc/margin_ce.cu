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
// The tensor-core backward can also keep coeff at f32 as the sum of two
// bf16 terms (the plain route's contract; notes above those kernels).
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
// The results do not depend on the schedule. These first versions run the
// products as register-tiled f32 FMAs on the CUDA cores (16×16 threads, a
// small micro-tile each). For bf16 with D % 16 == 0, D ≤ 512, all three
// also have a tensor-core body (margin_ce_grad_emb_tc, margin_ce_grad_w_tc
// and margin_ce_stats_tc; their notes are above the kernels), which the
// wrapper picks; f32 and every other D keep the CUDA-core kernels.

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

// coeff of one element (_coeff_tile) from its row's m, d and g, rounded to
// T; valid: the element lies in the matrix and its column is valid.
template <typename T>
__device__ __forceinline__ float coeff_of(float raw, bool valid, bool onehot,
                                          float m, float d, float g,
                                          const Margin& mg) {
  const bool clamp_pass = raw >= -1.f && raw <= 1.f;
  if (!valid || !clamp_pass) return 0.f;
  const float z = fminf(fmaxf(raw, -1.f), 1.f);
  const float y = apply_margin(z, onehot, mg);
  const float p = expf(y - m) / d;
  const float dy = p - (onehot ? 1.f : 0.f);
  return round_to<T>(g * dy * margin_deriv(z, onehot, mg));
}

// coeff of one element, rounded to T; 0 outside the matrix.
template <typename T>
__device__ __forceinline__ float coeff_at(float raw, int row, int col, int N,
                                          int K, const int* labels,
                                          const uint8_t* col_valid,
                                          const float* m_row,
                                          const float* d_row,
                                          const float* g_row,
                                          const Margin& mg) {
  if (row >= N || col >= K || col_valid[col] == 0) return 0.f;
  return coeff_of<T>(raw, true, col == labels[row], m_row[row], d_row[row],
                     g_row[row], mg);
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

// One warp per row: merge the splits' (m, d, t) in split order. The lanes
// read 32 splits at a time and compute their scales exp(m_s − max); every
// lane then adds them up in split order (a split with m = −inf adds 0·0).
constexpr int kMergeRows = 4;  // rows (warps) per block
__global__ void margin_ce_merge_kernel(const float* __restrict__ pm,
                                       const float* __restrict__ pd,
                                       const float* __restrict__ pt, int N,
                                       int splits, float* __restrict__ m,
                                       float* __restrict__ d,
                                       float* __restrict__ t) {
  const int row = blockIdx.x * kMergeRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;  // the whole warp
  float mx = -INFINITY;
  for (int s = lane; s < splits; s += 32)
    mx = fmaxf(mx, pm[static_cast<size_t>(s) * N + row]);
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sd = 0.f;
  float st = 0.f;
  for (int s0 = 0; s0 < splits; s0 += 32) {
    const int s = s0 + lane;
    float scale = 0.f, ds = 0.f, ts = 0.f;
    if (s < splits) {
      const size_t o = static_cast<size_t>(s) * N + row;
      if (pm[o] != -INFINITY) {
        scale = expf(pm[o] - mx);
        ds = pd[o];
        ts = pt[o];
      }
    }
    const int n = min(32, splits - s0);
    for (int j = 0; j < n; ++j) {
      const float c = __shfl_sync(0xffffffffu, scale, j);
      sd = fmaf(__shfl_sync(0xffffffffu, ds, j), c, sd);
      st = fmaf(__shfl_sync(0xffffffffu, ts, j), c, st);
    }
  }
  if (lane == 0) {
    m[row] = mx;
    d[row] = sd;
    t[row] = st;
  }
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

// ---- the backward pair on the tensor cores (bf16) --------------------------
// margin_ce_grad_emb_tc_kernel replaces the TPU kernel of _bwd_rule's first
// pallas_call (fr_tpu/ops/fused_pfc.py:406, _bwd_emb_kernel) and
// margin_ce_grad_w_tc_kernel its second (:425, _bwd_w_kernel), on bf16
// operands with D a multiple of 16, at most 512; f32 and every other D keep
// the CUDA-core kernels above. The element arithmetic is theirs (coeff_of:
// apply_margin, margin_deriv, expf and the division, in that order); only
// the three products move to mma.sync.m16n8k16 bf16 → f32: the logits
// emb·Wᵀ with f32 sums, and coeff·W or coeffᵀ·emb from the bf16 coeff,
// which is exactly the A operand the mma takes.
//
// Coefficient terms (TERMS, a template argument the entries take as
// `terms`): with 1, coeff is rounded to bf16 before the products, as
// _bwd_jnp rounds it (use_fused's contract). With 2, the f32 coeff c goes
// in as hi = bf16(c) and lo = bf16(c − hi), both through the mma against
// the same bf16 tile into one f32 accumulator: the products carry about 16
// bits of c, and c − hi − lo is under 2⁻¹⁶·|c|. That is the plain route's
// contract (heads/partial_fc.py: coeff kept in f32, the f32 products
// rounded to bf16 where autograd meets the bf16 operands), which the
// wrapper does after the kernel. The second term costs a second coeff tile
// and a second mma per W (or emb) fragment.
//
// What bounds them: bytes. Each reads emb, W (bf16), the labels and
// col_valid once: 26.8 MB at the ms1m_arcface_122 head (N 128, D 512, K
// 26,007), 211.2 MB at webface42m's (K 205,952). grad_W also writes its
// (K, D) f32 result, its largest term: 53.3 MB and 421.8 MB, so 0.024 and
// 0.189 ms at 3.35 TB/s against grad_emb's 0.008 and 0.063; the 4·N·K·D
// flops take 0.007 and 0.055 ms at 989 TFLOP/s (6·N·K·D with two coeff
// terms).
//
// Design: a CTA of 8 warps keeps a 64 × D f32 accumulator in registers (D/4
// floats a thread at D 512), so one CTA an SM, and holds one operand's tile
// resident in shared memory while the other streams through two stages by
// 16-byte cp.async:
//   grad_emb: a 64-row tile of emb resident, a contiguous range of 64-class
//     tiles of W streamed (a split); for each class tile the logits by mma,
//     the bf16 coeff tile, and acc += coeff·W_tile from the W tile already
//     held, so W crosses from device memory once per row tile. The row
//     tiles of a split are neighbours in the grid, so the second read of a
//     W tile is an L2 hit. Each split writes its partial; split_sum_kernel
//     adds them in split order.
//   grad_W: a 64-class tile of W resident, the emb row tiles streamed;
//     acc += coeffᵀ·emb_tile, and the CTA writes its 64 rows of grad_W,
//     which it alone owns.
// Warp (wr, wc) of the 4 × 2 grid takes rows 16·wr.. and classes 32·wc.. of
// the logits; of the product, output rows 16·wr.. and the 16-wide D chunks
// ch ≡ wc (mod 2). Every tile row is D + 8 bf16 (an odd multiple of 16
// bytes), so ldmatrix reads it without bank conflicts. W·coeff reads W
// through ldmatrix.trans, coeffᵀ·emb reads the coeff tile and emb through
// it; no transposed copy goes to device memory. Rows past N and classes
// past K are zero in shared memory and have coeff 0. Every sum runs in a
// fixed order (D, then class tiles or row tiles, then splits), with no
// atomics: both results repeat bit for bit.
constexpr int kTcTile = 64;     // rows of a tile (emb rows or W classes)
constexpr int kTcMaxD = 512;    // the widest accumulator a CTA holds
constexpr int kTcThreads = 256;
constexpr int kTcChunks = kTcMaxD / 32;  // 16-wide D chunks per warp
constexpr int kTcLdc = kTcTile + 8;      // row stride of the coeff tile
constexpr int kTcCoeff = kTcTile * kTcLdc;  // elements of one coeff tile

using bf16 = __nv_bfloat16;

// Shared memory of either kernel: three (64, D + 8) bf16 tiles (the
// resident one and two stages) and a (64, 72) coeff tile per term. The
// Python wrapper computes the same size (fused_pfc.tc_smem_bytes).
__host__ __device__ inline size_t tc_smem_bytes(int D, int terms) {
  return 2 * (3 * static_cast<size_t>(kTcTile) * (D + 8) +
              static_cast<size_t>(terms) * kTcCoeff);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a·b, m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues the copies of rows [g0, g0 + 64) of the (rows, D) matrix src into
// the (64, D + 8) tile dst; rows past `rows` are zeroed.
__device__ __forceinline__ void tc_load_tile(bf16* dst, const bf16* src,
                                             int g0, int rows, int D) {
  const int cpr = D / 8;  // 16-byte copies per row
  for (int e = threadIdx.x; e < kTcTile * cpr; e += kTcThreads) {
    const int r = e / cpr;
    const int c = 8 * (e - r * cpr);
    bf16* d = dst + r * (D + 8) + c;
    if (g0 + r < rows)
      cp_async16(d, src + static_cast<size_t>(g0 + r) * D + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The warp's logits, 16 emb rows × 32 classes: raw[j] is the 16 × 8 tile of
// classes 32·wc + 8j, summed over D from the emb tile e and the W tile w.
__device__ __forceinline__ void tc_logits(float (&raw)[4][4], const bf16* e,
                                          const bf16* w, int wr, int wc,
                                          int D) {
  const int lane = threadIdx.x & 31;
  const int ld = D + 8;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    raw[j][0] = raw[j][1] = raw[j][2] = raw[j][3] = 0.f;
  const bf16* ap = e + (16 * wr + (lane & 15)) * ld + (lane >> 4) * 8;
  const bf16* bp = w + (32 * wc + (lane & 7) + ((lane >> 4) << 3)) * ld +
                   ((lane >> 3) & 1) * 8;
#pragma unroll 4
  for (int k = 0; k < D; k += 16) {
    uint32_t a[4], b0[4], b1[4];
    ldsm_x4(a, ap + k);
    ldsm_x4(b0, bp + k);
    ldsm_x4(b1, bp + 16 * ld + k);
    mma_bf16(raw[0], a, b0[0], b0[1]);
    mma_bf16(raw[1], a, b0[2], b0[3]);
    mma_bf16(raw[2], a, b1[0], b1[1]);
    mma_bf16(raw[3], a, b1[2], b1[3]);
  }
}

// One logit row of this thread (rows lane/4 and lane/4 + 8 of the warp's
// 16): what coeff_of needs of it.
struct TcRow {
  bool in;  // row < N
  int label;
  float m, d, g;
};

__device__ __forceinline__ TcRow tc_row(int row, int N, const int* labels,
                                        const float* m_row,
                                        const float* d_row,
                                        const float* g_row) {
  if (row >= N) return TcRow{false, -1, 0.f, 1.f, 0.f};
  return TcRow{true, labels[row], m_row[row], d_row[row], g_row[row]};
}

// The coeff of the warp's logits into the (64, 72) tile cs[row][class]
// (local row 16·wr + lane/4 + 8h, class 32·wc + 8j + 2·(lane % 4) + i),
// as bf16(c); with TERMS 2 also bf16(c − bf16(c)) into the tile after it
// (c − bf16(c) is exact in f32). bf16(c) of the f32 c is the bf16 that
// coeff_of<bf16> rounds to. c0 is the tile's first class.
template <int TERMS>
__device__ __forceinline__ void tc_coeff_tile(bf16* cs,
                                              const float (&raw)[4][4],
                                              const TcRow (&rows)[2], int c0,
                                              int K,
                                              const uint8_t* col_valid,
                                              int wr, int wc,
                                              const Margin& mg) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int lc = 32 * wc + 8 * j + 2 * (lane & 3);
    bool valid[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      valid[i] = c0 + lc + i < K && col_valid[c0 + lc + i] != 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const TcRow& r = rows[h];
      float v[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        v[i] = coeff_of<float>(raw[j][2 * h + i], r.in && valid[i],
                               c0 + lc + i == r.label, r.m, r.d, r.g, mg);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[0], v[1]);
      bf16* at = cs + (16 * wr + (lane >> 2) + 8 * h) * kTcLdc + lc;
      *reinterpret_cast<__nv_bfloat162*>(at) = hi;
      if (TERMS == 2)
        *reinterpret_cast<__nv_bfloat162*>(at + kTcCoeff) =
            __floats2bfloat162_rn(v[0] - __low2float(hi),
                                  v[1] - __high2float(hi));
    }
  }
}

// acc += A·B for the warp's output rows and D chunks ch = 2q + wc: A's
// 16 × 16 fragments a, one a term (k = 16·kk..), each against the same B
// fragment of the (64, D + 8) tile b read transposed (its rows are k).
template <int TERMS>
__device__ __forceinline__ void tc_times(float (&acc)[kTcChunks][2][4],
                                         const uint32_t (&a)[TERMS][4],
                                         const bf16* b, int kk, int wc,
                                         int D) {
  const int lane = threadIdx.x & 31;
  const int n_chunks = D / 16;
  const bf16* bp = b + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                           (D + 8) +
                   (lane >> 4) * 8;
#pragma unroll
  for (int q = 0; q < kTcChunks; ++q) {
    const int ch = 2 * q + wc;
    if (ch < n_chunks) {
      uint32_t f[4];
      ldsm_x4_t(f, bp + 16 * ch);
#pragma unroll
      for (int u = 0; u < TERMS; ++u) {
        mma_bf16(acc[q][0], a[u], f[0], f[1]);
        mma_bf16(acc[q][1], a[u], f[2], f[3]);
      }
    }
  }
}

// Writes the warp's accumulator: output rows out_row0 + 16·wr.. (those
// below `rows`) of the (·, D) f32 matrix out.
__device__ __forceinline__ void tc_store(const float (&acc)[kTcChunks][2][4],
                                         float* out, int out_row0, int rows,
                                         int wr, int wc, int D) {
  const int lane = threadIdx.x & 31;
  const int n_chunks = D / 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = out_row0 + 16 * wr + (lane >> 2) + 8 * h;
    if (row >= rows) continue;
    float* o = out + static_cast<size_t>(row) * D + 2 * (lane & 3);
#pragma unroll
    for (int q = 0; q < kTcChunks; ++q) {
      const int ch = 2 * q + wc;
      if (ch < n_chunks) {
#pragma unroll
        for (int t = 0; t < 2; ++t)
          *reinterpret_cast<float2*>(o + 16 * ch + 8 * t) =
              make_float2(acc[q][t][2 * h], acc[q][t][2 * h + 1]);
      }
    }
  }
}

// grid (row tiles, splits): split s takes class tiles [s·T/S, (s+1)·T/S)
// of the T tiles. Writes partial[split][row][d] for rows < N.
template <int TERMS>
__global__ void __launch_bounds__(kTcThreads, 1) margin_ce_grad_emb_tc_kernel(
    const bf16* __restrict__ emb, const bf16* __restrict__ w,
    const int* __restrict__ labels, const uint8_t* __restrict__ col_valid,
    const float* __restrict__ m_row, const float* __restrict__ d_row,
    const float* __restrict__ g_row, int N, int K, int D, Margin mg,
    float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int ld = D + 8;
  bf16* es = reinterpret_cast<bf16*>(tc_smem);
  bf16* ws = es + kTcTile * ld;  // two stages
  bf16* cs = ws + 2 * kTcTile * ld;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = warp >> 1;
  const int wc = warp & 1;
  const int r0 = blockIdx.x * kTcTile;
  const int n_tiles = (K + kTcTile - 1) / kTcTile;
  const int t_begin = static_cast<int>(
      static_cast<long long>(blockIdx.y) * n_tiles / gridDim.y);
  const int t_end = static_cast<int>(
      static_cast<long long>(blockIdx.y + 1) * n_tiles / gridDim.y);

  TcRow rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    rows[h] = tc_row(r0 + 16 * wr + (lane >> 2) + 8 * h, N, labels, m_row,
                     d_row, g_row);
  float acc[kTcChunks][2][4];
#pragma unroll
  for (int q = 0; q < kTcChunks; ++q)
#pragma unroll
    for (int t = 0; t < 2; ++t)
      acc[q][t][0] = acc[q][t][1] = acc[q][t][2] = acc[q][t][3] = 0.f;

  if (t_begin < t_end) {
    tc_load_tile(es, emb, r0, N, D);
    tc_load_tile(ws, w, t_begin * kTcTile, K, D);
    cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    const bf16* wt = ws + stage * kTcTile * ld;
    if (t + 1 < t_end) {
      tc_load_tile(ws + (stage ^ 1) * kTcTile * ld, w, (t + 1) * kTcTile, K,
                   D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float raw[4][4];
    tc_logits(raw, es, wt, wr, wc, D);
    tc_coeff_tile<TERMS>(cs, raw, rows, t * kTcTile, K, col_valid, wr, wc,
                         mg);
    __syncthreads();
    // acc += coeff·W_tile: A = coeff rows 16·wr.., k = the tile's classes
#pragma unroll
    for (int kk = 0; kk < kTcTile / 16; ++kk) {
      uint32_t a[TERMS][4];
#pragma unroll
      for (int u = 0; u < TERMS; ++u)
        ldsm_x4(a[u], cs + u * kTcCoeff + (16 * wr + (lane & 15)) * kTcLdc +
                          16 * kk + (lane >> 4) * 8);
      tc_times<TERMS>(acc, a, wt, kk, wc, D);
    }
    __syncthreads();  // the next tile overwrites cs and this stage's twin
  }
  tc_store(acc, partial + static_cast<size_t>(blockIdx.y) * N * D, r0, N, wr,
           wc, D);
}

// grid (class tiles): CTA c owns classes [64c, 64c + 64) of grad_W.
template <int TERMS>
__global__ void __launch_bounds__(kTcThreads, 1) margin_ce_grad_w_tc_kernel(
    const bf16* __restrict__ emb, const bf16* __restrict__ w,
    const int* __restrict__ labels, const uint8_t* __restrict__ col_valid,
    const float* __restrict__ m_row, const float* __restrict__ d_row,
    const float* __restrict__ g_row, int N, int K, int D, Margin mg,
    float* __restrict__ gw) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int ld = D + 8;
  bf16* ws = reinterpret_cast<bf16*>(tc_smem);
  bf16* es = ws + kTcTile * ld;  // two stages
  bf16* cs = es + 2 * kTcTile * ld;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = warp >> 1;
  const int wc = warp & 1;
  const int c0 = blockIdx.x * kTcTile;
  const int n_row_tiles = (N + kTcTile - 1) / kTcTile;

  float acc[kTcChunks][2][4];
#pragma unroll
  for (int q = 0; q < kTcChunks; ++q)
#pragma unroll
    for (int t = 0; t < 2; ++t)
      acc[q][t][0] = acc[q][t][1] = acc[q][t][2] = acc[q][t][3] = 0.f;

  tc_load_tile(ws, w, c0, K, D);
  tc_load_tile(es, emb, 0, N, D);
  cp_async_commit();
  for (int rt = 0; rt < n_row_tiles; ++rt) {
    const int stage = rt & 1;
    const bf16* et = es + stage * kTcTile * ld;
    if (rt + 1 < n_row_tiles) {
      tc_load_tile(es + (stage ^ 1) * kTcTile * ld, emb, (rt + 1) * kTcTile,
                   N, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    TcRow rows[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rows[h] = tc_row(rt * kTcTile + 16 * wr + (lane >> 2) + 8 * h, N,
                       labels, m_row, d_row, g_row);
    float raw[4][4];
    tc_logits(raw, et, ws, wr, wc, D);
    tc_coeff_tile<TERMS>(cs, raw, rows, c0, K, col_valid, wr, wc, mg);
    __syncthreads();
    // acc += coeffᵀ·emb_tile: A = coeffᵀ, classes 16·wr.. by the tile's
    // rows, read from cs[row][class] through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kTcTile / 16; ++kk) {
      uint32_t a[TERMS][4];
#pragma unroll
      for (int u = 0; u < TERMS; ++u)
        ldsm_x4_t(a[u], cs + u * kTcCoeff +
                            (16 * kk + (lane & 7) + ((lane >> 4) << 3)) *
                                kTcLdc +
                            16 * wr + ((lane >> 3) & 1) * 8);
      tc_times<TERMS>(acc, a, et, kk, wc, D);
    }
    __syncthreads();  // the next row tile overwrites cs and this stage's twin
  }
  tc_store(acc, gw, c0, K, wr, wc, D);
}

// ---- the forward statistics on the tensor cores (bf16) ---------------------
// margin_ce_stats_tc_kernel replaces the TPU kernel of _stats
// (fr_tpu/ops/fused_pfc.py:308, pallas_call :330, body _fwd_kernel) on bf16
// operands with D a multiple of 16, at most 512; f32 and every other D keep
// margin_ce_stats_kernel. The element arithmetic is that kernel's (the
// clamp, apply_margin, the −1e30 mask, expf); only the logit product moves
// to mma.sync.m16n8k16 bf16 → f32 (tc_logits64: the backward pair's
// tc_logits over a whole 64-class tile).
//
// What bounds it: bytes. It reads emb and W (bf16), the labels and
// col_valid once and writes m, d and t: 26.8 MB at the ms1m_arcface_122
// head (N 128, D 512, K 26,007) and 211.2 MB at webface42m's (K 205,952),
// 0.0080 and 0.0631 ms at 3.35 TB/s; the 2·N·K·D flops take 0.0034 and
// 0.027 ms at 989 TFLOP/s. So W must cross from device memory about once,
// and the logits must never go there. On the card the copies alone (no mma,
// no softmax) take about two thirds of the kernel's time, 2 µs a tile at
// webface42m (fr_tpu_torch/tools/ce_probe.py parts).
//
// Design: grad_emb_tc's grid and tiles without its accumulator and coeff
// tile, as a pipeline. A CTA holds a 64-row emb tile resident and streams
// its split's 64-class W tiles through two stages. One copy warp fills the
// stages by bulk copies (cp.async.bulk, a row each, completing on the
// stage's "full" mbarrier). The 8 compute warps are two groups of 4:
// group g owns stage g and the split's tiles g, g + 2, ...;
// its warp r takes rows 16r.. and all 64 classes of a tile. A group waits
// on its stage, runs the tile's mma, releases the stage on its "empty"
// mbarrier and then folds the logits into its softmax, so that the next
// copy into the stage and the other group's mma (shared memory and the
// tensor cores) run under that softmax (the CUDA cores and exp): no
// CTA-wide barrier per tile. The row tiles of a split
// are neighbours in the grid, so the second read of a W tile is an L2 hit.
// Each thread keeps an online softmax (m, d, t) in registers for its two
// rows over its own 16 columns of each of its group's tiles. At the end the
// 4 lanes of a quad merge by shuffles, group 1 hands its rows to group 0
// through shared memory, and the CTA writes the split's partial, which
// margin_ce_merge_kernel merges in split order. Every merge runs in a
// fixed order with no atomics, so m, d and t repeat bit for bit. A thread
// whose columns of a tile all lie past K skips that tile (its m would be
// −inf, and exp(−inf − (−inf)) is NaN), and a partial with m = −inf merges
// as empty; invalid columns are −1e30, finite, and count in d as they do
// in the plain version. Rows past N and classes past K are never copied:
// what shared memory holds there is never read into a result.
constexpr int kStatsGroupWarps = 4;                      // warps of a group
constexpr int kStatsWarps = 2 * kStatsGroupWarps;        // the compute warps
constexpr int kStatsThreads = 32 * (kStatsWarps + 1);    // and the copy warp

// Shared memory of margin_ce_stats_tc_kernel: three (64, D + 8) bf16 tiles
// (the resident one and two stages) and five mbarriers (full and empty of
// each stage, the emb tile's). The Python wrapper computes the same size
// (fused_pfc.stats_tc_smem_bytes).
__host__ __device__ inline size_t stats_tc_smem_bytes(int D) {
  return 2 * 3 * static_cast<size_t>(kTcTile) * (D + 8) +
         5 * sizeof(uint64_t);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrives on bar and adds `bytes` to the transfers it waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Copies `bytes` (a multiple of 16, both ends 16-byte aligned) from global
// src to shared dst; the transfer completes on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The copy warp's part: rows [g0, g0 + rows) of the (·, D) matrix src into
// the tile dst, a row a lane at a time, announced on bar by lane 0 first.
__device__ __forceinline__ void stats_copy_rows(bf16* dst, const bf16* src,
                                                int g0, int rows, int D,
                                                uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  const uint32_t row_bytes = 2u * static_cast<uint32_t>(D);
  if (lane == 0) mbar_expect_tx(bar, static_cast<uint32_t>(rows) * row_bytes);
  __syncwarp();
  for (int r = lane; r < rows; r += 32)
    bulk_copy(dst + r * (D + 8), src + static_cast<size_t>(g0 + r) * D,
              row_bytes, bar);
}

// Merges the statistics (mb, db, tb) of other columns of the same row into
// (m, d, t); m = −inf marks no column.
__device__ __forceinline__ void stats_merge(float& m, float& d, float& t,
                                            float mb, float db, float tb) {
  if (mb == -INFINITY) return;
  if (m == -INFINITY) {
    m = mb;
    d = db;
    t = tb;
    return;
  }
  const float mx = fmaxf(m, mb);
  const float sa = expf(m - mx);
  const float sb = expf(mb - mx);
  d = d * sa + db * sb;
  t = t * sa + tb * sb;
  m = mx;
}

// The warp's logits, 16 emb rows × all 64 classes of the tile: raw[j] is
// the 16 × 8 tile of classes 8j, summed over D from the emb tile e and the
// W tile w (tc_logits over both halves, the A fragment loaded once).
__device__ __forceinline__ void tc_logits64(float (&raw)[8][4], const bf16* e,
                                            const bf16* w, int wr, int D) {
  const int lane = threadIdx.x & 31;
  const int ld = D + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    raw[j][0] = raw[j][1] = raw[j][2] = raw[j][3] = 0.f;
  const bf16* ap = e + (16 * wr + (lane & 15)) * ld + (lane >> 4) * 8;
  const bf16* bp = w + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                   ((lane >> 3) & 1) * 8;
#pragma unroll 2
  for (int k = 0; k < D; k += 16) {
    uint32_t a[4];
    ldsm_x4(a, ap + k);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b[4];
      ldsm_x4(b, bp + 16 * p * ld + k);
      mma_bf16(raw[2 * p], a, b[0], b[1]);
      mma_bf16(raw[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// This thread's 16 columns of the 64-class tile at c0: class col0 +
// 8·(q/2) + q % 2 for q < 16, whether it lies before K and whether it is
// valid.
struct TcCols {
  int col0;
  bool in[16], valid[16];
};

__device__ __forceinline__ TcCols tc_cols(int c0, int K,
                                          const uint8_t* col_valid) {
  TcCols c;
  c.col0 = c0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int col = c.col0 + 8 * (q >> 1) + (q & 1);
    c.in[q] = col < K;
    c.valid[q] = c.in[q] && col_valid[col] != 0;
  }
  return c;
}

// Folds the warp's logits of one tile into this thread's running (m, d, t)
// of its two rows: raw[q/2][2h + q%2] is row h's logit at column q of c.
// apply_margin leaves every column but the label's at z·s, so only the
// thread that holds a row's label column takes its one-hot branch.
__device__ __forceinline__ void tc_stats_fold(const float (&raw)[8][4],
                                              const TcCols& c,
                                              const int (&label)[2],
                                              const Margin& mg, float (&m)[2],
                                              float (&d)[2], float (&t)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float y[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float z = fminf(fmaxf(raw[q >> 1][2 * h + (q & 1)], -1.f), 1.f);
      y[q] = !c.in[q]     ? -INFINITY  // past the last class: not a column
             : c.valid[q] ? apply_margin(z, false, mg)
                          : kMask;
    }
    const int lq = label[h] - c.col0;  // the label's offset 8·(q/2) + q%2
    if (lq >= 0 && lq < 64) {
#pragma unroll
      for (int q = 0; q < 16; ++q)
        if (lq == 8 * (q >> 1) + (q & 1) && c.valid[q])
          y[q] = apply_margin(
              fminf(fmaxf(raw[q >> 1][2 * h + (q & 1)], -1.f), 1.f), true,
              mg);
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int q = 0; q < 16; ++q) tmax = fmaxf(tmax, y[q]);
    if (tmax == -INFINITY) continue;  // every column of this thread is past K
    const float m_new = fmaxf(m[h], tmax);
    // exp(m − m_new): 0 while m is −inf, and exactly 1 where m holds
    const float alpha = m_new == m[h] ? 1.f : expf(m[h] - m_new);
    float se = 0.f;
    float st = 0.f;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float e = c.in[q] ? expf(y[q] - m_new) : 0.f;
      se += e;
      st += lq == 8 * (q >> 1) + (q & 1) ? e : 0.f;
    }
    d[h] = d[h] * alpha + se;
    t[h] = t[h] * alpha + st;
    m[h] = m_new;
  }
}

// grid (row tiles, splits): split s takes class tiles [s·T/S, (s+1)·T/S) of
// the T tiles. Writes the split's (m, d, t) partials for rows < N.
__global__ void __launch_bounds__(kStatsThreads, 1) margin_ce_stats_tc_kernel(
    const bf16* __restrict__ emb, const bf16* __restrict__ w,
    const int* __restrict__ labels, const uint8_t* __restrict__ col_valid,
    int N, int K, int D, Margin mg, float* __restrict__ pm,
    float* __restrict__ pd, float* __restrict__ pt) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int ld = D + 8;
  bf16* es = reinterpret_cast<bf16*>(tc_smem);
  bf16* ws = es + kTcTile * ld;  // two stages
  // full[s] = bars[s], empty[s] = bars[2 + s], the emb tile's = bars[4]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ws + 2 * kTcTile * ld);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kTcTile;
  const int n_tiles = (K + kTcTile - 1) / kTcTile;
  const int t_begin = static_cast<int>(
      static_cast<long long>(blockIdx.y) * n_tiles / gridDim.y);
  const int t_end = static_cast<int>(
      static_cast<long long>(blockIdx.y + 1) * n_tiles / gridDim.y);

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bars[s], 1);
      mbar_init(&bars[2 + s], 32 * kStatsGroupWarps);
    }
    mbar_init(&bars[4], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kStatsWarps) {
    // the copy warp: the emb tile, then tile t into stage t % 2 once its
    // group has released that stage's previous tile
    if (t_begin < t_end)
      stats_copy_rows(es, emb, r0, min(kTcTile, N - r0), D, &bars[4]);
    for (int tile = t_begin; tile < t_end; ++tile) {
      const int i = tile - t_begin;
      mbar_wait(&bars[2 + (i & 1)], ((i >> 1) & 1) ^ 1);
      stats_copy_rows(ws + (i & 1) * kTcTile * ld, w, tile * kTcTile,
                      min(kTcTile, K - tile * kTcTile), D, &bars[i & 1]);
    }
    return;
  }

  const int grp = warp / kStatsGroupWarps;  // its stage and tiles' parity
  const int wr = warp % kStatsGroupWarps;
  int label[2];
  float m[2], d[2], t[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 16 * wr + (lane >> 2) + 8 * h;
    label[h] = row < N ? labels[row] : -1;
    m[h] = -INFINITY;
    d[h] = t[h] = 0.f;
  }
  if (t_begin < t_end) mbar_wait(&bars[4], 0);
  // round k takes tile t_begin + 2k + grp, the k-th fill of stage grp
  for (int tile = t_begin + grp, k = 0; tile < t_end; tile += 2, ++k) {
    const TcCols c = tc_cols(tile * kTcTile, K, col_valid);
    mbar_wait(&bars[grp], k & 1);
    float raw[8][4];
    tc_logits64(raw, es, ws + grp * kTcTile * ld, wr, D);
    mbar_arrive(&bars[2 + grp]);  // this thread is done with the stage
    tc_stats_fold(raw, c, label, mg, m, d, t);
  }

  // the quad's 4 lanes hold the same two rows: merge them (every lane
  // shuffles, outside any per-lane condition)
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], o);
      const float dn = __shfl_xor_sync(0xffffffffu, d[h], o);
      const float tn = __shfl_xor_sync(0xffffffffu, t[h], o);
      stats_merge(m[h], d[h], t[h], mo, dn, tn);
    }
  // then group 0 takes over group 1's statistics of the same rows through
  // the (now idle) stage memory, (3, 64) floats; barrier 1 holds the
  // compute warps only
  float* xs = reinterpret_cast<float*>(ws);
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kStatsWarps) : "memory");
  if (grp == 1 && (lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = 16 * wr + (lane >> 2) + 8 * h;
      xs[lr] = m[h];
      xs[kTcTile + lr] = d[h];
      xs[2 * kTcTile + lr] = t[h];
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kStatsWarps) : "memory");
  if (grp == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = 16 * wr + (lane >> 2) + 8 * h;
      if (r0 + lr >= N) continue;
      stats_merge(m[h], d[h], t[h], xs[lr], xs[kTcTile + lr],
                  xs[2 * kTcTile + lr]);
      const size_t o = static_cast<size_t>(blockIdx.y) * N + r0 + lr;
      pm[o] = m[h];
      pd[o] = d[h];
      pt[o] = t[h];
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

// The tensor-core kernels take bf16 with D a multiple of 16, at most kTcMaxD.
bool tc_shape_ok(int N, int K, int D, int dtype, int kind) {
  return !bad_shape(N, K, D, dtype, kind) && dtype == 1 && D % 16 == 0 &&
         D <= kTcMaxD;
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
  margin_ce_merge_kernel<<<(N + kMergeRows - 1) / kMergeRows,
                           32 * kMergeRows, 0, stream>>>(pm, pd, pt, N, splits,
                                                         m, d, t);
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

template <int TERMS>
cudaError_t grad_emb_tc(const void* emb, const void* w, const int* labels,
                        const uint8_t* cv, const float* m, const float* d,
                        const float* g, int N, int K, int D, Margin mg,
                        int splits, float* partial, float* out,
                        cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(D, TERMS);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(margin_ce_grad_emb_tc_kernel<TERMS>),
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTcTile - 1) / kTcTile, splits);
  margin_ce_grad_emb_tc_kernel<TERMS><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(emb), static_cast<const bf16*>(w), labels, cv,
      m, d, g, N, K, D, mg, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t count = static_cast<size_t>(N) * D;
  split_sum_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0,
                     stream>>>(partial, count, splits, out);
  return cudaGetLastError();
}

cudaError_t stats_tc(const void* emb, const void* w, const int* labels,
                     const uint8_t* cv, int N, int K, int D, Margin mg,
                     int splits, float* partial, float* m, float* d, float* t,
                     cudaStream_t stream) {
  const size_t smem = stats_tc_smem_bytes(D);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(margin_ce_stats_tc_kernel), smem);
  if (err != cudaSuccess) return err;
  float* pm = partial;
  float* pd = pm + static_cast<size_t>(splits) * N;
  float* pt = pd + static_cast<size_t>(splits) * N;
  const dim3 grid((N + kTcTile - 1) / kTcTile, splits);
  margin_ce_stats_tc_kernel<<<grid, kStatsThreads, smem, stream>>>(
      static_cast<const bf16*>(emb), static_cast<const bf16*>(w), labels, cv,
      N, K, D, mg, pm, pd, pt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  margin_ce_merge_kernel<<<(N + kMergeRows - 1) / kMergeRows,
                           32 * kMergeRows, 0, stream>>>(pm, pd, pt, N, splits,
                                                         m, d, t);
  return cudaGetLastError();
}

// CTAs of `kernel` (`threads` a CTA, `smem` bytes of dynamic shared
// memory) that one SM holds at once (the occupancy API), or the negated
// CUDA error.
int tc_occupancy(const void* kernel, int threads, size_t smem) {
  cudaError_t err = allow_smem(kernel, smem);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                        threads, smem);
  return err == cudaSuccess ? ctas : -static_cast<int>(err);
}

template <int TERMS>
cudaError_t grad_w_tc(const void* emb, const void* w, const int* labels,
                      const uint8_t* cv, const float* m, const float* d,
                      const float* g, int N, int K, int D, Margin mg,
                      float* out, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(D, TERMS);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(margin_ce_grad_w_tc_kernel<TERMS>), smem);
  if (err != cudaSuccess) return err;
  margin_ce_grad_w_tc_kernel<TERMS><<<(K + kTcTile - 1) / kTcTile, kTcThreads,
                                      smem, stream>>>(
      static_cast<const bf16*>(emb), static_cast<const bf16*>(w), labels, cv,
      m, d, g, N, K, D, mg, out);
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

// The tensor-core twins of margin_ce_grad_emb and margin_ce_grad_w: the
// same arguments and the number of coeff terms (1 or 2, see the notes
// above the kernels), bf16 only (dtype 1), D a multiple of 16 and at most
// 512; emb and w 16-byte aligned. grad_emb's partial: splits·N·D floats,
// split s taking class tiles [s·T/S, (s+1)·T/S) of the T = ⌈K/64⌉.
extern "C" int margin_ce_grad_emb_tc(const void* emb, const void* w,
                                     const void* labels,
                                     const void* col_valid, const void* m_row,
                                     const void* d_row, const void* g_row,
                                     int N, int K, int D, int dtype, int kind,
                                     float s, float cos_m, float sin_m,
                                     float theta, float sinmm, float m,
                                     int splits, void* partial, void* out,
                                     int terms, void* stream) {
  if (!tc_shape_ok(N, K, D, dtype, kind) || splits <= 0 || splits > 65535 ||
      terms < 1 || terms > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* launch = terms == 1 ? grad_emb_tc<1> : grad_emb_tc<2>;
  return launch(emb, w, static_cast<const int*>(labels),
                static_cast<const uint8_t*>(col_valid),
                static_cast<const float*>(m_row),
                static_cast<const float*>(d_row),
                static_cast<const float*>(g_row), N, K, D,
                make_margin(kind, s, cos_m, sin_m, theta, sinmm, m),
                splits, static_cast<float*>(partial),
                static_cast<float*>(out),
                static_cast<cudaStream_t>(stream));
}

extern "C" int margin_ce_grad_w_tc(const void* emb, const void* w,
                                   const void* labels, const void* col_valid,
                                   const void* m_row, const void* d_row,
                                   const void* g_row, int N, int K, int D,
                                   int dtype, int kind, float s, float cos_m,
                                   float sin_m, float theta, float sinmm,
                                   float m, void* out, int terms,
                                   void* stream) {
  if (!tc_shape_ok(N, K, D, dtype, kind) || terms < 1 || terms > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* launch = terms == 1 ? grad_w_tc<1> : grad_w_tc<2>;
  return launch(emb, w, static_cast<const int*>(labels),
                static_cast<const uint8_t*>(col_valid),
                static_cast<const float*>(m_row),
                static_cast<const float*>(d_row),
                static_cast<const float*>(g_row), N, K, D,
                make_margin(kind, s, cos_m, sin_m, theta, sinmm, m),
                static_cast<float*>(out),
                static_cast<cudaStream_t>(stream));
}

// CTAs of margin_ce_grad_emb_tc_kernel with `terms` coeff terms that one
// SM holds at once at this D (the occupancy API; the wrapper sizes the
// splits to one wave of them), or the negated CUDA error.
extern "C" int margin_ce_grad_emb_tc_occupancy(int D, int terms) {
  if (D <= 0 || D % 16 != 0 || D > kTcMaxD || terms < 1 || terms > 2)
    return -static_cast<int>(cudaErrorInvalidValue);
  return tc_occupancy(
      terms == 1
          ? reinterpret_cast<const void*>(margin_ce_grad_emb_tc_kernel<1>)
          : reinterpret_cast<const void*>(margin_ce_grad_emb_tc_kernel<2>),
      kTcThreads, tc_smem_bytes(D, terms));
}

// The tensor-core twin of margin_ce_stats: the same arguments, bf16 only
// (dtype 1), D a multiple of 16 and at most 512; emb and w 16-byte aligned.
// partial: 3·splits·N floats, split s taking class tiles [s·T/S, (s+1)·T/S)
// of the T = ⌈K/64⌉.
extern "C" int margin_ce_stats_tc(const void* emb, const void* w,
                                  const void* labels, const void* col_valid,
                                  int N, int K, int D, int dtype, int kind,
                                  float s, float cos_m, float sin_m,
                                  float theta, float sinmm, float m,
                                  int splits, void* partial, void* out_m,
                                  void* out_d, void* out_t, void* stream) {
  if (!tc_shape_ok(N, K, D, dtype, kind) || splits <= 0 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return stats_tc(emb, w, static_cast<const int*>(labels),
                  static_cast<const uint8_t*>(col_valid), N, K, D,
                  make_margin(kind, s, cos_m, sin_m, theta, sinmm, m), splits,
                  static_cast<float*>(partial), static_cast<float*>(out_m),
                  static_cast<float*>(out_d), static_cast<float*>(out_t),
                  static_cast<cudaStream_t>(stream));
}

// CTAs of margin_ce_stats_tc_kernel that one SM holds at once at this D, or
// the negated CUDA error.
extern "C" int margin_ce_stats_tc_occupancy(int D) {
  if (D <= 0 || D % 16 != 0 || D > kTcMaxD)
    return -static_cast<int>(cudaErrorInvalidValue);
  return tc_occupancy(
      reinterpret_cast<const void*>(margin_ce_stats_tc_kernel),
      kStatsThreads, stats_tc_smem_bytes(D));
}
