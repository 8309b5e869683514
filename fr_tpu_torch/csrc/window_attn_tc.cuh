// The bf16 forward and recompute backward of cosine window attention on
// Hopper's tensor cores (rows 1, 2, 5, 6, 15, 16, 17 and 17b of ROADMAP §2),
// shared by window_attn_fwd.cu, window_attn_bwd.cu and window_attn_spatial.cu
// and templated on the row layout (WindowRows, SpatialRows). The math is the
// CUDA-core kernels' (window_attn_fwd.cu and window_attn_bwd.cu state it):
// every product takes bf16 operands rounded where fr_tpu rounds them (q̂ and
// k̂ after the f32 L2-norm, p, g, ds·scale) and sums in f32, which is the
// contract of mma.sync.m16n8k16 bf16 → f32. Only the order of the f32 sums
// inside a product differs from the CUDA-core kernels.
//
// Design:
//  - A CTA holds one head h and walks a run of windows (TcPlan): the windows
//    of one mask slice when there is a mask, so that bias16[h] and the mask
//    slice are staged in shared memory once per CTA, not once per window.
//    The wrapper makes the runs as short as keeps the grid within one wave
//    of the CTAs the card holds (window_attn_tc_occupancy_entry).
//  - A window's N tokens are padded to NP = 16·NT rows and the head dim to
//    HDP = 16·DT columns. The CTA has NT warps. Warp i owns query rows
//    16i..16i+15 for the scores, the softmax and the products along them,
//    and in the backward also key rows 16i..16i+15 for dv and dk̂. Scores
//    and p stay in registers as accumulator fragments, which are also the
//    A operands of the next product; the softmax max is taken per head and
//    per row with quad shuffles (the fix for fr_tpu's shared-max fault).
//  - Token tiles are bf16 with a row stride of HDP + 8 elements, an odd
//    multiple of 16 bytes, so ldmatrix reads them without bank conflicts.
//    Rows past N are not stored: their ldmatrix addresses point at a
//    shared zero row. Columns past hd are zero from the start.
//  - The next window's q, k, v (and g) land by cp.async in the second of two
//    stages while the current window computes: 16-byte copies where every
//    row and head offset is 16-byte aligned, else 4-byte ones (EffiAlter_m's
//    head dim 38 puts head h at byte 76·h). TMA is not used: SpatialRows is
//    not a box.
//  - The backward keeps its dbias and dscale sums in registers over the
//    CTA's windows, in window order, and writes one partial per CTA;
//    window_sum_kernel then adds the CTAs in a fixed order, so the sums are
//    the same bits on every run.
// mma.sync and not wgmma: wgmma's 64-row warpgroup tile fits N = 49 but
// wastes most of itself at N = 9 and 36, and these kernels are bound by
// latency and bytes, not by the tensor cores' issue rate.
// Everything sits in an anonymous namespace, so each source that includes
// it gets its own copy.

#pragma once

#include <cstdint>
#include <initializer_list>

#include "window_attn_common.cuh"

namespace {

constexpr int kTcMaxTiles = 4;  // NP and HDP are at most 4 tiles of 16

// The windows of CTA c of a head: the mask slices are G (n_win_per_img
// with a mask, else 1) and each holds R windows w = r·G + j (r = image,
// j = slice); a slice's windows go in runs of wpc to ipc = ⌈R / wpc⌉ CTAs.
// CTA c takes slice j = c / ipc and r = (c mod ipc)·wpc + s for
// s < min(wpc, R − (c mod ipc)·wpc). The Python wrapper computes the same
// plan (fused_window_attn.py, tensor_core_plan).
struct TcPlan {
  long long R;
  long long ipc;
  int G;
  int wpc;
};

inline TcPlan tc_plan(long long n_windows, int n_win_per_img, bool masked,
                      int wpc) {
  TcPlan p;
  p.G = masked ? n_win_per_img : 1;
  p.R = n_windows / p.G;
  p.wpc = wpc;
  p.ipc = (p.R + wpc - 1) / wpc;
  return p;
}

__host__ __device__ inline int tc_tiles(int n) { return (n + 15) / 16; }

// bf16 row stride of a token tile (HDP + 8) and of an NP × NP tile (NP + 8),
// f32 row stride of the bias and mask tiles (NP + 8): odd multiples of 16
// bytes for ldmatrix, conflict-free float2 reads at the accumulator
// positions for the bias.
__host__ __device__ inline int tc_ld(int hd) { return 16 * tc_tiles(hd) + 8; }

// The bias (and mask) tiles, (N, NP + 8) f32 each.
__host__ __device__ inline int tc_bias_floats(int N, int NP, bool masked) {
  return N * (NP + 8) * (masked ? 2 : 1);
}

// Shared memory of the forward and the backward, in bytes. The Python
// wrapper computes the same sizes (_tc_smem_bytes).
inline size_t tc_fwd_smem_bytes(int N, int hd, bool masked) {
  const int np = 16 * tc_tiles(N);
  const size_t ld = tc_ld(hd);
  return 4 * static_cast<size_t>(tc_bias_floats(N, np, masked)) +
         2 * (ld + 6 * N * ld);
}

inline size_t tc_bwd_smem_bytes(int N, int hd, bool masked) {
  const int np = 16 * tc_tiles(N);
  const size_t ld = tc_ld(hd);
  return 4 * (static_cast<size_t>(tc_bias_floats(N, np, masked)) + 4 * np +
              32) +
         2 * (ld + 10 * N * ld + 2 * static_cast<size_t>(np) * (np + 8));
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

// Two f32 values rounded to bf16 (round to nearest even, as round_to),
// the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src);
template <>
__device__ __forceinline__ void cp_async<16>(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
template <>
__device__ __forceinline__ void cp_async<4>(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Which copies a thread issues: a token row of one matrix is cpr = 2·hd/vec
// copies, and the threads cover rows_per_pass rows at a time.
struct TcCopier {
  int vec, t_row, t_ch, rows_per_pass;
  __device__ TcCopier(int hd, int vec_) : vec(vec_) {
    const int cpr = 2 * hd / vec;
    t_row = threadIdx.x / cpr;
    t_ch = threadIdx.x - t_row * cpr;
    rows_per_pass = blockDim.x / cpr;
  }
};

// Issues the copies of the raw q, k, v (and g when not null) of head h of
// window w into one stage: (N, ld) tiles q, k, v, g in that order. A token's
// row address is computed once for its q, k, v and g.
template <typename Rows>
__device__ __forceinline__ void tc_stage(__nv_bfloat16* dst,
                                         const __nv_bfloat16* __restrict__ qkv,
                                         const __nv_bfloat16* __restrict__ g,
                                         int N, int C, int hd, int ld,
                                         const TcCopier& cp, long long w,
                                         int h, const Rows& rows) {
  if (cp.t_row >= cp.rows_per_pass) return;
  const int e = cp.t_ch * (cp.vec / 2);
  const size_t head_off = static_cast<size_t>(h) * hd + e;
  const int tile = N * ld;
  for (int n = cp.t_row; n < N; n += cp.rows_per_pass) {
    const size_t row = rows.row(w, n);
    const __nv_bfloat16* src = qkv + row * 3 * C + head_off;
    __nv_bfloat16* d = dst + n * ld + e;
    if (cp.vec == 16) {
      cp_async<16>(d, src);
      cp_async<16>(d + tile, src + C);
      cp_async<16>(d + 2 * tile, src + 2 * C);
      if (g != nullptr) cp_async<16>(d + 3 * tile, g + row * C + head_off);
    } else {
      cp_async<4>(d, src);
      cp_async<4>(d + tile, src + C);
      cp_async<4>(d + 2 * tile, src + 2 * C);
      if (g != nullptr) cp_async<4>(d + 3 * tile, g + row * C + head_off);
    }
  }
}

// bias16[h] (and the mask slice) into (N, NP + 8) f32 tiles: the padded key
// columns are −∞ in the bias (they drop out of the softmax) and 0 in the
// mask. Rows past N are not stored: the softmax reads row N − 1 for them and
// zeroes their p.
__device__ __forceinline__ void tc_stage_bias(float* bias_s, float* mask_s,
                                              const float* __restrict__ bias,
                                              const float* __restrict__ mask,
                                              int N, int NP) {
  const int ldb = NP + 8;
  for (int i = threadIdx.x; i < N * NP; i += blockDim.x) {
    const int r = i / NP;
    const int c = i - r * NP;
    bias_s[r * ldb + c] = c < N ? bias[r * N + c] : -INFINITY;
    if (mask_s != nullptr) mask_s[r * ldb + c] = c < N ? mask[r * N + c] : 0.f;
  }
}

// Zeroes n16 16-byte words from p on.
__device__ __forceinline__ void tc_zero(void* p, int n16) {
  uint4* q = static_cast<uint4*>(p);
  for (int i = threadIdx.x; i < n16; i += blockDim.x)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Inverse L2 norms of the q and k rows (2N rows, one thread a row, the
// squares summed in f32 in channel order as the CUDA-core kernels sum
// them), q̂ = round(q·r) and k̂ = round(k·r) into qn, kn (which may be q, k
// themselves: a thread rewrites only its own row). With rn not null, also
// the norms and active flags (Σx² > eps²), q rows first. The rows go to the
// CTA's threads, or with tid ≥ 0 to the nthreads threads of a window lane
// (window_attn_qkv.cu), tid being the thread's index among them. The loop
// steps in unsigned arithmetic, as threadIdx and blockDim do, so that the
// default compiles to the same instructions as a loop over them.
__device__ __forceinline__ void tc_normalize(
    const __nv_bfloat16* q, const __nv_bfloat16* k, __nv_bfloat16* qn,
    __nv_bfloat16* kn, float* rn, float* act, int N, int hd, int ld,
    int tid = -1, unsigned nthreads = 0) {
  const int npairs = hd / 2;
  const unsigned first = tid < 0 ? threadIdx.x : static_cast<unsigned>(tid);
  const unsigned stride = tid < 0 ? blockDim.x : nthreads;
  for (int rr = first; rr < 2 * N; rr += stride) {
    const bool isq = rr < N;
    const int r = isq ? rr : rr - N;
    const __nv_bfloat162* x =
        reinterpret_cast<const __nv_bfloat162*>((isq ? q : k) + r * ld);
    __nv_bfloat162* y =
        reinterpret_cast<__nv_bfloat162*>((isq ? qn : kn) + r * ld);
    float s2 = 0.f;
    for (int pi = 0; pi < npairs; ++pi) {
      const float2 v = __bfloat1622float2(x[pi]);
      s2 = fmaf(v.x, v.x, s2);
      s2 = fmaf(v.y, v.y, s2);
    }
    const float rs = rsqrtf(fmaxf(s2, kEps2));
    for (int pi = 0; pi < npairs; ++pi) {
      const float2 v = __bfloat1622float2(x[pi]);
      y[pi] = __floats2bfloat162_rn(v.x * rs, v.y * rs);
    }
    if (rn != nullptr) {
      rn[rr] = rs;
      act[rr] = s2 > kEps2 ? 1.f : 0.f;
    }
  }
}

// acc = X·Yᵀ over the head dim for the warp's 16 rows of X (row0 =
// 16·warp): 2·NT accumulator tiles of 16 × 8 (s_raw = q̂·k̂ᵀ, dp = g·vᵀ).
// Rows of X and Y past N read the zero row.
template <int NT, int DT>
__device__ __forceinline__ void tc_scores(float (&acc)[2 * NT][4],
                                          const __nv_bfloat16* x,
                                          const __nv_bfloat16* y,
                                          const __nv_bfloat16* zero_row,
                                          int row0, int N, int ld) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int ar = row0 + (lane & 15);
  const __nv_bfloat16* ap =
      (ar < N ? x + ar * ld : zero_row) + (lane >> 4) * 8;
  const int koff = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, ap + 16 * kk);
#pragma unroll
    for (int j = 0; j < 2 * NT; j += 2) {
      const int key = 8 * j + (lane & 7) + ((lane >> 4) << 3);
      uint32_t b[4];
      ldsm_x4(b, (key < N ? y + key * ld : zero_row) + 16 * kk + koff);
      mma_bf16(acc[j], a, b[0], b[1]);
      mma_bf16(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 × HDP) += A·B for the warp: A is the 16 × NP bf16 operand given
// as register fragments (a[kk] for keys 16kk..16kk+15), B the (NP, HDP)
// token tile b (rows past N read the zero row), read transposed.
template <int NT, int DT>
__device__ __forceinline__ void tc_times_tile(float (&acc)[2 * DT][4],
                                              const uint32_t (&a)[NT][4],
                                              const __nv_bfloat16* b,
                                              const __nv_bfloat16* zero_row,
                                              int N, int ld) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    const int key = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
    const __nv_bfloat16* bp =
        (key < N ? b + key * ld : zero_row) + (lane >> 4) * 8;
#pragma unroll
    for (int nd = 0; nd < 2 * DT; nd += 2) {
      uint32_t f[4];
      ldsm_x4_t(f, bp + 8 * nd);
      mma_bf16(acc[nd], a[kk], f[0], f[1]);
      mma_bf16(acc[nd + 1], a[kk], f[2], f[3]);
    }
  }
}

// The A fragments of Xᵀ for key rows 16·kt.. from an (NP, NP + 8) bf16 tile
// X[query][key]: a[kk] holds queries 16kk..16kk+15.
template <int NT>
__device__ __forceinline__ void tc_load_transposed(uint32_t (&a)[NT][4],
                                                   const __nv_bfloat16* x,
                                                   int kt) {
  const int lane = threadIdx.x & 31;
  const int ldp = 16 * NT + 8;
  const int col = 16 * kt + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    const int q = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
    ldsm_x4_t(a[kk], x + q * ldp + col);
  }
}

// The accumulator tiles as the A operand of the next product, rounded to
// bf16: tiles 2kk and 2kk+1 (16 columns) make the operand's k-step kk.
template <int NT>
__device__ __forceinline__ void tc_to_operand(uint32_t (&a)[NT][4],
                                              const float (&x)[2 * NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// Scores → f32 softmax, per head and per row: s = s_raw·sc + bias (+ mask)
// at the accumulator positions (rows row0 + g and row0 + g + 8, columns
// 8j + 2t, +1), max and sum over the row's quad, expf and a division as in
// the CUDA-core kernels. Rows past N get p = 0.
template <int NT>
__device__ __forceinline__ void tc_softmax(float (&p)[2 * NT][4],
                                           const float (&s_raw)[2 * NT][4],
                                           const float* bias_s,
                                           const float* mask_s, float sc,
                                           int row0, int N) {
  const int lane = threadIdx.x & 31;
  const int r0 = row0 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const int ldb = 16 * NT + 8;
  const float* b0r = bias_s + min(r0, N - 1) * ldb + c0;
  const float* b1r = bias_s + min(r0 + 8, N - 1) * ldb + c0;
  const float* m0r = mask_s != nullptr ? mask_s + min(r0, N - 1) * ldb + c0
                                       : nullptr;
  const float* m1r =
      mask_s != nullptr ? mask_s + min(r0 + 8, N - 1) * ldb + c0 : nullptr;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    const float2 b0 = *reinterpret_cast<const float2*>(b0r + 8 * j);
    const float2 b1 = *reinterpret_cast<const float2*>(b1r + 8 * j);
    p[j][0] = s_raw[j][0] * sc + b0.x;
    p[j][1] = s_raw[j][1] * sc + b0.y;
    p[j][2] = s_raw[j][2] * sc + b1.x;
    p[j][3] = s_raw[j][3] * sc + b1.y;
    if (mask_s != nullptr) {
      const float2 k0 = *reinterpret_cast<const float2*>(m0r + 8 * j);
      const float2 k1 = *reinterpret_cast<const float2*>(m1r + 8 * j);
      p[j][0] += k0.x;
      p[j][1] += k0.y;
      p[j][2] += k1.x;
      p[j][3] += k1.y;
    }
    m0 = fmaxf(m0, fmaxf(p[j][0], p[j][1]));
    m1 = fmaxf(m1, fmaxf(p[j][2], p[j][3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    p[j][0] = expf(p[j][0] - m0);
    p[j][1] = expf(p[j][1] - m0);
    p[j][2] = expf(p[j][2] - m1);
    p[j][3] = expf(p[j][3] - m1);
    l0 += p[j][0] + p[j][1];
    l1 += p[j][2] + p[j][3];
  }
  l0 = quad_sum(l0);  // every lane of the quad takes part in the shuffles
  l1 = quad_sum(l1);
  const bool in0 = r0 < N, in1 = r0 + 8 < N;
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    p[j][0] = in0 ? p[j][0] / l0 : 0.f;
    p[j][1] = in0 ? p[j][1] / l0 : 0.f;
    p[j][2] = in1 ? p[j][2] / l1 : 0.f;
    p[j][3] = in1 ? p[j][3] / l1 : 0.f;
  }
}

// Writes a 16 × HDP accumulator (rows row0 + g, +8; columns 8nd + 2t, +1)
// to dst[rows.row(w, r)·stride + col0 + d] for rows r < N and d < hd, two
// values at a time (hd is even), as bf16 (dst_bf16) or f32.
template <int DT, typename Rows>
__device__ __forceinline__ void tc_store_rows(const float (&acc)[2 * DT][4],
                                              void* __restrict__ dst,
                                              bool dst_bf16, size_t stride,
                                              size_t col0, int row0, int N,
                                              int hd, long long w,
                                              const Rows& rows) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + (lane >> 2) + 8 * half;
    if (r >= N) continue;
    const size_t base = rows.row(w, r) * stride + col0;
#pragma unroll
    for (int nd = 0; nd < 2 * DT; ++nd) {
      const int d = 8 * nd + 2 * (lane & 3);
      if (d < hd) {
        const float x = acc[nd][2 * half], y = acc[nd][2 * half + 1];
        if (dst_bf16)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(dst) + base + d) =
              __floats2bfloat162_rn(x, y);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(dst) + base + d) =
              make_float2(x, y);
      }
    }
  }
}

// The L2-norm backward of the warp's 16 rows (row0..): with x̂ = raw·r in
// f32 (raw from the stage tile), dx = r·(dx̂ − act·x̂·rowsum(dx̂∘x̂)),
// overwriting dxn. rn, act: the rows' norms and flags.
template <int DT>
__device__ __forceinline__ void tc_norm_backward(float (&dxn)[2 * DT][4],
                                                 const __nv_bfloat16* raw,
                                                 const float* rn,
                                                 const float* act, int row0,
                                                 int N, int hd, int ld) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + (lane >> 2) + 8 * half;
    const bool in = r < N;
    const float rr = in ? rn[r] : 0.f;
    const float aa = in ? act[r] : 0.f;
    float x[2 * DT][2];
    float t = 0.f;
#pragma unroll
    for (int nd = 0; nd < 2 * DT; ++nd) {
      const int d = 8 * nd + 2 * (lane & 3);
      float2 v = make_float2(0.f, 0.f);
      if (in && d < hd)
        v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(raw + r * ld + d));
      x[nd][0] = v.x * rr;
      x[nd][1] = v.y * rr;
      t = fmaf(dxn[nd][2 * half], x[nd][0], t);
      t = fmaf(dxn[nd][2 * half + 1], x[nd][1], t);
    }
    t = quad_sum(t);
#pragma unroll
    for (int nd = 0; nd < 2 * DT; ++nd) {
      dxn[nd][2 * half] = rr * (dxn[nd][2 * half] - aa * x[nd][0] * t);
      dxn[nd][2 * half + 1] =
          rr * (dxn[nd][2 * half + 1] - aa * x[nd][1] * t);
    }
  }
}

// The row-2 kernel's hooks of tc_bwd_window and tc_store_partial: the
// CTA's barrier, and no column sums. The entry-fused backward
// (window_attn_qkv.cu) gives its window lane's barrier and sums dq, dk and
// dv by column into its db.
struct TcCtaSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
struct TcNoColSum {
  template <typename Acc>
  __device__ __forceinline__ void operator()(const Acc&, int) const {}
};

// One window of the recompute backward, once q̂, k̂ and the norms are in
// place, for the warp's rows (row0 = 16·warp; r0, c0 the thread's first
// accumulator row and column): for queries row0..: the scores, p (round(p)
// to the P tile pt), dp = g·vᵀ, ds, its dbias and dscale sums,
// round(ds·scale) (to the dsc tile dt and as the A operand of
// dq̂ = dsc·k̂), dq; then, after sync() (the barrier of the warps that
// share pt and dt), for keys row0..: dv = round(p)ᵀ·g and dk̂ = dscᵀ·q̂,
// dk. dq, dk and dv go to dqkv (rows, 3C) as bf16, each after colsum(acc,
// m) has seen it in f32 (m = 0, 1, 2 for q, k, v). qs, ks, vs, gs: the
// window's raw q, k, v and g tiles.
template <int NT, int DT, typename Rows, typename Sync = TcCtaSync,
          typename ColSum = TcNoColSum>
__device__ __forceinline__ void tc_bwd_window(
    float (&dbias)[2 * NT][4], float& dscale, const __nv_bfloat16* qs,
    const __nv_bfloat16* ks, const __nv_bfloat16* vs,
    const __nv_bfloat16* gs, const __nv_bfloat16* qn,
    const __nv_bfloat16* kn, __nv_bfloat16* pt, __nv_bfloat16* dt,
    const __nv_bfloat16* zero_row, const float* rn, const float* act,
    const float* bias_s, const float* mask_s, float sc,
    __nv_bfloat16* dqkv, int C, size_t C3, size_t head_off, int warp,
    int row0, int r0, int c0, int N, int hd, long long w, const Rows& rows,
    Sync sync = Sync(), ColSum colsum = ColSum()) {
  constexpr int LDP = 16 * NT + 8;
  constexpr int ld = 16 * DT + 8;
  {  // queries row0..row0+15
    float s_raw[2 * NT][4];
    tc_scores<NT, DT>(s_raw, qn, kn, zero_row, row0, N, ld);
    float p[2 * NT][4];
    tc_softmax<NT>(p, s_raw, bias_s, mask_s, sc, row0, N);
#pragma unroll
    for (int jj = 0; jj < 2 * NT; ++jj) {
      const int c = 8 * jj + c0;
      *reinterpret_cast<uint32_t*>(pt + r0 * LDP + c) =
          pack_bf16(p[jj][0], p[jj][1]);
      *reinterpret_cast<uint32_t*>(pt + (r0 + 8) * LDP + c) =
          pack_bf16(p[jj][2], p[jj][3]);
    }
    float ds[2 * NT][4];  // dp = g·vᵀ, then ds
    tc_scores<NT, DT>(ds, gs, vs, zero_row, row0, N, ld);
    float t0 = 0.f, t1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < 2 * NT; ++jj) {
      t0 = fmaf(ds[jj][0], p[jj][0], fmaf(ds[jj][1], p[jj][1], t0));
      t1 = fmaf(ds[jj][2], p[jj][2], fmaf(ds[jj][3], p[jj][3], t1));
    }
    t0 = quad_sum(t0);
    t1 = quad_sum(t1);
#pragma unroll
    for (int jj = 0; jj < 2 * NT; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = p[jj][e] * (ds[jj][e] - (e < 2 ? t0 : t1));
        dbias[jj][e] += v;
        dscale = fmaf(v, s_raw[jj][e], dscale);
        ds[jj][e] = v * sc;
      }
      const int c = 8 * jj + c0;
      *reinterpret_cast<uint32_t*>(dt + r0 * LDP + c) =
          pack_bf16(ds[jj][0], ds[jj][1]);
      *reinterpret_cast<uint32_t*>(dt + (r0 + 8) * LDP + c) =
          pack_bf16(ds[jj][2], ds[jj][3]);
    }
    uint32_t da[NT][4];
    tc_to_operand<NT>(da, ds);
    float dq[2 * DT][4] = {};
    tc_times_tile<NT, DT>(dq, da, kn, zero_row, N, ld);
    tc_norm_backward<DT>(dq, qs, rn, act, row0, N, hd, ld);
    colsum(dq, 0);
    tc_store_rows<DT>(dq, dqkv, true, C3, head_off, row0, N, hd, w, rows);
  }
  sync();  // every warp's rows of round(p) and round(ds·scale)
  {  // keys row0..row0+15
    uint32_t a[NT][4];
    tc_load_transposed<NT>(a, pt, warp);
    float acc[2 * DT][4] = {};
    tc_times_tile<NT, DT>(acc, a, gs, zero_row, N, ld);
    colsum(acc, 2);
    tc_store_rows<DT>(acc, dqkv, true, C3,
                      2 * static_cast<size_t>(C) + head_off, row0, N, hd, w,
                      rows);
    tc_load_transposed<NT>(a, dt, warp);
#pragma unroll
    for (int nd = 0; nd < 2 * DT; ++nd)
      acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
    tc_times_tile<NT, DT>(acc, a, qn, zero_row, N, ld);
    tc_norm_backward<DT>(acc, ks, rn + N, act + N, row0, N, hd, ld);
    colsum(acc, 1);
    tc_store_rows<DT>(acc, dqkv, true, C3, static_cast<size_t>(C) + head_off,
                      row0, N, hd, w, rows);
  }
}

// The partial of a CTA (or a window lane) of the recompute backward: the
// dbias sums of the warp's own rows to prow[r·N + c], then Σ ds·s_raw over
// its NT warps to prow[N·N]. red: NT free floats of shared memory; sync():
// the barrier of the warps; tid: the thread's index among them (−1: the
// CTA's threadIdx.x, in unsigned arithmetic as tc_normalize's).
template <int NT, typename Sync = TcCtaSync>
__device__ __forceinline__ void tc_store_partial(
    const float (&dbias)[2 * NT][4], float dscale, float* prow, float* red,
    int warp, int r0, int c0, int N, int tid = -1, Sync sync = Sync()) {
#pragma unroll
  for (int jj = 0; jj < 2 * NT; ++jj) {
    const int c = 8 * jj + c0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (e < 2 ? 0 : 8);
      const int cc = c + (e & 1);
      if (r < N && cc < N) prow[r * N + cc] = dbias[jj][e];
    }
  }
  dscale = warp_sum(dscale);
  if ((threadIdx.x & 31) == 0) red[warp] = dscale;
  sync();
  if ((tid < 0 ? threadIdx.x : static_cast<unsigned>(tid)) == 0) {
    float total = 0.f;
    for (int i = 0; i < NT; ++i) total += red[i];
    prow[N * N] = total;
  }
}

// The forward: one CTA per (run of windows, head), NT warps; blockIdx.x =
// CTA·num_heads + head. The output is bf16 (out_bf16) or f32.
template <int NT, int DT, typename Rows>
__global__ void __launch_bounds__(32 * NT)
    window_attn_fwd_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias16,
                              const float* __restrict__ mask,
                              void* __restrict__ out, bool out_bf16, int N,
                              int C, int num_heads, int vec, TcPlan plan,
                              Rows rows) {
  constexpr int NP = 16 * NT;
  constexpr int ld = 16 * DT + 8;
  constexpr int ldb = NP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = C / num_heads;
  const int h = static_cast<int>(blockIdx.x % num_heads);
  const long long cta = blockIdx.x / num_heads;
  const int j = static_cast<int>(cta / plan.ipc);
  const long long r_first = (cta - j * plan.ipc) * plan.wpc;
  const int nwin = static_cast<int>(
      min(static_cast<long long>(plan.wpc), plan.R - r_first));

  float* bias_s = reinterpret_cast<float*>(smem_raw);
  float* mask_s = mask != nullptr ? bias_s + N * ldb : nullptr;
  __nv_bfloat16* zero_row = reinterpret_cast<__nv_bfloat16*>(
      bias_s + tc_bias_floats(N, NP, mask != nullptr));
  __nv_bfloat16* stage = zero_row + ld;
  const int stage_elems = 3 * N * ld;

  tc_zero(zero_row, (ld + 2 * stage_elems) / 8);
  __syncthreads();
  const TcCopier cp(hd, vec);
  auto window = [&](int s) { return (r_first + s) * plan.G + j; };
  tc_stage(stage, qkv, nullptr, N, C, hd, ld, cp, window(0), h, rows);
  cp_async_commit();
  tc_stage_bias(bias_s, mask_s, bias16 + static_cast<size_t>(h) * N * N,
                mask != nullptr ? mask + static_cast<size_t>(j) * N * N
                                : nullptr,
                N, NP);
  const float sc = scale[h];
  const int row0 = 16 * static_cast<int>(threadIdx.x >> 5);

  for (int s = 0; s < nwin; ++s) {
    __nv_bfloat16* qs = stage + (s & 1) * stage_elems;
    __nv_bfloat16* ks = qs + N * ld;
    const __nv_bfloat16* vs = ks + N * ld;
    if (s + 1 < nwin) {
      tc_stage(stage + ((s + 1) & 1) * stage_elems, qkv, nullptr, N, C, hd,
               ld, cp, window(s + 1), h, rows);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    tc_normalize(qs, ks, qs, ks, nullptr, nullptr, N, hd, ld);
    __syncthreads();

    float s_raw[2 * NT][4];
    tc_scores<NT, DT>(s_raw, qs, ks, zero_row, row0, N, ld);
    float p[2 * NT][4];
    tc_softmax<NT>(p, s_raw, bias_s, mask_s, sc, row0, N);
    uint32_t pa[NT][4];
    tc_to_operand<NT>(pa, p);
    float o[2 * DT][4] = {};
    tc_times_tile<NT, DT>(o, pa, vs, zero_row, N, ld);
    tc_store_rows<DT>(o, out, out_bf16, static_cast<size_t>(C),
                      static_cast<size_t>(h) * hd, row0, N, hd, window(s),
                      rows);
    __syncthreads();  // the stage is refilled two windows on
  }
}

// The recompute backward: one CTA per (run of windows, head), NT warps.
// Per window: q̂, k̂ and the norms; then tc_bwd_window, warp i: the scores, p (round(p) to the
// P tile), dp = g·vᵀ, ds, its dbias and dscale sums, round(ds·scale) (to
// the dsc tile and as the A operand of dq̂ = dsc·k̂), dq; then, once every
// warp has written its rows of the P and dsc tiles, warp i: dv =
// round(p)ᵀ·g and dk̂ = dscᵀ·q̂ for key rows 16i.., dk. The CTA's partial
// (dbias N·N values, then Σ ds·s_raw) goes to partial[blockIdx.x].
template <int NT, int DT, typename Rows>
__global__ void __launch_bounds__(32 * NT)
    window_attn_bwd_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias16,
                              const float* __restrict__ mask,
                              const __nv_bfloat16* __restrict__ g,
                              __nv_bfloat16* __restrict__ dqkv,
                              float* __restrict__ partial, int N, int C,
                              int num_heads, int vec, TcPlan plan,
                              Rows rows) {
  constexpr int NP = 16 * NT;
  constexpr int LDP = NP + 8;
  constexpr int ld = 16 * DT + 8;
  constexpr int ldb = NP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = C / num_heads;
  const int h = static_cast<int>(blockIdx.x % num_heads);
  const long long cta = blockIdx.x / num_heads;
  const int j = static_cast<int>(cta / plan.ipc);
  const long long r_first = (cta - j * plan.ipc) * plan.wpc;
  const int nwin = static_cast<int>(
      min(static_cast<long long>(plan.wpc), plan.R - r_first));

  float* bias_s = reinterpret_cast<float*>(smem_raw);
  float* mask_s = mask != nullptr ? bias_s + N * ldb : nullptr;
  float* rn = bias_s + tc_bias_floats(N, NP, mask != nullptr);  // 2·NP
  float* act = rn + 2 * NP;                                      // 2·NP
  float* red = act + 2 * NP;                                     // 32
  __nv_bfloat16* zero_row = reinterpret_cast<__nv_bfloat16*>(red + 32);
  __nv_bfloat16* qn = zero_row + ld;   // round(q̂), (N, ld)
  __nv_bfloat16* kn = qn + N * ld;     // round(k̂)
  __nv_bfloat16* pt = kn + N * ld;     // round(p), (NP, NP + 8)
  __nv_bfloat16* dt = pt + NP * LDP;   // round(ds·scale)
  __nv_bfloat16* stage = dt + NP * LDP;
  const int stage_elems = 4 * N * ld;  // raw q, k, v, g

  tc_zero(zero_row, (ld + 2 * N * ld) / 8);
  tc_zero(stage, 2 * stage_elems / 8);
  __syncthreads();
  const TcCopier cp(hd, vec);
  auto window = [&](int s) { return (r_first + s) * plan.G + j; };
  tc_stage(stage, qkv, g, N, C, hd, ld, cp, window(0), h, rows);
  cp_async_commit();
  tc_stage_bias(bias_s, mask_s, bias16 + static_cast<size_t>(h) * N * N,
                mask != nullptr ? mask + static_cast<size_t>(j) * N * N
                                : nullptr,
                N, NP);
  const float sc = scale[h];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = 16 * warp;
  const int r0 = row0 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const size_t head_off = static_cast<size_t>(h) * hd;
  const size_t C3 = 3 * static_cast<size_t>(C);

  float dbias[2 * NT][4] = {};
  float dscale = 0.f;

  for (int s = 0; s < nwin; ++s) {
    const __nv_bfloat16* qs = stage + (s & 1) * stage_elems;
    const __nv_bfloat16* ks = qs + N * ld;
    const __nv_bfloat16* vs = ks + N * ld;
    const __nv_bfloat16* gs = vs + N * ld;
    const long long w = window(s);
    if (s + 1 < nwin) {
      tc_stage(stage + ((s + 1) & 1) * stage_elems, qkv, g, N, C, hd, ld, cp,
               window(s + 1), h, rows);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    tc_normalize(qs, ks, qn, kn, rn, act, N, hd, ld);
    __syncthreads();
    tc_bwd_window<NT, DT>(dbias, dscale, qs, ks, vs, gs, qn, kn, pt, dt,
                          zero_row, rn, act, bias_s, mask_s, sc, dqkv, C, C3,
                          head_off, warp, row0, r0, c0, N, hd, w, rows);
    __syncthreads();  // the stage and the tiles are refilled
  }

  // this CTA's partial: dbias from the warps' own rows, then Σ ds·s_raw
  tc_store_partial<NT>(dbias, dscale,
                       partial + static_cast<size_t>(blockIdx.x) * (N * N + 1),
                       red, warp, r0, c0, N);
}

// Checks shared by the tensor-core entries: bf16 tiles of at most 64 × 64
// with an even head dim, 4-byte (vec 4) or 16-byte (vec 16) copies whose
// every source address is aligned to them, and a plan that fits the grid.
inline bool tc_args_ok(long long n_windows, int N, int C, int num_heads,
                       int n_win_per_img, int wpc, int vec,
                       std::initializer_list<const void*> ptrs) {
  if (n_windows <= 0 || N <= 0 || N > 64 || num_heads <= 0 ||
      C % num_heads != 0 || n_win_per_img <= 0 ||
      n_windows % n_win_per_img != 0 || wpc <= 0 || (vec != 4 && vec != 16))
    return false;
  const int hd = C / num_heads;
  if (hd > 64 || hd % 2 != 0 || (vec == 16 && (hd % 8 != 0 || C % 8 != 0)))
    return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % vec != 0) return false;
  return (n_windows + wpc - 1) / wpc * num_heads <= INT_MAX;
}

// Sets the kernel's dynamic shared memory above 48 KB and launches it on
// the plan's grid with 32·NT threads.
template <int NT, typename Kernel, typename... Args>
cudaError_t tc_launch(Kernel kernel, size_t smem, const TcPlan& plan,
                      int num_heads, cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks =
      static_cast<unsigned>(plan.G * plan.ipc * num_heads);
  kernel<<<blocks, 32 * NT, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int NT, int DT, typename Rows>
cudaError_t launch_fwd_tc(const void* qkv, const void* scale,
                          const void* bias16, const void* mask, void* out,
                          bool out_bf16, int N, int C, int num_heads, int vec,
                          const TcPlan& plan, const Rows& rows,
                          cudaStream_t stream) {
  return tc_launch<NT>(
      window_attn_fwd_tc_kernel<NT, DT, Rows>,
      tc_fwd_smem_bytes(N, C / num_heads, mask != nullptr), plan, num_heads,
      stream, static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(scale), static_cast<const float*>(bias16),
      static_cast<const float*>(mask), out, out_bf16, N, C, num_heads, vec,
      plan, rows);
}

template <int NT, int DT, typename Rows>
cudaError_t launch_bwd_tc(const void* qkv, const void* scale,
                          const void* bias16, const void* mask, const void* g,
                          void* dqkv, void* partial, int N, int C,
                          int num_heads, int vec, const TcPlan& plan,
                          const Rows& rows, cudaStream_t stream) {
  return tc_launch<NT>(
      window_attn_bwd_tc_kernel<NT, DT, Rows>,
      tc_bwd_smem_bytes(N, C / num_heads, mask != nullptr), plan, num_heads,
      stream, static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(scale), static_cast<const float*>(bias16),
      static_cast<const float*>(mask), static_cast<const __nv_bfloat16*>(g),
      static_cast<__nv_bfloat16*>(dqkv), static_cast<float*>(partial), N, C,
      num_heads, vec, plan, rows);
}

// Calls launch<NT, DT>(args...) for the tile counts of N and hd (1..4
// each): sixteen instantiations per kernel and row layout. Left defined for
// the sources that include this header (window_attn_qkv.cu dispatches its
// tensor-core forward with it).
#define TC_DISPATCH(launch, N, hd, ...)                                    \
  [&]() -> cudaError_t {                                                  \
    switch (4 * (tc_tiles(N) - 1) + tc_tiles(hd) - 1) {                  \
      case 0: return launch<1, 1>(__VA_ARGS__);                           \
      case 1: return launch<1, 2>(__VA_ARGS__);                           \
      case 2: return launch<1, 3>(__VA_ARGS__);                           \
      case 3: return launch<1, 4>(__VA_ARGS__);                           \
      case 4: return launch<2, 1>(__VA_ARGS__);                           \
      case 5: return launch<2, 2>(__VA_ARGS__);                           \
      case 6: return launch<2, 3>(__VA_ARGS__);                           \
      case 7: return launch<2, 4>(__VA_ARGS__);                           \
      case 8: return launch<3, 1>(__VA_ARGS__);                           \
      case 9: return launch<3, 2>(__VA_ARGS__);                           \
      case 10: return launch<3, 3>(__VA_ARGS__);                          \
      case 11: return launch<3, 4>(__VA_ARGS__);                          \
      case 12: return launch<4, 1>(__VA_ARGS__);                          \
      case 13: return launch<4, 2>(__VA_ARGS__);                          \
      case 14: return launch<4, 3>(__VA_ARGS__);                          \
      default: return launch<4, 4>(__VA_ARGS__);                          \
    }                                                                     \
  }()

// The tensor-core forward's C entry body for either row layout; qkv is
// bf16, out f32 (out_dtype 0) or bf16 (1).
template <typename Rows>
int window_attn_fwd_tc_entry(const void* qkv, const void* scale,
                             const void* bias16, const void* mask, void* out,
                             long long n_windows, int N, int C, int num_heads,
                             int n_win_per_img, int out_dtype, int wpc,
                             int vec, const Rows& rows, void* stream) {
  if (!tc_args_ok(n_windows, N, C, num_heads, n_win_per_img, wpc, vec,
                  {qkv}) ||
      (out_dtype != 0 && out_dtype != 1) ||
      reinterpret_cast<uintptr_t>(out) % (out_dtype == 0 ? 8 : 4) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const TcPlan plan = tc_plan(n_windows, n_win_per_img, mask != nullptr, wpc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(TC_DISPATCH(
      launch_fwd_tc, N, C / num_heads, qkv, scale, bias16, mask, out,
      out_dtype == 1, N, C, num_heads, vec, plan, rows, s));
}

// The tensor-core backward's C entry body for either row layout: qkv, g and
// dqkv bf16; partial holds G·⌈R / wpc⌉·num_heads rows of (N·N + 1) floats
// (one per CTA); out receives (num_heads, N·N + 1) as the CUDA-core
// entry's.
template <typename Rows>
int window_attn_bwd_tc_entry(const void* qkv, const void* scale,
                             const void* bias16, const void* mask,
                             const void* g, void* dqkv, void* partial,
                             void* out, long long n_windows, int N, int C,
                             int num_heads, int n_win_per_img, int wpc,
                             int vec, const Rows& rows, void* stream) {
  if (!tc_args_ok(n_windows, N, C, num_heads, n_win_per_img, wpc, vec,
                  {qkv, g}) ||
      reinterpret_cast<uintptr_t>(dqkv) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const TcPlan plan = tc_plan(n_windows, n_win_per_img, mask != nullptr, wpc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = TC_DISPATCH(launch_bwd_tc, N, C / num_heads, qkv,
                                      scale, bias16, mask, g, dqkv, partial,
                                      N, C, num_heads, vec, plan, rows, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_window_sum(
      partial, out, plan.G * plan.ipc, num_heads, N * N + 1, s));
}

template <int NT, int DT, typename Rows>
cudaError_t tc_occupancy(int* ctas, bool backward, int N, int hd,
                         bool masked, Rows) {
  const size_t smem = backward ? tc_bwd_smem_bytes(N, hd, masked)
                               : tc_fwd_smem_bytes(N, hd, masked);
  const void* kernel =
      backward ? reinterpret_cast<const void*>(
                     window_attn_bwd_tc_kernel<NT, DT, Rows>)
               : reinterpret_cast<const void*>(
                     window_attn_fwd_tc_kernel<NT, DT, Rows>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, 32 * NT,
                                                       smem);
}

// How many CTAs of the tensor-core forward (or backward) for these tiles
// one SM holds at once, from the CUDA occupancy API: the wrapper plans one
// wave of them (fused_window_attn.py, tensor_core_plan). Returns the count,
// or the negated CUDA error.
template <typename Rows>
int window_attn_tc_occupancy_entry(int N, int C, int num_heads, int masked,
                                   int backward) {
  if (N <= 0 || N > 64 || num_heads <= 0 || C % num_heads != 0 ||
      C / num_heads > 64)
    return -static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0;
  const cudaError_t err = TC_DISPATCH(tc_occupancy, N, C / num_heads, &ctas,
                                      backward != 0, N, C / num_heads,
                                      masked != 0, Rows{});
  return err == cudaSuccess ? ctas : -static_cast<int>(err);
}

}  // namespace
