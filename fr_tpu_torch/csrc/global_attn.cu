// Global multi-head attention for NVIDIA Hopper (sm_90a), forward and
// backward: softmax(q·kᵀ·scale)·v over every token of an image, read from
// and written to the packed qkv projection.
//
// Replaces no TPU kernel: fr_tpu has no ViT. The port's ViT encoder
// (models/vit.py) calls it once a block through ops/global_attn.py, where
// these kernels took the place of PyTorch's flash forward and a backward
// that autograd ran through six L × L tensors a layer.
//
// What bounds it on the card. At ViT-L's training shape (384 images,
// L = 136 tokens, 8 heads of d = 96) a layer moves 8·B·L·D bf16 bytes
// forward (q, k, v read, o written) and 14·B·L·D backward (q, k, v and the
// output's gradient read, dq, dk, dv written), 0.38 GB in all, against 12·
// B·H·L²·d flops: 0.11 ms at 3.35 TB/s against 0.07 ms at 989 TFLOP/s, so
// neither bound is far, and the L × L intermediates are the cost to avoid.
// The rows are short: a row of the scores is L ≤ 144 keys, so a warp holds a
// 16-row strip of S (and in the backward of dP too) whole in registers, and
// a head's q, k, v (and dO) whole in shared memory. The design follows:
//  - One CTA per (image, head) and one warp per 16-row query strip: the
//    tokens are padded to NT = ⌈L / 16⌉ strips (NT ≤ 9) and the CTA has NT
//    warps; rows past L read a shared zero row and are masked. The head
//    dim is DT = d / 16 tiles (1..8), a template parameter.
//  - q, k, v come from the (B, L, 3, H, d) projection by its image and
//    token strides, by 16-byte cp.async into (L, d + 8) bf16 tiles (a row
//    stride that is an odd multiple of 16 bytes, so ldmatrix reads them
//    without bank conflicts). o and the gradients are written in place:
//    o as (B, L, H, d), dq, dk, dv into one (B, L, 3, H, d) buffer.
//  - Products on the tensor cores by mma.sync.m16n8k16, bf16 operands and
//    f32 accumulators (the helpers of window_attn_tc.cuh); the accumulator
//    tiles of one product are the A operand of the next. mma.sync and not
//    wgmma: a strip is 16 rows, and the CTA's work is 5 products of at most
//    144 × 144 × 128.
//  - Forward: S = q·kᵀ, the softmax of S·scale in f32 (base-2 exponent),
//    P rounded to bf16 for P·v; o rounded to bf16, and each row's
//    log-sum-exp lse (natural log, f32) for the backward.
//  - Backward: P = exp(S·scale − lse) recomputed in f32, dP = dO·vᵀ kept in
//    f32, Dᵢ = Σⱼ Pᵢⱼ·dPᵢⱼ over the whole row from those same values, in the
//    warp that owns the row, and dS = P∘(dP − D)·scale rounded to bf16. So
//    each row of dS sums to nought with the probabilities and the
//    gradient it was made from. (Flash attention takes Dᵢ as dOᵢ·oᵢ from
//    the bf16 output; where a row's tokens lie near their mean, as in a
//    ViT's deeper blocks, that rounding is larger than the true dq and dk.)
//    dq = dS·k for the warp's strip; then the warps write round(P) and dS
//    to shared memory over v's tile (no warp reads v after the barrier) and
//    warp i forms dv = round(P)ᵀ·dO and dk = dSᵀ·q for key rows 16i..16i+15,
//    the contraction running over all L queries.
//  - Every sum runs in a fixed order and no value is written twice: no
//    atomics, so two runs give the same bits.
// Shared memory: forward 2·(d + 8)·(3L + 1) bytes (90 KB at L 144, d 96:
// two CTAs an SM); backward 2·(d + 8)·(3L + 1) + max(2·(d + 8)·L,
// 4·NP·(NP + 8)) bytes, NP = 16·NT (173 KB at L 136, d 96; 205 KB at L 144,
// d 128; one CTA an SM). Nine warps put three on one of the SM's four
// schedulers, whose 16K registers then hold 168 a thread: the backward's
// S and dP rows (144 f32) fit with a few bytes of spill. The backward
// stages q and k first and recomputes P while v and dO land (3% of its
// time on an H100; the forward, two CTAs an SM, gains nothing by it).

#include <algorithm>
#include <cstdint>

#include "window_attn_tc.cuh"

namespace {

constexpr int kMaxStrips = 9;  // L ≤ 144
constexpr int kMaxTokens = 16 * kMaxStrips;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Token rows of one matrix of the head into an (L, 16·DT + 8) tile by
// 16-byte cp.async; src points at token 0, column 0, rows `stride` apart.
template <int DT>
__device__ __forceinline__ void ga_stage(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src,
                                         long long stride, int L) {
  constexpr int cpr = 2 * DT;  // 16-byte copies a row
  constexpr int ld = 16 * DT + 8;
  for (int i = threadIdx.x; i < L * cpr; i += blockDim.x) {
    const int r = i / cpr;
    const int c = 8 * (i - r * cpr);
    cp_async<16>(dst + r * ld + c, src + r * stride + c);
  }
}

// acc = X·Yᵀ over the head dim for the warp's 16 rows of X (row0): 2·nt
// tiles of 16 × 8; tiles past 2·nt stay 0. Rows past L read the zero row.
template <int DT>
__device__ __forceinline__ void ga_scores(float (&acc)[2 * kMaxStrips][4],
                                          const __nv_bfloat16* x,
                                          const __nv_bfloat16* y,
                                          const __nv_bfloat16* zero_row,
                                          int row0, int L, int nt) {
  constexpr int ld = 16 * DT + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 2 * kMaxStrips; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int ar = row0 + (lane & 15);
  const __nv_bfloat16* ap =
      (ar < L ? x + ar * ld : zero_row) + (lane >> 4) * 8;
  const int koff = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, ap + 16 * kk);
#pragma unroll
    for (int j = 0; j < 2 * kMaxStrips; j += 2) {
      if (j < 2 * nt) {
        const int key = 8 * j + (lane & 7) + ((lane >> 4) << 3);
        uint32_t b[4];
        ldsm_x4(b, (key < L ? y + key * ld : zero_row) + 16 * kk + koff);
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
  }
}

// The accumulator tiles as the A operand of the next product, rounded to
// bf16: tiles 2kk and 2kk + 1 make k-step kk.
__device__ __forceinline__ void ga_to_operand(
    uint32_t (&a)[kMaxStrips][4], const float (&x)[2 * kMaxStrips][4],
    int nt) {
#pragma unroll
  for (int kk = 0; kk < kMaxStrips; ++kk) {
    if (kk < nt) {
      a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
      a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
      a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
      a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    }
  }
}

// acc (16 × 16·DT) += A·B: A the warp's 16 × 16·nt operand as register
// fragments, B an (L, 16·DT + 8) token tile read transposed; rows of B past
// L read the zero row.
template <int DT>
__device__ __forceinline__ void ga_times_tile(
    float (&acc)[2 * DT][4], const uint32_t (&a)[kMaxStrips][4],
    const __nv_bfloat16* b, const __nv_bfloat16* zero_row, int L, int nt) {
  constexpr int ld = 16 * DT + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < kMaxStrips; ++kk) {
    if (kk < nt) {
      const int key = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
      const __nv_bfloat16* bp =
          (key < L ? b + key * ld : zero_row) + (lane >> 4) * 8;
#pragma unroll
      for (int nd = 0; nd < 2 * DT; nd += 2) {
        uint32_t f[4];
        ldsm_x4_t(f, bp + 8 * nd);
        mma_bf16(acc[nd], a[kk], f[0], f[1]);
        mma_bf16(acc[nd + 1], a[kk], f[2], f[3]);
      }
    }
  }
}

// acc (16 × 16·DT) = Xᵀ·B for the key rows 16·kt..16·kt + 15: X an
// (NP, NP + 8) bf16 tile X[query][key] in shared memory, B an (L, 16·DT + 8)
// token tile over the queries; the contraction runs over every query.
template <int DT>
__device__ __forceinline__ void ga_transposed_times_tile(
    float (&acc)[2 * DT][4], const __nv_bfloat16* x,
    const __nv_bfloat16* b, const __nv_bfloat16* zero_row, int kt, int L,
    int nt) {
  constexpr int ld = 16 * DT + 8;
  const int lane = threadIdx.x & 31;
  const int ldp = 16 * nt + 8;
  const int col = 16 * kt + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int nd = 0; nd < 2 * DT; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kMaxStrips; ++kk) {
    if (kk < nt) {
      uint32_t a[4];
      ldsm_x4_t(a, x + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * ldp +
                       col);
      const int q = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
      const __nv_bfloat16* bp =
          (q < L ? b + q * ld : zero_row) + (lane >> 4) * 8;
#pragma unroll
      for (int nd = 0; nd < 2 * DT; nd += 2) {
        uint32_t f[4];
        ldsm_x4_t(f, bp + 8 * nd);
        mma_bf16(acc[nd], a, f[0], f[1]);
        mma_bf16(acc[nd + 1], a, f[2], f[3]);
      }
    }
  }
}

// The forward: blockIdx.x = image·H + head, ⌈L / 16⌉ warps.
template <int DT>
__global__ void __launch_bounds__(32 * kMaxStrips, 2)
    global_attn_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, long long sb,
                           long long sl, int L, int H, float scale) {
  constexpr int d = 16 * DT;
  constexpr int ld = d + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* zero_row = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* qs = zero_row + ld;
  __nv_bfloat16* ks = qs + L * ld;
  __nv_bfloat16* vs = ks + L * ld;
  const int h = static_cast<int>(blockIdx.x % H);
  const long long b = blockIdx.x / H;
  const long long D = static_cast<long long>(H) * d;
  const __nv_bfloat16* src = qkv + b * sb + static_cast<long long>(h) * d;
  ga_stage<DT>(qs, src, sl, L);
  ga_stage<DT>(ks, src + D, sl, L);
  ga_stage<DT>(vs, src + 2 * D, sl, L);
  cp_async_commit();
  tc_zero(zero_row, ld / 8);
  cp_async_wait<0>();
  __syncthreads();

  const int nt = (L + 15) / 16;
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * static_cast<int>(threadIdx.x >> 5);
  const int r0 = row0 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float s[2 * kMaxStrips][4];
  ga_scores<DT>(s, qs, ks, zero_row, row0, L, nt);

  // softmax of S·scale in base 2: x = S·scale·log₂e, p = 2^(x − max)
  const float c = scale * kLog2e;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * kMaxStrips; ++j) {
    if (j < 2 * nt) {
      const bool in0 = 8 * j + c0 < L, in1 = 8 * j + c0 + 1 < L;
      s[j][0] = in0 ? s[j][0] * c : -INFINITY;
      s[j][1] = in1 ? s[j][1] * c : -INFINITY;
      s[j][2] = in0 ? s[j][2] * c : -INFINITY;
      s[j][3] = in1 ? s[j][3] * c : -INFINITY;
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * kMaxStrips; ++j) {
    if (j < 2 * nt) {
      s[j][0] = exp2f(s[j][0] - m0);
      s[j][1] = exp2f(s[j][1] - m0);
      s[j][2] = exp2f(s[j][2] - m1);
      s[j][3] = exp2f(s[j][3] - m1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = r0 < L ? 1.f / l0 : 0.f;
  const float i1 = r0 + 8 < L ? 1.f / l1 : 0.f;
#pragma unroll
  for (int j = 0; j < 2 * kMaxStrips; ++j) {
    s[j][0] *= i0;
    s[j][1] *= i0;
    s[j][2] *= i1;
    s[j][3] *= i1;
  }
  uint32_t pa[kMaxStrips][4];
  ga_to_operand(pa, s, nt);
  float o[2 * DT][4] = {};
  ga_times_tile<DT>(o, pa, vs, zero_row, L, nt);
  tc_store_rows<DT>(o, out + b * L * D + static_cast<long long>(h) * d, true,
                    D, 0, row0, L, d, 0, WindowRows{L});
  if ((lane & 3) == 0) {
    float* row = lse + (b * H + h) * L;
    if (r0 < L) row[r0] = (m0 + log2f(l0)) * kLn2;
    if (r0 + 8 < L) row[r0 + 8] = (m1 + log2f(l1)) * kLn2;
  }
}

// The backward: blockIdx.x = image·H + head, ⌈L / 16⌉ warps. dout is
// (B, L, H, d); dqkv (B, L, 3, H, d), written whole.
template <int DT>
__global__ void __launch_bounds__(32 * kMaxStrips, 1)
    global_attn_bwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           __nv_bfloat16* __restrict__ dqkv, long long sb,
                           long long sl, int L, int H, float scale) {
  constexpr int d = 16 * DT;
  constexpr int ld = d + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = (L + 15) / 16;
  const int ldp = 16 * nt + 8;
  __nv_bfloat16* zero_row = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* qs = zero_row + ld;
  __nv_bfloat16* ks = qs + L * ld;
  __nv_bfloat16* dos = ks + L * ld;
  __nv_bfloat16* vs = dos + L * ld;
  // round(P) and dS, (NP, NP + 8) each, over v's tile once v is read
  __nv_bfloat16* pt = vs;
  __nv_bfloat16* dst = pt + 16 * nt * ldp;
  const int h = static_cast<int>(blockIdx.x % H);
  const long long b = blockIdx.x / H;
  const long long D = static_cast<long long>(H) * d;
  const long long hoff = static_cast<long long>(h) * d;
  const __nv_bfloat16* src = qkv + b * sb + hoff;
  // q and k first: P is recomputed while v and dO land
  ga_stage<DT>(qs, src, sl, L);
  ga_stage<DT>(ks, src + D, sl, L);
  cp_async_commit();
  ga_stage<DT>(vs, src + 2 * D, sl, L);
  ga_stage<DT>(dos, dout + b * L * D + hoff, D, L);
  cp_async_commit();
  tc_zero(zero_row, ld / 8);
  cp_async_wait<1>();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int row0 = 16 * warp;
  const int r0 = row0 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const float c = scale * kLog2e;
  const float* lrow = lse + (b * H + h) * L;
  const float e0 = r0 < L ? lrow[r0] * kLog2e : 0.f;
  const float e1 = r0 + 8 < L ? lrow[r0 + 8] * kLog2e : 0.f;

  float p[2 * kMaxStrips][4];
  ga_scores<DT>(p, qs, ks, zero_row, row0, L, nt);
  const bool row_in0 = r0 < L, row_in1 = r0 + 8 < L;
#pragma unroll
  for (int j = 0; j < 2 * kMaxStrips; ++j) {
    if (j < 2 * nt) {
      const bool in0 = 8 * j + c0 < L, in1 = 8 * j + c0 + 1 < L;
      p[j][0] = row_in0 && in0 ? exp2f(p[j][0] * c - e0) : 0.f;
      p[j][1] = row_in0 && in1 ? exp2f(p[j][1] * c - e0) : 0.f;
      p[j][2] = row_in1 && in0 ? exp2f(p[j][2] * c - e1) : 0.f;
      p[j][3] = row_in1 && in1 ? exp2f(p[j][3] * c - e1) : 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float dp[2 * kMaxStrips][4];
  ga_scores<DT>(dp, dos, vs, zero_row, row0, L, nt);
  // D = Σⱼ P·dP over the whole row, in f32, in a fixed order: each thread's
  // columns in order, then the quad's four partial sums by xor shuffles
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * kMaxStrips; ++j) {
    if (j < 2 * nt) {
      d0 = fmaf(p[j][0], dp[j][0], d0);
      d0 = fmaf(p[j][1], dp[j][1], d0);
      d1 = fmaf(p[j][2], dp[j][2], d1);
      d1 = fmaf(p[j][3], dp[j][3], d1);
    }
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
#pragma unroll
  for (int j = 0; j < 2 * kMaxStrips; ++j) {
    dp[j][0] = p[j][0] * (dp[j][0] - d0) * scale;
    dp[j][1] = p[j][1] * (dp[j][1] - d0) * scale;
    dp[j][2] = p[j][2] * (dp[j][2] - d1) * scale;
    dp[j][3] = p[j][3] * (dp[j][3] - d1) * scale;
  }
  uint32_t pa[kMaxStrips][4], da[kMaxStrips][4];
  ga_to_operand(pa, p, nt);
  ga_to_operand(da, dp, nt);

  __nv_bfloat16* grad = dqkv + b * L * 3 * D + hoff;
  {
    float acc[2 * DT][4] = {};
    ga_times_tile<DT>(acc, da, ks, zero_row, L, nt);  // dq = dS·k
    tc_store_rows<DT>(acc, grad, true, 3 * D, 0, row0, L, d, 0,
                      WindowRows{L});
  }
  __syncthreads();  // every warp has read v
#pragma unroll
  for (int kk = 0; kk < kMaxStrips; ++kk) {
    if (kk < nt) {
      const int col = 16 * kk + c0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        *reinterpret_cast<uint32_t*>(pt + r * ldp + col) = pa[kk][half];
        *reinterpret_cast<uint32_t*>(pt + r * ldp + col + 8) =
            pa[kk][2 + half];
        *reinterpret_cast<uint32_t*>(dst + r * ldp + col) = da[kk][half];
        *reinterpret_cast<uint32_t*>(dst + r * ldp + col + 8) =
            da[kk][2 + half];
      }
    }
  }
  __syncthreads();
  {
    float acc[2 * DT][4];
    ga_transposed_times_tile<DT>(acc, pt, dos, zero_row, warp, L, nt);
    tc_store_rows<DT>(acc, grad + 2 * D, true, 3 * D, 0, row0, L, d, 0,
                      WindowRows{L});  // dv = Pᵀ·dO
    ga_transposed_times_tile<DT>(acc, dst, qs, zero_row, warp, L, nt);
    tc_store_rows<DT>(acc, grad + D, true, 3 * D, 0, row0, L, d, 0,
                      WindowRows{L});  // dk = dSᵀ·q
  }
}

inline size_t fwd_smem_bytes(int L, int d) {
  return 2 * static_cast<size_t>(d + 8) * (3 * L + 1);
}

inline size_t bwd_smem_bytes(int L, int d) {
  const size_t np = 16 * ((L + 15) / 16);
  return fwd_smem_bytes(L, d) +
         std::max(2 * static_cast<size_t>(d + 8) * L, 4 * np * (np + 8));
}

template <typename Kernel, typename... Args>
cudaError_t ga_launch(Kernel kernel, size_t smem, int B, int L, int H,
                      cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(B) * H, 32 * ((L + 15) / 16), smem,
           stream>>>(args...);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_fwd(const void* qkv, void* out, void* lse, int B, int L,
                       int H, long long sb, long long sl, float scale,
                       cudaStream_t stream) {
  return ga_launch(global_attn_fwd_kernel<DT>, fwd_smem_bytes(L, 16 * DT), B,
                   L, H, stream, static_cast<const __nv_bfloat16*>(qkv),
                   static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
                   sb, sl, L, H, scale);
}

template <int DT>
cudaError_t launch_bwd(const void* qkv, const void* dout, const void* lse,
                       void* dqkv, int B, int L, int H, long long sb,
                       long long sl, float scale, cudaStream_t stream) {
  return ga_launch(global_attn_bwd_kernel<DT>, bwd_smem_bytes(L, 16 * DT), B,
                   L, H, stream, static_cast<const __nv_bfloat16*>(qkv),
                   static_cast<const __nv_bfloat16*>(dout),
                   static_cast<const float*>(lse),
                   static_cast<__nv_bfloat16*>(dqkv), sb, sl, L, H, scale);
}

// Calls launch<DT>(args...) for d = 16·DT, DT = 1..8.
#define GA_DISPATCH(launch, d, ...)                  \
  [&]() -> cudaError_t {                            \
    switch ((d) / 16) {                             \
      case 1: return launch<1>(__VA_ARGS__);        \
      case 2: return launch<2>(__VA_ARGS__);        \
      case 3: return launch<3>(__VA_ARGS__);        \
      case 4: return launch<4>(__VA_ARGS__);        \
      case 5: return launch<5>(__VA_ARGS__);        \
      case 6: return launch<6>(__VA_ARGS__);        \
      case 7: return launch<7>(__VA_ARGS__);        \
      default: return launch<8>(__VA_ARGS__);       \
    }                                               \
  }()

// The shapes the kernels take: 1 ≤ L ≤ 144, d a multiple of 16 up to 128,
// strides of whole 16-byte words, 16-byte aligned inputs and 4-byte
// aligned outputs, a grid of at most 2³¹ − 1 CTAs.
bool ga_args_ok(int B, int L, int H, int d, long long sb, long long sl,
                std::initializer_list<const void*> in,
                std::initializer_list<const void*> out) {
  if (B <= 0 || L <= 0 || L > kMaxTokens || H <= 0 || d < 16 || d > 128 ||
      d % 16 != 0 || sb % 8 != 0 || sl % 8 != 0 ||
      static_cast<long long>(B) * H > INT_MAX)
    return false;
  for (const void* p : in)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (const void* p : out)
    if (reinterpret_cast<uintptr_t>(p) % 4 != 0) return false;
  return true;
}

}  // namespace

// The forward: qkv bf16 (B, L, 3, H, d) with image and token strides sb, sl
// (elements; the last three dims contiguous); out bf16 (B, L, H, d); lse f32
// (B, H, L). Returns the launch's cudaGetLastError().
extern "C" int global_attn_fwd(const void* qkv, void* out, void* lse, int B,
                               int L, int H, int d, long long sb,
                               long long sl, float scale, void* stream) {
  if (!ga_args_ok(B, L, H, d, sb, sl, {qkv}, {out, lse}))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(GA_DISPATCH(launch_fwd, d, qkv, out, lse, B, L, H,
                                      sb, sl, scale,
                                      static_cast<cudaStream_t>(stream)));
}

// The backward: qkv as the forward's, dout bf16 (B, L, H, d) contiguous,
// lse the forward's; dqkv bf16 (B, L, 3, H, d) contiguous, every element
// written.
extern "C" int global_attn_bwd(const void* qkv, const void* dout,
                               const void* lse, void* dqkv, int B, int L,
                               int H, int d, long long sb, long long sl,
                               float scale, void* stream) {
  if (!ga_args_ok(B, L, H, d, sb, sl, {qkv, dout}, {lse, dqkv}))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(GA_DISPATCH(launch_bwd, d, qkv, dout, lse, dqkv, B,
                                      L, H, sb, sl, scale,
                                      static_cast<cudaStream_t>(stream)));
}
