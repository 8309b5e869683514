// Shared by the window-attention sources (window_attn_fwd.cu,
// window_attn_bwd.cu, window_attn_stats.cu, window_attn_spatial.cu,
// window_attn_qkv.cu): dtype helpers, warp reductions, the two row layouts
// (windows and spatial), the forward kernel (with and without storing p, its
// body after staging shared with the entry-fused kernel) and the second
// pass that sums the backwards' per-block partials.
// Everything sits in an anonymous namespace, so each source that includes
// it gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr float kEps2 = 1e-24f;  // (1e-12)^2, the l2_normalize guard
constexpr int kReduceCols = 32;  // second pass: columns per block
constexpr int kReduceRows = 16;  // second pass: window slices per column

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round to the compute dtype T and widen again: the casts fr_tpu applies to
// q̂, k̂, p, g and ds·scale before each product.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename O>
__device__ __forceinline__ O from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Where the row of token n of window w lies in the arrays a kernel reads and
// writes (qkv and dqkv with 3C columns, out and g with C): the row index.
// WindowRows is the windows API, the windows one after another
// (B·nW, N, ·). SpatialRows is the (B, H, W, ·) layout itself: window
// w = (img, wy, wx) in window_partition's order, token n = (ty, tx) row-major
// inside it, so the kernel reads and writes the image layout and the
// partition and its reverse never materialise.
struct WindowRows {
  int N;
  __device__ __forceinline__ size_t row(long long w, int n) const {
    return static_cast<size_t>(w) * N + n;
  }
};

struct SpatialRows {
  int H, W, ws, nWy, nWx;
  __device__ __forceinline__ size_t row(long long w, int n) const {
    const long long per_img = static_cast<long long>(nWy) * nWx;
    const long long img = w / per_img;
    const int r = static_cast<int>(w - img * per_img);
    const int wy = r / nWx;
    const int wx = r - wy * nWx;
    const int ty = n / ws;
    const int tx = n - ty * ws;
    return (static_cast<size_t>(img) * H + wy * ws + ty) * W + wx * ws + tx;
  }
};

// Forward shared memory, in floats: q̂ and k̂ (N, hd+1) each, the padded row
// keeping the score loop free of bank conflicts; v (N, hd); scores (N, N+1);
// the 2N row norms. The Python wrapper computes the same size (_smem_bytes).
__host__ __device__ inline size_t fwd_smem_floats(int N, int hd) {
  const size_t n = static_cast<size_t>(N);
  return 2 * n * (hd + 1) + n * hd + n * (N + 1) + 2 * n;
}

// Stages the raw q, k and v of head h of window w into the forward's shared
// memory (q at smem, k after it, both rows hd+1; v (N, hd) after k);
// neighbouring threads read neighbouring channels of one token row.
template <typename T, typename Rows>
__device__ __forceinline__ void fwd_stage(float* smem, const T* __restrict__ qkv,
                                          int N, int C, int hd, long long w,
                                          int h, const Rows& rows) {
  const int ld = hd + 1;
  float* qs = smem;
  float* ks = qs + N * ld;
  float* vs = ks + N * ld;
  for (int i = threadIdx.x; i < N * hd; i += blockDim.x) {
    const int n = i / hd;
    const int d = i - n * hd;
    const T* row = qkv + rows.row(w, n) * 3 * C + static_cast<size_t>(h) * hd + d;
    qs[n * ld + d] = to_f32<T>(row[0]);
    ks[n * ld + d] = to_f32<T>(row[C]);
    vs[i] = to_f32<T>(row[2 * C]);
  }
}

// The forward once fwd_stage (or the entry-fused kernel's projection) has
// put the raw q, k, v of head h of window w in shared memory: steps 2-5
// below. With kStoreP the unrounded f32 softmax is also written to p_out,
// layout (B·nW, h, N, N), at block index w·num_heads + h.
template <typename T, typename O, bool kStoreP, typename Rows>
__device__ void fwd_attend(float* smem, const float* __restrict__ scale,
                           const float* __restrict__ bias16,
                           const float* __restrict__ mask, O* __restrict__ out,
                           float* __restrict__ p_out, int N, int C,
                           int num_heads, int n_win_per_img, long long w, int h,
                           const Rows& rows) {
  const int hd = C / num_heads;
  const int ld = hd + 1;
  float* qs = smem;
  float* ks = qs + N * ld;
  float* vs = ks + N * ld;
  float* ss = vs + N * hd;
  float* rn = ss + N * (N + 1);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  // 2. inverse L2 norms of the q rows and the k rows
  for (int r = tid; r < 2 * N; r += nthr) {
    const float* x = r < N ? qs + r * ld : ks + (r - N) * ld;
    float s2 = 0.f;
    for (int d = 0; d < hd; ++d) s2 = fmaf(x[d], x[d], s2);
    rn[r] = rsqrtf(fmaxf(s2, kEps2));
  }
  __syncthreads();

  for (int i = tid; i < N * hd; i += nthr) {
    const int n = i / hd;
    const int d = i - n * hd;
    qs[n * ld + d] = round_to<T>(qs[n * ld + d] * rn[n]);
    ks[n * ld + d] = round_to<T>(ks[n * ld + d] * rn[N + n]);
  }
  __syncthreads();

  // 3. scores, scaled and biased (and masked), kept in shared memory
  const float sc = scale[h];
  const float* bh = bias16 + static_cast<size_t>(h) * N * N;
  const float* mw =
      mask != nullptr
          ? mask + static_cast<size_t>(w % n_win_per_img) * N * N
          : nullptr;
  for (int i = tid; i < N * N; i += nthr) {
    const int r = i / N;
    const int c = i - r * N;
    const float* qr = qs + r * ld;
    const float* kr = ks + c * ld;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
    float s = acc * sc + bh[i];
    if (mw != nullptr) s += mw[i];
    ss[r * (N + 1) + c] = s;
  }
  __syncthreads();

  // 4. softmax over each score row, one warp per row, max per head; p to
  //    device memory unrounded (kStoreP), round(p) kept for the product
  float* pblk = kStoreP ? p_out + (static_cast<size_t>(w) * num_heads + h) *
                                      N * N
                        : nullptr;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  for (int r = warp; r < N; r += nwarps) {
    float* sr = ss + r * (N + 1);
    float m = -INFINITY;
    for (int c = lane; c < N; c += 32) m = fmaxf(m, sr[c]);
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float e = expf(sr[c] - m);
      sr[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < N; c += 32) {
      const float p = sr[c] / sum;
      if (kStoreP) pblk[r * N + c] = p;
      sr[c] = round_to<T>(p);
    }
  }
  __syncthreads();

  // 5. p·v, written straight into this head's channels of the output row
  for (int i = tid; i < N * hd; i += nthr) {
    const int r = i / hd;
    const int d = i - r * hd;
    const float* pr = ss + r * (N + 1);
    float acc = 0.f;
    for (int c = 0; c < N; ++c) acc = fmaf(pr[c], vs[c * hd + d], acc);
    out[rows.row(w, r) * C + static_cast<size_t>(h) * hd + d] =
        from_f32<O>(acc);
  }
}

// One block per (window, head); blockIdx.x = window·num_heads + head, so
// the heads of one window run in neighbouring blocks and share its rows.
template <typename T, typename O, bool kStoreP, typename Rows>
__global__ void window_attn_fwd_kernel(const T* __restrict__ qkv,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ bias16,
                                       const float* __restrict__ mask,
                                       O* __restrict__ out,
                                       float* __restrict__ p_out, int N,
                                       int C, int num_heads,
                                       int n_win_per_img, Rows rows) {
  extern __shared__ float smem[];
  const long long w = blockIdx.x / num_heads;
  const int h = static_cast<int>(blockIdx.x - w * num_heads);
  // 1. stage this head's q, k, v
  fwd_stage<T>(smem, qkv, N, C, C / num_heads, w, h, rows);
  __syncthreads();
  fwd_attend<T, O, kStoreP>(smem, scale, bias16, mask, out, p_out, N, C,
                            num_heads, n_win_per_img, w, h, rows);
}

template <typename T, typename O, bool kStoreP, typename Rows>
cudaError_t launch_fwd(const void* qkv, const void* scale, const void* bias16,
                       const void* mask, void* out, void* p,
                       long long n_windows, int N, int C, int num_heads,
                       int n_win_per_img, int threads, const Rows& rows,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * fwd_smem_floats(N, C / num_heads);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(n_windows * num_heads);
  window_attn_fwd_kernel<T, O, kStoreP, Rows>
      <<<blocks, threads, smem, stream>>>(
          static_cast<const T*>(qkv), static_cast<const float*>(scale),
          static_cast<const float*>(bias16), static_cast<const float*>(mask),
          static_cast<O*>(out), static_cast<float*>(p), N, C, num_heads,
          n_win_per_img, rows);
  return cudaGetLastError();
}

// The forward's C entry, with or without p, for either row layout. dtype
// codes: 0 = float32, 1 = bfloat16. Returns the launch's cudaGetLastError().
template <bool kStoreP, typename Rows>
int window_attn_fwd_entry(const void* qkv, const void* scale,
                          const void* bias16, const void* mask, void* out,
                          void* p, long long n_windows, int N, int C,
                          int num_heads, int n_win_per_img, int in_dtype,
                          int out_dtype, int threads, const Rows& rows,
                          void* stream) {
  if (n_windows <= 0 || N <= 0 || num_heads <= 0 || C % num_heads != 0 ||
      n_win_per_img <= 0 || threads <= 0 || threads > 1024 ||
      threads % 32 != 0 || n_windows * num_heads > INT_MAX ||
      in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1 ||
      (kStoreP && p == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype * 2 + out_dtype) {
    case 0:
      return launch_fwd<float, float, kStoreP>(
          qkv, scale, bias16, mask, out, p, n_windows, N, C, num_heads,
          n_win_per_img, threads, rows, s);
    case 1:
      return launch_fwd<float, __nv_bfloat16, kStoreP>(
          qkv, scale, bias16, mask, out, p, n_windows, N, C, num_heads,
          n_win_per_img, threads, rows, s);
    case 2:
      return launch_fwd<__nv_bfloat16, float, kStoreP>(
          qkv, scale, bias16, mask, out, p, n_windows, N, C, num_heads,
          n_win_per_img, threads, rows, s);
    default:
      return launch_fwd<__nv_bfloat16, __nv_bfloat16, kStoreP>(
          qkv, scale, bias16, mask, out, p, n_windows, N, C, num_heads,
          n_win_per_img, threads, rows, s);
  }
}

// Second pass of both backwards: out[h, i] = Σ_w partial[w·num_heads + h, i]
// for every column i < cols. Each thread sums a fixed slice of the windows
// and the slices are added in a fixed order, so the sum does not depend on
// the schedule: the same bits on every run, which f32 atomicAdd would not
// give.
__global__ void window_sum_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int n_windows,
                                  int num_heads, int cols) {
  __shared__ float part[kReduceRows][kReduceCols];
  const int h = blockIdx.y;
  const int col = blockIdx.x * kReduceCols + threadIdx.x;
  float acc = 0.f;
  if (col < cols) {
    for (int w = threadIdx.y; w < n_windows; w += kReduceRows)
      acc += partial[(static_cast<size_t>(w) * num_heads + h) * cols + col];
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float total = 0.f;
    for (int r = 0; r < kReduceRows; ++r) total += part[r][threadIdx.x];
    out[static_cast<size_t>(h) * cols + col] = total;
  }
}

inline cudaError_t launch_window_sum(const void* partial, void* out,
                              long long n_windows, int num_heads, int cols,
                              cudaStream_t stream) {
  const dim3 grid((cols + kReduceCols - 1) / kReduceCols, num_heads);
  const dim3 block(kReduceCols, kReduceRows);
  window_sum_kernel<<<grid, block, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out),
      static_cast<int>(n_windows), num_heads, cols);
  return cudaGetLastError();
}

}  // namespace
