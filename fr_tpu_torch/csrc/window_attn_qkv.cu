// Entry-fused cosine window attention for NVIDIA Hopper (sm_90a): the qkv
// projection inside the attention kernel, forward and all-in-kernel
// backward.
//
// Replaces the entry-fused variant of fr_tpu/ops/fused_window_attn_variants.py:
// _pkx_fwd (pallas_call :713) and the all-in-kernel branch of _pkx_bwd_rule
// (pallas_call :835, taken with _PKX_HYBRID_BWD = False). Contract, with x
// (B·nW, N, C) in the compute dtype T, Wt nn.Linear's (3C, C) f32 weight
// (the transpose of fr_tpu's w) and b (3C,) f32:
//   qkv  = round_T(x·round_T(Wt)ᵀ accumulated in f32 + b)     (_pkx_qkv: one
//          rounding, after the f32 bias add)
//   out  = the windows API's attention of qkv (window_attn_fwd.cu)
//   backward, for the output cotangent g rounded to T:
//   dqkv = the recompute backward of qkv (window_attn_bwd.cu), kept in f32
//   dx   = round_T(round_T(dqkv)·round_T(Wt))                  (:634-636)
//   dWt  = Σ round_T(dqkv)ᵀ·x over all token rows, f32         (:637-640)
//   db   = Σ dqkv over all token rows, f32, of the UNROUNDED dqkv (:641);
//          the hybrid backward (the Python wrapper's default) sums the
//          rounded dqkv, so the two routes differ in bf16
//   dscale, dbias as the recompute backward.
//
// Design. The forward runs one block per (window, head), as the windows
// API's forward, and forms this head's 3·hd columns of qkv itself: the x
// window and the head's rows of Wt stream through shared memory in chunks of
// 32 channels (x window and all of W would be 36 KB + 98 KB at C = 256 in
// bf16/f32, too much to hold whole), f32 accumulators in shared memory, one
// rounding at the end. Then the forward body shared with the other
// forwards (fwd_attend, window_attn_common.cuh) runs unchanged, so qkv never
// exists in device memory. The backward kernel recomputes qkv the same way,
// keeps the raw q and k for the L2-norm backward and runs the shared
// recompute-backward body (bwd_attend, window_attn_bwd.cuh), writing dqkv
// in f32 to a scratch buffer. Two products follow as hand-written tiled
// kernels (64×64 tiles, 16 deep, f32 FMAs): dx = round(dqkv)·round(Wt), and
// per chunk of 2,048 token rows a dWt partial with db in its last column.
// The partials and the per-(window, head) dscale/dbias partials are summed
// in a fixed order by window_attn_common.cuh's second pass: the same bits on
// every run, which atomics would not give. Per-window partials would not
// do: a (384, 128) dWt per window at 2,048 windows is 400 MB.
//
// What bounds it on the card: at the AlterNet widths the projection's
// operations (2·3C·C per token row forward, three times that backward), on
// the CUDA cores here, then device-memory bytes (x, g in; out, dx out; dqkv
// through scratch in the backward). Tensor cores for the projection and the
// attention products, and TMA staging, are later steps.

#include "window_attn_bwd.cuh"

namespace {

constexpr int kProjChunk = 32;  // x channels staged per projection step
constexpr int kTile = 64;       // gradient GEMMs: output tile rows and cols
constexpr int kTileK = 16;      // and the depth staged per step
constexpr int kGemmThreads = 256;

// Shared memory of the projection's staging, in floats: an x chunk
// (N, kProjChunk) and the head's 3·hd rows of Wt for it (3·hd, kProjChunk+1,
// padded so that a warp's rows fall in different banks). The Python wrapper
// computes the same size (_qkv_smem_bytes).
__host__ __device__ inline size_t proj_stage_floats(int N, int hd) {
  return static_cast<size_t>(N) * kProjChunk +
         static_cast<size_t>(3 * hd) * (kProjChunk + 1);
}

__host__ __device__ inline size_t qkv_fwd_smem_floats(int N, int hd) {
  return fwd_smem_floats(N, hd) + proj_stage_floats(N, hd);
}

// The recompute backward's memory, the raw q and k (N, hd+1) each, staging.
__host__ __device__ inline size_t qkv_bwd_smem_floats(int N, int hd) {
  return recompute_bwd_smem_floats(N, hd) +
         2 * static_cast<size_t>(N) * (hd + 1) + proj_stage_floats(N, hd);
}

// The raw q, k, v of head h of window w from the projection, in f32 values
// of T: column j < 3·hd of this head is row (j / hd)·C + h·hd + j % hd of
// Wt; q and k go to rows of ld, v to rows of ldv. Each thread owns the same
// outputs in every step, so the accumulators need no synchronisation of
// their own; the caller synchronises before reading them.
template <typename T>
__device__ void proj_stage(float* qs, float* ks, int ld, float* vs, int ldv,
                           float* stage, const T* __restrict__ x,
                           const float* __restrict__ wt,
                           const float* __restrict__ b, int N, int C, int hd,
                           long long w, int h) {
  float* xs = stage;
  float* wsm = stage + N * kProjChunk;
  const int J = 3 * hd;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  auto out = [&](int n, int j) -> float& {
    return j < hd ? qs[n * ld + j]
                  : (j < 2 * hd ? ks[n * ld + j - hd] : vs[n * ldv + j - 2 * hd]);
  };
  auto wrow = [&](int j) -> size_t {
    return static_cast<size_t>(j / hd) * C + static_cast<size_t>(h) * hd +
           j % hd;
  };
  for (int i = tid; i < N * J; i += nthr) out(i / J, i % J) = 0.f;
  const T* xw = x + static_cast<size_t>(w) * N * C;
  for (int c0 = 0; c0 < C; c0 += kProjChunk) {
    const int kc = min(kProjChunk, C - c0);
    __syncthreads();
    for (int i = tid; i < N * kc; i += nthr) {
      const int n = i / kc;
      const int c = i - n * kc;
      xs[n * kProjChunk + c] = to_f32<T>(xw[static_cast<size_t>(n) * C + c0 + c]);
    }
    for (int i = tid; i < J * kc; i += nthr) {
      const int j = i / kc;
      const int c = i - j * kc;
      wsm[j * (kProjChunk + 1) + c] = round_to<T>(wt[wrow(j) * C + c0 + c]);
    }
    __syncthreads();
    for (int i = tid; i < N * J; i += nthr) {
      const int n = i / J;
      const int j = i - n * J;
      const float* xr = xs + n * kProjChunk;
      const float* wr = wsm + j * (kProjChunk + 1);
      float acc = out(n, j);
      for (int c = 0; c < kc; ++c) acc = fmaf(xr[c], wr[c], acc);
      out(n, j) = acc;
    }
  }
  for (int i = tid; i < N * J; i += nthr) {
    const int n = i / J;
    const int j = i - n * J;
    out(n, j) = round_to<T>(out(n, j) + b[wrow(j)]);
  }
}

// One block per (window, head): the projection, then the shared forward.
template <typename T, typename O>
__global__ void window_attn_qkv_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ wt,
    const float* __restrict__ b, const float* __restrict__ scale,
    const float* __restrict__ bias16, const float* __restrict__ mask,
    O* __restrict__ out, int N, int C, int num_heads, int n_win_per_img) {
  extern __shared__ float smem[];
  const long long w = blockIdx.x / num_heads;
  const int h = static_cast<int>(blockIdx.x - w * num_heads);
  const int hd = C / num_heads;
  const int ld = hd + 1;
  float* qs = smem;
  float* ks = qs + N * ld;
  float* vs = ks + N * ld;
  proj_stage<T>(qs, ks, ld, vs, hd, smem + fwd_smem_floats(N, hd), x, wt, b,
                N, C, hd, w, h);
  __syncthreads();
  fwd_attend<T, O, false>(smem, scale, bias16, mask, out, nullptr, N, C,
                          num_heads, n_win_per_img, w, h, WindowRows{N});
}

// One block per (window, head): the projection, then the shared recompute
// backward with dqkv unrounded in f32 to dqkv32 (B·nW·N, 3C).
template <typename T>
__global__ void window_attn_qkv_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ wt,
    const float* __restrict__ b, const float* __restrict__ scale,
    const float* __restrict__ bias16, const float* __restrict__ mask,
    const T* __restrict__ g, float* __restrict__ dqkv32,
    float* __restrict__ partial, int N, int C, int num_heads,
    int n_win_per_img) {
  extern __shared__ float smem[];
  const long long w = blockIdx.x / num_heads;
  const int h = static_cast<int>(blockIdx.x - w * num_heads);
  const int hd = C / num_heads;
  const int ld = hd + 1;
  float* qs = smem;
  float* ks = qs + N * ld;
  float* vs = ks + 3 * N * ld;
  float* gs = vs + N * ld;
  float* raw = smem + recompute_bwd_smem_floats(N, hd);
  proj_stage<T>(qs, ks, ld, vs, ld, raw + 2 * N * ld, x, wt, b, N, C, hd, w,
                h);
  __syncthreads();
  for (int i = threadIdx.x; i < N * hd; i += blockDim.x) {
    const int n = i / hd;
    const int d = i - n * hd;
    raw[n * ld + d] = qs[n * ld + d];
    raw[N * ld + n * ld + d] = ks[n * ld + d];
    gs[n * ld + d] = to_f32<T>(
        g[(static_cast<size_t>(w) * N + n) * C + static_cast<size_t>(h) * hd +
          d]);
  }
  __syncthreads();
  bwd_attend<T, float>(smem, static_cast<const T*>(nullptr), raw, scale,
                       bias16, mask, dqkv32, partial, N, C, num_heads,
                       n_win_per_img, w, h, WindowRows{N});
}

// out(m, n) = Σ_k round_T(A(m, k))·round_T(B[k, n]) over this block's chunk
// of k (blockIdx.z; out advances by out_chunk_stride per chunk), in f32.
// A(m, k) = A[m·lda + k], or A[k·lda + m] with kATrans; B is row-major
// (K, Ncols). With kColSum the blocks of the first column tile also write
// Σ_k A(m, k), unrounded, to column Ncols of out: db beside dWt. 64×64
// output tiles, 256 threads of 4×4 outputs each.
template <typename T, typename TB, typename O, bool kATrans, bool kColSum>
__global__ void proj_grad_gemm_kernel(const float* __restrict__ A,
                                      const TB* __restrict__ B,
                                      O* __restrict__ out, int M, int Ncols,
                                      int K, int lda, int ldb, int ldo,
                                      int k_chunk,
                                      long long out_chunk_stride) {
  static_assert(!kColSum || kATrans, "the column sum reads A transposed");
  __shared__ float As[kTileK][kTile + 1];
  __shared__ float Bs[kTileK][kTile];
  __shared__ float colsum[kGemmThreads / kTile][kTile];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const bool do_sum = kColSum && blockIdx.x == 0;
  float acc[4][4] = {};
  float csum = 0.f;   // Σ A(m0 + tid % 64, k) over this thread's k
  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    for (int e = tid; e < kTileK * kTile; e += kGemmThreads) {
      // neighbouring threads on neighbouring addresses of A
      const int kk = kATrans ? e / kTile : e % kTileK;
      const int mm = kATrans ? e % kTile : e / kTileK;
      const int m = m0 + mm;
      const int k = k0 + kk;
      float a = 0.f;
      if (m < M && k < k_end)
        a = kATrans ? A[static_cast<size_t>(k) * lda + m]
                    : A[static_cast<size_t>(m) * lda + k];
      if (do_sum) csum += a;
      As[kk][mm] = round_to<T>(a);
    }
    for (int e = tid; e < kTileK * kTile; e += kGemmThreads) {
      const int kk = e / kTile;
      const int nn = e % kTile;
      const int k = k0 + kk;
      const int n = n0 + nn;
      Bs[kk][nn] = (k < k_end && n < Ncols)
                       ? round_to<T>(to_f32<TB>(B[static_cast<size_t>(k) * ldb + n]))
                       : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4];
      float bb[4];
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
      for (int j = 0; j < 4; ++j) bb[j] = Bs[kk][tx * 4 + j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
  O* o = out + blockIdx.z * out_chunk_stride;
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Ncols) o[static_cast<size_t>(m) * ldo + n] = from_f32<O>(acc[i][j]);
    }
  }
  if (do_sum) {
    // four threads per column, each over every fourth row of a step
    colsum[tid / kTile][tid % kTile] = csum;
    __syncthreads();
    if (tid < kTile && m0 + tid < M) {
      float s = 0.f;
      for (int r = 0; r < kGemmThreads / kTile; ++r) s += colsum[r][tid];
      o[static_cast<size_t>(m0 + tid) * ldo + Ncols] = s;
    }
  }
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, typename O>
cudaError_t launch_qkv_fwd(const void* x, const void* wt, const void* b,
                           const void* scale, const void* bias16,
                           const void* mask, void* out, long long n_windows,
                           int N, int C, int num_heads, int n_win_per_img,
                           int threads, cudaStream_t stream) {
  const size_t smem = sizeof(float) * qkv_fwd_smem_floats(N, C / num_heads);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(window_attn_qkv_fwd_kernel<T, O>), smem);
  if (err != cudaSuccess) return err;
  window_attn_qkv_fwd_kernel<T, O>
      <<<static_cast<unsigned>(n_windows * num_heads), threads, smem,
         stream>>>(static_cast<const T*>(x), static_cast<const float*>(wt),
                   static_cast<const float*>(b),
                   static_cast<const float*>(scale),
                   static_cast<const float*>(bias16),
                   static_cast<const float*>(mask), static_cast<O*>(out), N, C,
                   num_heads, n_win_per_img);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_qkv_bwd(const void* x, const void* wt, const void* b,
                           const void* scale, const void* bias16,
                           const void* mask, const void* g, void* dx,
                           void* dqkv32, void* partial, void* sums,
                           void* wpartial, void* wsums, long long n_windows,
                           int N, int C, int num_heads, int n_win_per_img,
                           int threads, int chunk_rows, cudaStream_t stream) {
  const size_t smem = sizeof(float) * qkv_bwd_smem_floats(N, C / num_heads);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(window_attn_qkv_bwd_kernel<T>), smem);
  if (err != cudaSuccess) return err;
  window_attn_qkv_bwd_kernel<T>
      <<<static_cast<unsigned>(n_windows * num_heads), threads, smem,
         stream>>>(static_cast<const T*>(x), static_cast<const float*>(wt),
                   static_cast<const float*>(b),
                   static_cast<const float*>(scale),
                   static_cast<const float*>(bias16),
                   static_cast<const float*>(mask), static_cast<const T*>(g),
                   static_cast<float*>(dqkv32), static_cast<float*>(partial),
                   N, C, num_heads, n_win_per_img);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_window_sum(partial, sums, n_windows, num_heads,
                               N * N + 1, stream)) != cudaSuccess)
    return err;
  const int rows = static_cast<int>(n_windows * N);
  const int C3 = 3 * C;
  // dx (rows, C) = round(dqkv)·round(Wt): A (rows, 3C), B = Wt (3C, C)
  const dim3 grid_dx((C + kTile - 1) / kTile, (rows + kTile - 1) / kTile, 1);
  proj_grad_gemm_kernel<T, float, T, false, false>
      <<<grid_dx, kGemmThreads, 0, stream>>>(
          static_cast<const float*>(dqkv32), static_cast<const float*>(wt),
          static_cast<T*>(dx), rows, C, C3, C3, C, C, C3, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // per chunk of rows: dWt (3C, C) = round(dqkv)ᵀ·x, db in column C
  const int n_chunks = (rows + chunk_rows - 1) / chunk_rows;
  const dim3 grid_dw((C + kTile - 1) / kTile, (C3 + kTile - 1) / kTile,
                     n_chunks);
  proj_grad_gemm_kernel<T, T, float, true, true>
      <<<grid_dw, kGemmThreads, 0, stream>>>(
          static_cast<const float*>(dqkv32), static_cast<const T*>(x),
          static_cast<float*>(wpartial), C3, C, rows, C3, C, C + 1,
          chunk_rows, static_cast<long long>(C3) * (C + 1));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_window_sum(wpartial, wsums, n_chunks, 1, C3 * (C + 1),
                           stream);
}

bool qkv_args_ok(long long n_windows, int N, int C, int num_heads,
                 int n_win_per_img, int threads) {
  return n_windows > 0 && N > 0 && num_heads > 0 && C % num_heads == 0 &&
         n_win_per_img > 0 && threads > 0 && threads <= 1024 &&
         threads % 32 == 0 && n_windows * num_heads <= INT_MAX &&
         n_windows * N <= INT_MAX;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; in_dtype is x's (the compute
// dtype), wt and b are f32. Returns the launch's cudaGetLastError(); the
// kernel runs asynchronously on `stream`.
extern "C" int window_attn_qkv_fwd(const void* x, const void* wt,
                                   const void* b, const void* scale,
                                   const void* bias16, const void* mask,
                                   void* out, long long n_windows, int N,
                                   int C, int num_heads, int n_win_per_img,
                                   int in_dtype, int out_dtype, int threads,
                                   void* stream) {
  if (!qkv_args_ok(n_windows, N, C, num_heads, n_win_per_img, threads) ||
      in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype * 2 + out_dtype) {
    case 0:
      return launch_qkv_fwd<float, float>(x, wt, b, scale, bias16, mask, out,
                                          n_windows, N, C, num_heads,
                                          n_win_per_img, threads, s);
    case 1:
      return launch_qkv_fwd<float, __nv_bfloat16>(
          x, wt, b, scale, bias16, mask, out, n_windows, N, C, num_heads,
          n_win_per_img, threads, s);
    case 2:
      return launch_qkv_fwd<__nv_bfloat16, float>(
          x, wt, b, scale, bias16, mask, out, n_windows, N, C, num_heads,
          n_win_per_img, threads, s);
    default:
      return launch_qkv_fwd<__nv_bfloat16, __nv_bfloat16>(
          x, wt, b, scale, bias16, mask, out, n_windows, N, C, num_heads,
          n_win_per_img, threads, s);
  }
}

// The all-in-kernel backward: five launches on `stream`. dtype code: 0 =
// float32, 1 = bfloat16, for x, g and dx. Scratch: dqkv32 (n_windows·N, 3C)
// f32, partial n_windows·num_heads·(N·N + 1) floats, wpartial
// ceil(n_windows·N / chunk_rows)·3C·(C + 1) floats. Results: dx
// (n_windows·N, C); sums (num_heads, N·N + 1) with dbias in the first N·N
// columns and dscale in the last; wsums (3C, C + 1) with dWt in the first C
// columns and db in the last.
extern "C" int window_attn_qkv_bwd(const void* x, const void* wt,
                                   const void* b, const void* scale,
                                   const void* bias16, const void* mask,
                                   const void* g, void* dx, void* dqkv32,
                                   void* partial, void* sums, void* wpartial,
                                   void* wsums, long long n_windows, int N,
                                   int C, int num_heads, int n_win_per_img,
                                   int dtype, int threads, int chunk_rows,
                                   void* stream) {
  if (!qkv_args_ok(n_windows, N, C, num_heads, n_win_per_img, threads) ||
      dtype < 0 || dtype > 1 || chunk_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_qkv_bwd<float>(x, wt, b, scale, bias16, mask, g, dx, dqkv32,
                                 partial, sums, wpartial, wsums, n_windows, N,
                                 C, num_heads, n_win_per_img, threads,
                                 chunk_rows, s);
  return launch_qkv_bwd<__nv_bfloat16>(
      x, wt, b, scale, bias16, mask, g, dx, dqkv32, partial, sums, wpartial,
      wsums, n_windows, N, C, num_heads, n_win_per_img, threads, chunk_rows,
      s);
}
