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
// Design. The forward has two bodies, chosen by the Python wrapper
// (fused_window_attn_variants.py, _qkv_tc_route), each with its own entry
// and counted on fused_window_attn.route_launches by body:
//  - window_attn_qkv_fwd_tc (bf16, N ≤ 64, an even head dim ≤ 64, C a
//    multiple of 16, its shared memory within 227 KB: every AlterNet50
//    site). A CTA holds one head h and walks a run of windows under the
//    row-1 kernel's plan (TcPlan, window_attn_tc.cuh): the windows of one
//    mask slice when masked, one wave of CTAs from the occupancy API. It
//    stages the head's 3·hd rows of Wt once, rounded to bf16 as _project's
//    w.to(cd), with a row stride of C + 8 so that ldmatrix reads them
//    without bank conflicts (26, 51 and 100 KB at C = 128, 256, 512). The
//    CTA runs several windows at once in window lanes of NT warps, which
//    share W and the bias tiles: a one-warp CTA per N = 9 window would
//    leave an SM two warps, as W's slice admits two such CTAs. The wrapper
//    picks the lanes that keep the most warps resident (the occupancy API
//    per lane count). Per window a lane's x window (N, C) lands by cp.async
//    (issued during the previous window's attention), warp i projects
//    query rows 16i..16i+15 of q, k and v with mma.sync.m16n8k16 (bf16 →
//    f32, C/16 k-steps), adds b in f32 and rounds once into the row-1
//    kernel's q, k, v stage tiles; then the row-1 tensor-core body runs
//    unchanged (tc_normalize, tc_scores, tc_softmax, tc_to_operand,
//    tc_times_tile, tc_store_rows). qkv never exists in device memory, and
//    W is read once per CTA, not once per (window, head).
//  - window_attn_qkv_fwd (bf16 beyond the tile, or f32): one block per
//    (window, head), as the windows API's CUDA-core
//    forward; it forms this head's 3·hd columns of qkv itself, the x
//    window and the head's rows of Wt streaming through shared memory in
//    chunks of 32 channels, f32 accumulators in shared memory, one rounding
//    at the end, then the forward body shared with the other forwards
//    (fwd_attend, window_attn_common.cuh).
// The all-in-kernel backward has two bodies too, chosen by the wrapper
// (_qkv_bwd_tc_route) and counted on route_launches as "bwd_tensor_cores"
// or "bwd_cuda_cores":
//  - window_attn_qkv_bwd_tc (bf16 on the same tile, its one-lane CTA within
//    227 KB: every AlterNet50 site), six launches. (1)
//    window_attn_qkv_bwd_tc_kernel: a CTA holds head h and walks a run of
//    windows under TcPlan in window lanes, as the tensor-core forward does;
//    it stages the head's bf16 slice of W and b once. Per window a lane's x
//    and g windows land by cp.async (the next ones during this window's
//    attention; g in two tiles), warp i projects query rows 16i.. with
//    mma.sync into the raw q, k, v tiles, and the row-2 kernel's recompute
//    backward follows: tc_normalize, then the per-window body that both
//    kernels call (tc_bwd_window, window_attn_tc.cuh) with the lane's
//    barrier in place of the CTA's and a hook that sees dq, dk and dv in
//    f32, and at the end tc_store_partial's dbias and dscale; a launch
//    bound of 384 threads at N > 32 holds its registers to 168, so that
//    four lanes of N = 36 fit an SM's register file (the wrapper picks the
//    lanes by the occupancy API, as for the forward). The f32
//    dq, dk and dv fragments are summed by column into the lane's db sum
//    (the two rows of a thread, the warp's rows by shuffles, the warps,
//    then the lane's windows in order) before they are rounded once into a
//    bf16 dqkv (rows, 3C): the round(dqkv) that dx and dW take, so no f32
//    dqkv goes through device memory. Each lane writes one partial row
//    (dbias, dscale, db). (2) window_sum_kernel adds the rows in a fixed
//    order. (3) window_attn_qkv_round_kernel rounds Wt to bf16 once, as
//    fr_tpu's kernel does (wT.astype(compute)). (4, 5)
//    window_attn_qkv_grad_mma_kernel, one mma.sync.m16n8k16 product for
//    both: dx = round(dqkv·W16) and, per chunk of token rows, an f32 dWt
//    partial = dqkvᵀ·x; 128 × 64 tiles of 8 warps, 32-deep k tiles by
//    16-byte cp.async in two stages, the chunk sized so the grid fills the
//    card. (6) window_sum_kernel adds the dWt partials in a fixed order.
//    The sums are the same bits on every run; no atomics.
//  - window_attn_qkv_bwd (bf16 beyond the tile, or f32), five
//    launches: the recompute as the CUDA-core forward, the shared recompute
//    backward body (bwd_attend, window_attn_bwd.cuh) writing dqkv in f32 to
//    scratch, then proj_grad_gemm_kernel (64×64 tiles, 16 deep, f32 FMAs)
//    for dx and, per chunk of 2,048 token rows, a dWt partial with db in
//    its last column; window_sum_kernel for the partials.
//
// What bounds it on the card: the projection's operations. The forward
// does 2·3C·C per token row, the backward three times that (the recompute,
// dx, dW), 87 GFLOP a product over the twelve AlterNet50 sites of one call:
// 0.09 ms each at the tensor cores' peak, against some 1 GB of x, g, dx and
// bf16 dqkv (0.3 ms at 3.35 TB/s). On the CUDA cores the scalar projection
// (two shared-memory reads per FMA) bounded both bodies; the tensor-core
// bodies keep W resident per CTA and issue mma.sync, and the backward's
// attention body is the row-2 kernel's.

#include "window_attn_bwd.cuh"
#include "window_attn_tc.cuh"

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


// ---------------------------------------------------------------------------
// The bf16 forward on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMaxLanes = 15;  // named barriers 1..15 (0 is __syncthreads')

// Shared memory of the tensor-core forward, in bytes. Shared by the CTA:
// the f32 bias (and mask) tiles (N, NP + 8) and the head's 3·HDP values of
// b; a bf16 zero row (HDP + 8) and the head's slice of Wt (3·HDP, C + 8).
// Per window lane: the q, k, v stage tiles (N, HDP + 8) of the row-1
// kernel and one x window (N, C + 8). Every part is a multiple of 16
// bytes. The Python wrapper computes the same size (_qkv_tc_smem_bytes).
inline size_t qkv_tc_smem_bytes(int N, int C, int hd, bool masked,
                                int lanes) {
  const int np = 16 * tc_tiles(N);
  const size_t hdp = 16 * tc_tiles(hd);
  const size_t ld = tc_ld(hd);
  const size_t ldx = static_cast<size_t>(C) + 8;
  return 4 * (static_cast<size_t>(tc_bias_floats(N, np, masked)) + 3 * hdp) +
         2 * (ld + 3 * hdp * ldx + lanes * (3 * N * ld + N * ldx));
}

// Barrier of the nthreads threads of window lane `lane`.
__device__ __forceinline__ void lane_sync(int lane, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + lane), "r"(nthreads)
               : "memory");
}

// The head's slice of Wt into ws (3·HDP, C + 8) bf16, rounded to nearest
// even as _project's w.to(cd): slice row m·HDP + d is Wt row m·C + h·hd + d
// for d < hd (m = 0, 1, 2 for q, k, v) and zero past it, so the padded
// columns of q, k and v come out zero. b's matching values go to bs (zero
// past hd). 16-byte loads: C is a multiple of 16 and Wt 16-byte aligned.
template <int DT>
__device__ __forceinline__ void qkv_tc_stage_weights(
    __nv_bfloat16* ws, float* bs, const float* __restrict__ wt,
    const float* __restrict__ b, int C, int hd, int h) {
  constexpr int HDP = 16 * DT;
  const int ldx = C + 8;
  const int c4 = C / 4;
  const int total = 3 * HDP * c4;
#pragma unroll 4
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / c4;
    const int c = 4 * (i - r * c4);
    const int m = r / HDP;
    const int d = r - m * HDP;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (d < hd)
      v = *reinterpret_cast<const float4*>(
          wt + (static_cast<size_t>(m) * C + static_cast<size_t>(h) * hd + d) *
                   C +
          c);
    *reinterpret_cast<uint2*>(ws + r * ldx + c) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
  for (int i = threadIdx.x; i < 3 * HDP; i += blockDim.x) {
    const int m = i / HDP;
    const int d = i - m * HDP;
    bs[i] = d < hd ? b[static_cast<size_t>(m) * C + static_cast<size_t>(h) * hd + d]
                   : 0.f;
  }
}

// Issues the 16-byte cp.async copies of window w's x (N, C) into xs
// (N, C + 8), spread over the nthreads threads of a lane (tid among them).
__device__ __forceinline__ void qkv_tc_stage_x(
    __nv_bfloat16* xs, const __nv_bfloat16* __restrict__ x, int N, int C,
    long long w, int tid, int nthreads) {
  const int cpr = C / 8;
  const __nv_bfloat16* src = x + static_cast<size_t>(w) * N * C;
  for (int i = tid; i < N * cpr; i += nthreads) {
    const int n = i / cpr;
    const int e = 8 * (i - n * cpr);
    cp_async<16>(xs + n * (C + 8) + e, src + static_cast<size_t>(n) * C + e);
  }
}

// The warp's 16 rows (row0..) of q, k and v: acc = x·Wsliceᵀ over C/16
// k-steps, 6·DT accumulator tiles of 16 × 8 (tile j is slice rows
// 8j..8j+7: matrix j / 2DT, head columns 8·(j mod 2DT)..), then
// round(acc + b) into the q, k, v tiles (rows of ld; k and v follow q at
// N·ld). Query rows past N read row N − 1 and are not stored.
template <int DT>
__device__ __forceinline__ void qkv_tc_project(
    __nv_bfloat16* qs, const __nv_bfloat16* xs, const __nv_bfloat16* ws,
    const float* bs, int ld, int ldx, int row0, int N, int C) {
  constexpr int HDP = 16 * DT;
  constexpr int NJ = 6 * DT;
  const int lane = threadIdx.x & 31;
  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const __nv_bfloat16* ap =
      xs + min(row0 + (lane & 15), N - 1) * ldx + (lane >> 4) * 8;
  const __nv_bfloat16* bp = ws + ((lane & 7) + ((lane >> 4) << 3)) * ldx +
                            ((lane >> 3) & 1) * 8;
#pragma unroll 2
  for (int k0 = 0; k0 < C; k0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, ap + k0);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t f[4];
      ldsm_x4(f, bp + 8 * j * ldx + k0);
      mma_bf16(acc[j], a, f[0], f[1]);
      mma_bf16(acc[j + 1], a, f[2], f[3]);
    }
  }
  const int r0 = row0 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int m = j / (2 * DT);
    const int d = 8 * (j - m * 2 * DT) + c0;
    const float2 bb = *reinterpret_cast<const float2*>(bs + m * HDP + d);
    __nv_bfloat16* t = qs + m * N * ld + d;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(t + r0 * ld) =
          pack_bf16(acc[j][0] + bb.x, acc[j][1] + bb.y);
    if (r0 + 8 < N)
      *reinterpret_cast<uint32_t*>(t + (r0 + 8) * ld) =
          pack_bf16(acc[j][2] + bb.x, acc[j][3] + bb.y);
  }
}

// The tensor-core forward: one CTA per (run of windows, head), blockIdx.x
// = CTA·num_heads + head, in window lanes of NT warps (blockDim.x / 32NT
// lanes). The lanes share the head's W slice, b and the bias (and mask)
// tiles, staged once; lane l takes windows l, l + lanes, ... of the run,
// with barriers of its own. x bf16 (B·nW, N, C); out bf16 (out_bf16) or
// f32. A lane's next x window is in flight from the end of this window's
// projection (its x buffer is then free) through the attention.
template <int NT, int DT>
__global__ void window_attn_qkv_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ wt,
    const float* __restrict__ b, const float* __restrict__ scale,
    const float* __restrict__ bias16, const float* __restrict__ mask,
    void* __restrict__ out, bool out_bf16, int N, int C, int num_heads,
    TcPlan plan) {
  constexpr int NP = 16 * NT;
  constexpr int HDP = 16 * DT;
  constexpr int ld = HDP + 8;
  constexpr int LT = 32 * NT;  // threads of a lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = C / num_heads;
  const int ldx = C + 8;
  const int lanes = static_cast<int>(blockDim.x) / LT;
  const int lane = static_cast<int>(threadIdx.x) / LT;
  const int ltid = static_cast<int>(threadIdx.x) - lane * LT;
  const int h = static_cast<int>(blockIdx.x % num_heads);
  const long long cta = blockIdx.x / num_heads;
  const int j = static_cast<int>(cta / plan.ipc);
  const long long r_first = (cta - j * plan.ipc) * plan.wpc;
  const int nwin = static_cast<int>(
      min(static_cast<long long>(plan.wpc), plan.R - r_first));

  float* bias_s = reinterpret_cast<float*>(smem_raw);
  float* mask_s = mask != nullptr ? bias_s + N * (NP + 8) : nullptr;
  float* b_s = bias_s + tc_bias_floats(N, NP, mask != nullptr);
  __nv_bfloat16* zero_row = reinterpret_cast<__nv_bfloat16*>(b_s + 3 * HDP);
  __nv_bfloat16* ws = zero_row + ld;
  __nv_bfloat16* qs = ws + 3 * HDP * ldx + lane * (3 * N * ld + N * ldx);
  __nv_bfloat16* ks = qs + N * ld;
  const __nv_bfloat16* vs = ks + N * ld;
  __nv_bfloat16* xs = qs + 3 * N * ld;

  auto window = [&](int s) { return (r_first + s) * plan.G + j; };
  if (lane < nwin) {
    qkv_tc_stage_x(xs, x, N, C, window(lane), ltid, LT);
    cp_async_commit();
  }
  tc_zero(zero_row, ld / 8);
  qkv_tc_stage_weights<DT>(ws, b_s, wt, b, C, hd, h);
  tc_stage_bias(bias_s, mask_s, bias16 + static_cast<size_t>(h) * N * N,
                mask != nullptr ? mask + static_cast<size_t>(j) * N * N
                                : nullptr,
                N, NP);
  __syncthreads();
  const float sc = scale[h];
  const int row0 = 16 * (ltid >> 5);

  for (int s = lane; s < nwin; s += lanes) {
    cp_async_wait<0>();
    lane_sync(lane, LT);  // x landed; q, k, v free (the last attention)
    qkv_tc_project<DT>(qs, xs, ws, b_s, ld, ldx, row0, N, C);
    lane_sync(lane, LT);  // q, k, v written; x free
    if (s + lanes < nwin) {
      qkv_tc_stage_x(xs, x, N, C, window(s + lanes), ltid, LT);
      cp_async_commit();
    }
    tc_normalize(qs, ks, qs, ks, nullptr, nullptr, N, hd, ld, ltid, LT);
    lane_sync(lane, LT);

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
                      WindowRows{N});
  }
}

template <int NT, int DT>
cudaError_t qkv_tc_allow(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(window_attn_qkv_fwd_tc_kernel<NT, DT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int NT, int DT>
cudaError_t launch_qkv_fwd_tc(const void* x, const void* wt, const void* b,
                              const void* scale, const void* bias16,
                              const void* mask, void* out, bool out_bf16,
                              int N, int C, int num_heads, int lanes,
                              const TcPlan& plan, cudaStream_t stream) {
  const size_t smem =
      qkv_tc_smem_bytes(N, C, C / num_heads, mask != nullptr, lanes);
  const cudaError_t err = qkv_tc_allow<NT, DT>(smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>(plan.G * plan.ipc * num_heads);
  window_attn_qkv_fwd_tc_kernel<NT, DT><<<blocks, 32 * NT * lanes, smem,
                                          stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(wt),
      static_cast<const float*>(b), static_cast<const float*>(scale),
      static_cast<const float*>(bias16), static_cast<const float*>(mask),
      out, out_bf16, N, C, num_heads, plan);
  return cudaGetLastError();
}

template <int NT, int DT>
cudaError_t qkv_tc_occupancy(int* ctas, int N, int C, int hd, bool masked,
                             int lanes) {
  const size_t smem = qkv_tc_smem_bytes(N, C, hd, masked, lanes);
  const cudaError_t err = qkv_tc_allow<NT, DT>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, window_attn_qkv_fwd_tc_kernel<NT, DT>, 32 * NT * lanes, smem);
}

bool qkv_tc_args_ok(long long n_windows, int N, int C, int num_heads,
                    int n_win_per_img, int wpc, int lanes, bool masked) {
  return tc_args_ok(n_windows, N, C, num_heads, n_win_per_img, wpc, 4, {}) &&
         C % 16 == 0 && lanes >= 1 && lanes <= kMaxLanes &&
         32 * tc_tiles(N) * lanes <= 1024 &&
         qkv_tc_smem_bytes(N, C, C / num_heads, masked, lanes) <= 227 * 1024;
}


// ---------------------------------------------------------------------------
// The bf16 all-in-kernel backward on the tensor cores
// ---------------------------------------------------------------------------

// Per window lane of the tensor-core backward: f32 values (the norms and
// flags of the q and k rows, 4·NP; the warps' column sums of one window's
// dq, dk, dv, NT·3·HDP; the lane's db sum, 3·HDP) and bf16 values (q̂, k̂,
// the raw q, k, v and two g tiles (N, HDP + 8); the round(p) and
// round(ds·scale) tiles (NP, NP + 8); one x window (N, C + 8)).
__host__ __device__ inline int qkv_bwd_lane_floats(int nt, int dt) {
  return 4 * 16 * nt + (nt + 1) * 3 * 16 * dt;
}

__host__ __device__ inline int qkv_bwd_lane_elems(int N, int C, int nt,
                                                  int hd) {
  return 7 * N * tc_ld(hd) + 2 * 16 * nt * (16 * nt + 8) + N * (C + 8);
}

// Shared memory of the tensor-core backward, in bytes: the forward's shared
// part (bias and mask tiles, the head's b, a zero row, the head's slice of
// Wt) and `lanes` window lanes. Every part is a multiple of 16 bytes. The
// Python wrapper computes the same size (_qkv_bwd_tc_smem_bytes).
inline size_t qkv_bwd_tc_smem_bytes(int N, int C, int hd, bool masked,
                                    int lanes) {
  const int nt = tc_tiles(N);
  const int dt = tc_tiles(hd);
  const size_t hdp = 16 * dt;
  const size_t ldx = static_cast<size_t>(C) + 8;
  return 4 * (static_cast<size_t>(tc_bias_floats(N, 16 * nt, masked)) +
              3 * hdp +
              static_cast<size_t>(lanes) * qkv_bwd_lane_floats(nt, dt)) +
         2 * (tc_ld(hd) + 3 * hdp * ldx +
              static_cast<size_t>(lanes) * qkv_bwd_lane_elems(N, C, nt, hd));
}

// Issues the cp.async copies of head h's columns of window w's g (N, C)
// into gs (N, ld), over the nthreads threads of a lane: 16-byte copies
// when vec16 (hd a multiple of 8, g 16-byte aligned), else 4-byte ones.
__device__ __forceinline__ void qkv_tc_stage_g(
    __nv_bfloat16* gs, const __nv_bfloat16* __restrict__ g, int N, int C,
    int hd, int ld, long long w, int h, bool vec16, int tid, int nthreads) {
  const __nv_bfloat16* src =
      g + static_cast<size_t>(w) * N * C + static_cast<size_t>(h) * hd;
  const int per = vec16 ? 8 : 2;  // bf16 values a copy
  const int cpr = hd / per;
  for (int i = tid; i < N * cpr; i += nthreads) {
    const int n = i / cpr;
    const int e = per * (i - n * cpr);
    if (vec16)
      cp_async<16>(gs + n * ld + e, src + static_cast<size_t>(n) * C + e);
    else
      cp_async<4>(gs + n * ld + e, src + static_cast<size_t>(n) * C + e);
  }
}

// The warp's 16 rows of a 16 × HDP accumulator summed by column into
// red[0, HDP): each thread adds its two rows, the eight row groups of the
// warp are added by shuffles (every lane takes part), lanes 0..3 write.
// Rows past N hold zeros.
template <int DT>
__device__ __forceinline__ void qkv_tc_colsum(const float (&acc)[2 * DT][4],
                                              float* red) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nd = 0; nd < 2 * DT; ++nd) {
    float s0 = acc[nd][0] + acc[nd][2];
    float s1 = acc[nd][1] + acc[nd][3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (lane < 4)
      *reinterpret_cast<float2*>(red + 8 * nd + 2 * lane) =
          make_float2(s0, s1);
  }
}

// The most threads a CTA of the tensor-core backward takes, its launch
// bound: 384 for N > 32 (NT 3 and 4), which caps the registers at 168 so
// that four lanes of N = 36 fit the register file; 256 below.
__host__ __device__ constexpr int qkv_bwd_max_threads(int nt) {
  return nt >= 3 ? 384 : 256;
}

// The tensor-core all-in-kernel backward: one CTA per (run of windows,
// head), blockIdx.x = CTA·num_heads + head, in window lanes of NT warps
// (blockDim.x / 32NT lanes) that share the head's W slice, b and the bias
// (and mask) tiles. Lane l takes windows l, l + lanes, ... of the run:
// the projection (qkv_tc_project), then the row-2 kernel's per-window body
// (window_attn_tc.cuh, tc_bwd_window) with the lane's barrier; dq, dk, dv
// go to dqkv (rows, 3C) as bf16 after their column sums are added to the
// lane's db. Lane l of CTA c writes partial row
// (c·lanes + l)·num_heads + h of N·N + 1 + 3·hd floats: dbias, Σ ds·s_raw,
// then db of the head's q, k and v columns. g16: 16-byte copies of g.
template <int NT, int DT>
__global__ void __launch_bounds__(qkv_bwd_max_threads(NT))
    window_attn_qkv_bwd_tc_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ wt,
    const float* __restrict__ b, const float* __restrict__ scale,
    const float* __restrict__ bias16, const float* __restrict__ mask,
    const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ dqkv,
    float* __restrict__ partial, int N, int C, int num_heads, bool g16,
    TcPlan plan) {
  constexpr int NP = 16 * NT;
  constexpr int HDP = 16 * DT;
  constexpr int LDP = NP + 8;
  constexpr int ld = HDP + 8;
  constexpr int LT = 32 * NT;  // threads of a lane
  constexpr int LF = 4 * NP + (NT + 1) * 3 * HDP;  // qkv_bwd_lane_floats
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = C / num_heads;
  const int ldx = C + 8;
  const int lanes = static_cast<int>(blockDim.x) / LT;
  const int lane = static_cast<int>(threadIdx.x) / LT;
  const int ltid = static_cast<int>(threadIdx.x) - lane * LT;
  const int h = static_cast<int>(blockIdx.x % num_heads);
  const long long cta = blockIdx.x / num_heads;
  const int j = static_cast<int>(cta / plan.ipc);
  const long long r_first = (cta - j * plan.ipc) * plan.wpc;
  const int nwin = static_cast<int>(
      min(static_cast<long long>(plan.wpc), plan.R - r_first));

  float* bias_s = reinterpret_cast<float*>(smem_raw);
  float* mask_s = mask != nullptr ? bias_s + N * LDP : nullptr;
  float* b_s = bias_s + tc_bias_floats(N, NP, mask != nullptr);
  float* lanes_f32 = b_s + 3 * HDP;
  float* rn = lanes_f32 + lane * LF;  // q rows, then k rows
  float* act = rn + 2 * NP;
  float* red = act + 2 * NP;          // warp k's column sums at k·3·HDP
  float* dbl = red + NT * 3 * HDP;    // the lane's db: q, k, v columns
  __nv_bfloat16* zero_row =
      reinterpret_cast<__nv_bfloat16*>(lanes_f32 + lanes * LF);
  __nv_bfloat16* ws = zero_row + ld;
  const int le = qkv_bwd_lane_elems(N, C, NT, hd);
  __nv_bfloat16* lanes_bf16 = ws + 3 * HDP * ldx;
  __nv_bfloat16* qn = lanes_bf16 + lane * le;  // round(q̂), (N, ld)
  __nv_bfloat16* kn = qn + N * ld;             // round(k̂)
  __nv_bfloat16* qs = kn + N * ld;             // raw q, k, v
  __nv_bfloat16* ks = qs + N * ld;
  const __nv_bfloat16* vs = ks + N * ld;
  __nv_bfloat16* gbuf = qs + 3 * N * ld;       // two g tiles
  __nv_bfloat16* pt = gbuf + 2 * N * ld;       // round(p), (NP, NP + 8)
  __nv_bfloat16* dt = pt + NP * LDP;           // round(ds·scale)
  __nv_bfloat16* xs = dt + NP * LDP;           // x window (N, C + 8)

  // zeros: the padded columns of q̂, k̂ and g stay zero, the db sums start
  // at zero; then the first windows' copies, W, b and the bias tiles
  tc_zero(zero_row, ld / 8);
  for (int l = 0; l < lanes; ++l) {
    tc_zero(lanes_f32 + l * LF, LF / 4);
    tc_zero(lanes_bf16 + l * le, 7 * N * ld / 8);
  }
  __syncthreads();
  auto window = [&](int s) { return (r_first + s) * plan.G + j; };
  if (lane < nwin) {
    qkv_tc_stage_x(xs, x, N, C, window(lane), ltid, LT);
    qkv_tc_stage_g(gbuf, g, N, C, hd, ld, window(lane), h, g16, ltid, LT);
    cp_async_commit();
  }
  qkv_tc_stage_weights<DT>(ws, b_s, wt, b, C, hd, h);
  tc_stage_bias(bias_s, mask_s, bias16 + static_cast<size_t>(h) * N * N,
                mask != nullptr ? mask + static_cast<size_t>(j) * N * N
                                : nullptr,
                N, NP);
  __syncthreads();
  const float sc = scale[h];
  const int wl = threadIdx.x & 31;
  const int warp = ltid >> 5;  // warp within the lane
  const int row0 = 16 * warp;
  const int r0 = row0 + (wl >> 2);
  const int c0 = 2 * (wl & 3);
  const size_t head_off = static_cast<size_t>(h) * hd;
  const size_t C3 = 3 * static_cast<size_t>(C);
  const WindowRows rows{N};
  const auto sync = [&] { lane_sync(lane, LT); };

  float dbias[2 * NT][4] = {};
  float dscale = 0.f;

  for (int s = lane, it = 0; s < nwin; s += lanes, ++it) {
    const __nv_bfloat16* gs = gbuf + (it & 1) * N * ld;
    const long long w = window(s);
    cp_async_wait<0>();
    lane_sync(lane, LT);  // x and g landed; the last window's tiles free
    qkv_tc_project<DT>(qs, xs, ws, b_s, ld, ldx, row0, N, C);
    lane_sync(lane, LT);  // raw q, k, v written; x and the other g free
    if (s + lanes < nwin) {
      qkv_tc_stage_x(xs, x, N, C, window(s + lanes), ltid, LT);
      qkv_tc_stage_g(gbuf + ((it + 1) & 1) * N * ld, g, N, C, hd, ld,
                     window(s + lanes), h, g16, ltid, LT);
      cp_async_commit();
    }
    tc_normalize(qs, ks, qn, kn, rn, act, N, hd, ld, ltid, LT);
    lane_sync(lane, LT);

    float* wred = red + warp * 3 * HDP;
    tc_bwd_window<NT, DT>(
        dbias, dscale, qs, ks, vs, gs, qn, kn, pt, dt, zero_row, rn, act,
        bias_s, mask_s, sc, dqkv, C, C3, head_off, warp, row0, r0, c0, N, hd,
        w, rows, sync,
        [&](const float (&acc)[2 * DT][4], int m) {
          qkv_tc_colsum<DT>(acc, wred + m * HDP);
        });
    sync();  // every warp's column sums
    for (int c = ltid; c < 3 * HDP; c += LT) {
      float t = 0.f;
      for (int k = 0; k < NT; ++k) t += red[k * 3 * HDP + c];
      dbl[c] += t;
    }
  }

  // the lane's partial row: db (a thread reads back only the dbl values it
  // wrote), then, once red is free, dbias and Σ ds·s_raw
  const int cols = N * N + 1 + 3 * hd;
  float* prow =
      partial +
      (static_cast<size_t>(cta * lanes + lane) * num_heads + h) * cols;
  for (int c = ltid; c < 3 * HDP; c += LT) {
    const int m = c / HDP;
    const int d = c - m * HDP;
    if (d < hd) prow[N * N + 1 + m * hd + d] = dbl[c];
  }
  sync();
  tc_store_partial<NT>(dbias, dscale, prow, red, warp, r0, c0, N, ltid, sync);
}

// W (3C, C) f32 → bf16, rounded to nearest even, four values a thread.
__global__ void window_attn_qkv_round_kernel(const float* __restrict__ w,
                                             __nv_bfloat16* __restrict__ out,
                                             long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(w)[i];
    reinterpret_cast<uint2*>(out)[i] =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

constexpr int kMmaBM = 128;  // the products' CTA tile: rows,
constexpr int kMmaBN = 64;   // columns,
constexpr int kMmaBK = 32;   // and the depth staged per step
constexpr int kMmaThreads = 256;

// A 16-byte cp.async, or 16 zero bytes where !valid (source size 0; src
// must still be a valid address).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// out(m, n) = Σ_k A(m, k)·B(k, n) over this CTA's chunk of k (blockIdx.z),
// bf16 operands and f32 sums by mma.sync.m16n8k16. A(m, k) = A[m·lda + k],
// or A[k·lda + m] with kATrans; B(k, n) = B[k·ldb + n]. A CTA computes one
// kMmaBM × kMmaBN tile (blockIdx.y, blockIdx.x) in 8 warps of 32 × 32;
// kMmaBK-deep tiles of A and B land by 16-byte cp.async in two stages
// (zeros past M, Ncols and the chunk's end) and are read by ldmatrix (.trans
// where the operand is stored k-major). out is bf16 (out_bf16, rounded once)
// or f32 with row stride ldo, chunk z at out + z·out_chunk_stride. M (with
// kATrans), K (without), Ncols, lda and ldb are multiples of 8; A and B
// 16-byte aligned.
template <bool kATrans>
__global__ void __launch_bounds__(kMmaThreads)
    window_attn_qkv_grad_mma_kernel(const __nv_bfloat16* __restrict__ A,
                                    const __nv_bfloat16* __restrict__ B,
                                    void* __restrict__ out, bool out_bf16,
                                    int M, int Ncols, int K, int lda,
                                    int ldb, int ldo, int k_chunk,
                                    long long out_chunk_stride) {
  constexpr int LDA = kATrans ? kMmaBM + 8 : kMmaBK + 8;
  constexpr int A_ELEMS = kATrans ? kMmaBK * LDA : kMmaBM * LDA;
  constexpr int LDB = kMmaBN + 8;
  constexpr int B_ELEMS = kMmaBK * LDB;
  __shared__ __align__(16) __nv_bfloat16 As[2][A_ELEMS];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][B_ELEMS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32;  // the warp's 32 × 32 of the tile
  const int wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * kMmaBM;
  const int n0 = blockIdx.x * kMmaBN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int nk = (k_end - k_begin + kMmaBK - 1) / kMmaBK;

  auto load = [&](int stage, int k0) {
    __nv_bfloat16* as = As[stage];
    __nv_bfloat16* bs = Bs[stage];
#pragma unroll
    for (int i = tid; i < kMmaBM * kMmaBK / 8; i += kMmaThreads) {
      int m, k, dst;
      if (kATrans) {  // rows of k, 8 values of m a copy
        const int kk = i / (kMmaBM / 8);
        const int mm = 8 * (i - kk * (kMmaBM / 8));
        m = m0 + mm;
        k = k0 + kk;
        dst = kk * LDA + mm;
      } else {  // rows of m, 8 values of k a copy
        const int mm = i / (kMmaBK / 8);
        const int kk = 8 * (i - mm * (kMmaBK / 8));
        m = m0 + mm;
        k = k0 + kk;
        dst = mm * LDA + kk;
      }
      const bool ok = m < M && k < k_end;
      const size_t off = kATrans ? static_cast<size_t>(k) * lda + m
                                 : static_cast<size_t>(m) * lda + k;
      cp_async16_zfill(as + dst, ok ? A + off : A, ok);
    }
#pragma unroll
    for (int i = tid; i < kMmaBK * kMmaBN / 8; i += kMmaThreads) {
      const int kk = i / (kMmaBN / 8);
      const int nn = 8 * (i - kk * (kMmaBN / 8));
      const int k = k0 + kk;
      const int n = n0 + nn;
      const bool ok = k < k_end && n < Ncols;
      cp_async16_zfill(bs + kk * LDB + nn,
                       ok ? B + static_cast<size_t>(k) * ldb + n : B, ok);
    }
  };

  float acc[2][4][4] = {};
  if (nk > 0) load(0, k_begin);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load((kt + 1) & 1, k_begin + (kt + 1) * kMmaBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* as = As[kt & 1];
    const __nv_bfloat16* bs = Bs[kt & 1];
#pragma unroll
    for (int ks = 0; ks < kMmaBK; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int im = 0; im < 2; ++im) {
        if (kATrans)
          ldsm_x4_t(a[im], as + (ks + (lane & 7) + ((lane >> 4) << 3)) * LDA +
                               wm + 16 * im + ((lane >> 3) & 1) * 8);
        else
          ldsm_x4(a[im], as + (wm + 16 * im + (lane & 15)) * LDA + ks +
                             (lane >> 4) * 8);
      }
#pragma unroll
      for (int jn = 0; jn < 4; jn += 2) {
        uint32_t f[4];
        ldsm_x4_t(f, bs + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB +
                         wn + 8 * jn + (lane >> 4) * 8);
#pragma unroll
        for (int im = 0; im < 2; ++im) {
          mma_bf16(acc[im][jn], a[im], f[0], f[1]);
          mma_bf16(acc[im][jn + 1], a[im], f[2], f[3]);
        }
      }
    }
    __syncthreads();  // the stage is refilled two steps on
  }

  const size_t base = blockIdx.z * out_chunk_stride;
#pragma unroll
  for (int im = 0; im < 2; ++im) {
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int n = n0 + wn + 8 * jn + 2 * (lane & 3);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + 16 * im + (lane >> 2) + 8 * half;
        if (m >= M || n >= Ncols) continue;
        const size_t off = base + static_cast<size_t>(m) * ldo + n;
        const float v0 = acc[im][jn][2 * half];
        const float v1 = acc[im][jn][2 * half + 1];
        if (out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(out) + off) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
              make_float2(v0, v1);
      }
    }
  }
}

cudaError_t launch_grad_mma(bool a_trans, const __nv_bfloat16* A,
                            const __nv_bfloat16* B, void* out, bool out_bf16,
                            int M, int Ncols, int K, int lda, int ldb,
                            int ldo, int k_chunk, long long out_chunk_stride,
                            cudaStream_t stream) {
  const dim3 grid((Ncols + kMmaBN - 1) / kMmaBN, (M + kMmaBM - 1) / kMmaBM,
                  (K + k_chunk - 1) / k_chunk);
  if (a_trans)
    window_attn_qkv_grad_mma_kernel<true><<<grid, kMmaThreads, 0, stream>>>(
        A, B, out, out_bf16, M, Ncols, K, lda, ldb, ldo, k_chunk,
        out_chunk_stride);
  else
    window_attn_qkv_grad_mma_kernel<false><<<grid, kMmaThreads, 0, stream>>>(
        A, B, out, out_bf16, M, Ncols, K, lda, ldb, ldo, k_chunk,
        out_chunk_stride);
  return cudaGetLastError();
}

template <int NT, int DT>
cudaError_t qkv_bwd_tc_allow(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(window_attn_qkv_bwd_tc_kernel<NT, DT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int NT, int DT>
cudaError_t launch_qkv_bwd_tc_attend(const void* x, const void* wt,
                                     const void* b, const void* scale,
                                     const void* bias16, const void* mask,
                                     const void* g, void* dqkv,
                                     void* partial, int N, int C,
                                     int num_heads, bool g16, int lanes,
                                     const TcPlan& plan,
                                     cudaStream_t stream) {
  const size_t smem =
      qkv_bwd_tc_smem_bytes(N, C, C / num_heads, mask != nullptr, lanes);
  const cudaError_t err = qkv_bwd_tc_allow<NT, DT>(smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>(plan.G * plan.ipc * num_heads);
  window_attn_qkv_bwd_tc_kernel<NT, DT><<<blocks, 32 * NT * lanes, smem,
                                          stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(wt),
      static_cast<const float*>(b), static_cast<const float*>(scale),
      static_cast<const float*>(bias16), static_cast<const float*>(mask),
      static_cast<const __nv_bfloat16*>(g),
      static_cast<__nv_bfloat16*>(dqkv), static_cast<float*>(partial), N, C,
      num_heads, g16, plan);
  return cudaGetLastError();
}

template <int NT, int DT>
cudaError_t qkv_bwd_tc_occupancy(int* ctas, int N, int C, int hd,
                                 bool masked, int lanes) {
  const size_t smem = qkv_bwd_tc_smem_bytes(N, C, hd, masked, lanes);
  const cudaError_t err = qkv_bwd_tc_allow<NT, DT>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, window_attn_qkv_bwd_tc_kernel<NT, DT>, 32 * NT * lanes, smem);
}

bool qkv_bwd_tc_args_ok(long long n_windows, int N, int C, int num_heads,
                        int n_win_per_img, int wpc, int lanes, bool masked) {
  return tc_args_ok(n_windows, N, C, num_heads, n_win_per_img, wpc, 4, {}) &&
         C % 16 == 0 && lanes >= 1 && lanes <= kMaxLanes &&
         32 * tc_tiles(N) * lanes <= qkv_bwd_max_threads(tc_tiles(N)) &&
         qkv_bwd_tc_smem_bytes(N, C, C / num_heads, masked, lanes) <=
             227 * 1024 &&
         n_windows * N <= INT_MAX &&
         (n_windows * N + kMmaBM - 1) / kMmaBM <= 65535;
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

// The tensor-core forward: x bf16 (16-byte aligned), wt and b f32 (wt
// 16-byte aligned); out_dtype 0 = float32, 1 = bfloat16. wpc: windows per
// CTA (the plan, fused_window_attn.tensor_core_plan); lanes: window lanes
// per CTA (1..15). Returns the launch's cudaGetLastError().
extern "C" int window_attn_qkv_fwd_tc(const void* x, const void* wt,
                                      const void* b, const void* scale,
                                      const void* bias16, const void* mask,
                                      void* out, long long n_windows, int N,
                                      int C, int num_heads, int n_win_per_img,
                                      int out_dtype, int wpc, int lanes,
                                      void* stream) {
  if (!qkv_tc_args_ok(n_windows, N, C, num_heads, n_win_per_img, wpc, lanes,
                      mask != nullptr) ||
      (out_dtype != 0 && out_dtype != 1) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wt) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % (out_dtype == 0 ? 8 : 4) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const TcPlan plan = tc_plan(n_windows, n_win_per_img, mask != nullptr, wpc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(TC_DISPATCH(
      launch_qkv_fwd_tc, N, C / num_heads, x, wt, b, scale, bias16, mask,
      out, out_dtype == 1, N, C, num_heads, lanes, plan, s));
}

// CTAs of the tensor-core forward one SM holds at once with `lanes` window
// lanes (masked: with the mask tile), from the CUDA occupancy API (shared
// memory and registers; 0 when none fits), or the negated CUDA error.
extern "C" int window_attn_qkv_tc_occupancy(int N, int C, int num_heads,
                                            int masked, int lanes) {
  if (!qkv_tc_args_ok(1, N, C, num_heads, 1, 1, lanes, masked != 0))
    return -static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0;
  const cudaError_t err = TC_DISPATCH(qkv_tc_occupancy, N, C / num_heads,
                                      &ctas, N, C, C / num_heads,
                                      masked != 0, lanes);
  return err == cudaSuccess ? ctas : -static_cast<int>(err);
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

// The tensor-core all-in-kernel backward: six launches on `stream`. x, g
// and dx bf16, wt and b f32; x, wt, dqkv and w16 16-byte aligned, g and dx
// 4-byte. wpc: windows per CTA (fused_window_attn.tensor_core_plan); lanes:
// window lanes per CTA (1..15, within qkv_bwd_max_threads). Scratch: dqkv (n_windows·N, 3C) bf16; w16
// (3C, C) bf16; partial G·⌈R / wpc⌉·lanes·num_heads rows of N·N + 1 + 3·hd
// floats; wpartial ⌈n_windows·N / chunk_rows⌉·3C·C floats. Results: dx
// (n_windows·N, C); sums (num_heads, N·N + 1 + 3·hd) with dbias in the
// first N·N columns, dscale next, then db of the head's q, k and v columns
// (hd each); wsums (3C, C), dWt.
extern "C" int window_attn_qkv_bwd_tc(
    const void* x, const void* wt, const void* b, const void* scale,
    const void* bias16, const void* mask, const void* g, void* dx, void* dqkv,
    void* w16, void* partial, void* sums, void* wpartial, void* wsums,
    long long n_windows, int N, int C, int num_heads, int n_win_per_img,
    int wpc, int lanes, int chunk_rows, void* stream) {
  auto aligned = [](const void* p, uintptr_t to) {
    return reinterpret_cast<uintptr_t>(p) % to == 0;
  };
  if (!qkv_bwd_tc_args_ok(n_windows, N, C, num_heads, n_win_per_img, wpc,
                          lanes, mask != nullptr) ||
      chunk_rows <= 0 || !aligned(x, 16) || !aligned(wt, 16) ||
      !aligned(dqkv, 16) || !aligned(w16, 16) || !aligned(g, 4) ||
      !aligned(dx, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int hd = C / num_heads;
  const bool g16 = hd % 8 == 0 && aligned(g, 16);
  const TcPlan plan = tc_plan(n_windows, n_win_per_img, mask != nullptr, wpc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = TC_DISPATCH(launch_qkv_bwd_tc_attend, N, hd, x, wt, b,
                                scale, bias16, mask, g, dqkv, partial, N, C,
                                num_heads, g16, lanes, plan, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = launch_window_sum(partial, sums, plan.G * plan.ipc * lanes,
                               num_heads, N * N + 1 + 3 * hd, s)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const int C3 = 3 * C;
  const long long n4 = static_cast<long long>(C3) * C / 4;
  const unsigned round_blocks =
      static_cast<unsigned>(n4 < 1024 * 256 ? (n4 + 255) / 256 : 1024);
  window_attn_qkv_round_kernel<<<round_blocks, 256, 0, s>>>(
      static_cast<const float*>(wt), static_cast<__nv_bfloat16*>(w16), n4);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int rows = static_cast<int>(n_windows * N);
  const auto* d16 = static_cast<const __nv_bfloat16*>(dqkv);
  // dx (rows, C) = round(dqkv·W16): A = dqkv (rows, 3C), B = W16 (3C, C)
  if ((err = launch_grad_mma(false, d16,
                             static_cast<const __nv_bfloat16*>(w16), dx, true,
                             rows, C, C3, C3, C, C, C3, 0, s)) != cudaSuccess)
    return static_cast<int>(err);
  // per chunk of rows: dWt (3C, C) = dqkvᵀ·x
  if ((err = launch_grad_mma(true, d16, static_cast<const __nv_bfloat16*>(x),
                             wpartial, false, C3, C, rows, C3, C, C,
                             chunk_rows, static_cast<long long>(C3) * C,
                             s)) != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(launch_window_sum(
      wpartial, wsums, (rows + chunk_rows - 1) / chunk_rows, 1, C3 * C, s));
}

// CTAs of the tensor-core backward one SM holds at once with `lanes` window
// lanes (masked: with the mask tile), from the CUDA occupancy API (0 when
// none fits or the lanes exceed the launch bound), or the negated CUDA
// error.
extern "C" int window_attn_qkv_bwd_tc_occupancy(int N, int C, int num_heads,
                                                int masked, int lanes) {
  if (N > 0 && lanes > 0 &&
      32 * tc_tiles(N) * lanes > qkv_bwd_max_threads(tc_tiles(N)))
    return 0;  // beyond the launch bound
  if (!qkv_bwd_tc_args_ok(1, N, C, num_heads, 1, 1, lanes, masked != 0))
    return -static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0;
  const cudaError_t err = TC_DISPATCH(qkv_bwd_tc_occupancy, N, C / num_heads,
                                      &ctas, N, C, C / num_heads,
                                      masked != 0, lanes);
  return err == cudaSuccess ? ctas : -static_cast<int>(err);
}
