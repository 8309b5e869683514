// Cosine window attention with stored softmax statistics, for NVIDIA Hopper
// (sm_90a): a forward that also writes the f32 softmax p, and a backward
// that starts from that p instead of recomputing the scores.
//
// Replaces four TPU kernels of fr_tpu/ops/fused_window_attn.py, which the
// port serves with one pair because both of its entries compute one
// per-head function (the packed TPU kernel's shared softmax max is not
// carried over, ROADMAP §3):
//   window_attn_fwd_stats  _fwd_stats_pallas (per-head, body _fwd_body_stats)
//                          and _pk_fwd_stats_pallas (packed): the forward
//                          kernel of window_attn_common.cuh, instantiated
//                          to store p;
//   window_attn_bwd_stats  _bwd_stats_pallas (per-head, body _bwd_body_stats)
//                          and _pk_bwd_stats_pallas (packed).
// Contract, per window w and head h, with T the compute dtype (qkv's):
//   forward: as window_attn_fwd.cu, and p = softmax(s) in f32, unrounded,
//            written to p[w, h] (layout (B·nW, h, N, N): one block's p is
//            contiguous);
//   backward (from p; bias16 and the mask are not read):
//     dp = round_T(g)·vᵀ,  dv = round_T(p)ᵀ·round_T(g)   (f32 accumulation);
//     ds = p ∘ (dp − rowsum(dp ∘ p));  dbias[h] += ds;
//     dq̂ = round_T(ds·scale[h])·round_T(k̂),  dk̂ = round_T(ds·scale[h])ᵀ·round_T(q̂);
//     dq = r_q·(dq̂ − [Σq² > eps²]·q̂·rowsum(dq̂ ∘ q̂)), and dk alike;
//     dscale[h] += Σ rowsum(dq̂ ∘ q̂) / scale[h]: fr_tpu's identity
//     Σ ds·s_raw = Σ dq̂·q̂ / scale_h (fused_window_attn.py:595-602), so no
//     s_raw is needed.
//
// What bounds them on the card: device-memory bytes. Per (window, head) the
// forward reads 3·N·hd inputs and writes N·hd outputs plus N² f32 of p; the
// backward reads qkv, g and p and writes dqkv, against ~4·N²·hd and
// ~8·N²·hd flops. Storing p costs 4·N² bytes each way, and saves the norm,
// score and softmax recompute of the recompute backward
// (window_attn_bwd.cu). One block per (window, head) keeps every
// intermediate in shared memory. dscale and dbias are summed over all
// windows as in window_attn_bwd.cu: per-block partials, then a second kernel
// that adds them in a fixed order, so the bits are the same on every run.
//
// This first version computes every product with f32 FMAs on the CUDA
// cores; tensor cores and TMA are later steps.

#include "window_attn_common.cuh"

namespace {

// Backward shared memory, in floats: q̂, k̂, dq̂, dk̂, v and g as (N, hd+1);
// p and round(p)/dp/ds as (N, N+1); 6N row values (two inverse norms, two
// active flags, two row sums). The Python wrapper computes the same size
// (_bwd_stats_smem_bytes).
__host__ __device__ inline size_t bwd_smem_floats(int N, int hd) {
  const size_t n = static_cast<size_t>(N);
  return 6 * n * (hd + 1) + 2 * n * (N + 1) + 6 * n;
}

// One block per (window, head). partial[blockIdx.x] receives this block's
// ds (N·N values) and its Σ rowsum(dq̂∘q̂)/scale (one value).
template <typename T>
__global__ void window_attn_bwd_stats_kernel(
    const T* __restrict__ qkv, const float* __restrict__ scale,
    const float* __restrict__ p, const T* __restrict__ g,
    T* __restrict__ dqkv, float* __restrict__ partial, int N, int C,
    int num_heads) {
  extern __shared__ float smem[];
  const int hd = C / num_heads;
  const int ld = hd + 1;
  const int lds = N + 1;
  float* qs = smem;            // q, then round(q̂), then q̂ (f32)
  float* ks = qs + N * ld;     // k, then round(k̂), then k̂
  float* dqs = ks + N * ld;    // dq̂
  float* dks = dqs + N * ld;   // dk̂
  float* vs = dks + N * ld;    // v
  float* gs = vs + N * ld;     // g in the compute dtype
  float* ps = gs + N * ld;     // p (f32)
  float* dps = ps + N * lds;   // round(p), then dp, then round(ds·scale)
  float* rn = dps + N * lds;   // 1/‖q‖ (N), 1/‖k‖ (N)
  float* an = rn + 2 * N;      // Σx² > eps² for q (N), k (N)
  float* rs = an + 2 * N;      // row sums

  const long long w = blockIdx.x / num_heads;
  const int h = static_cast<int>(blockIdx.x - w * num_heads);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const size_t row_stride = static_cast<size_t>(3) * C;
  const size_t head_off = static_cast<size_t>(h) * hd;
  const T* base = qkv + static_cast<size_t>(w) * N * row_stride + head_off;
  const T* gbase = g + static_cast<size_t>(w) * N * C + head_off;
  T* dbase = dqkv + static_cast<size_t>(w) * N * row_stride + head_off;
  const float* pblk = p + static_cast<size_t>(blockIdx.x) * N * N;

  // 1. stage this head's q, k, v, g and its p (and round(p))
  for (int i = tid; i < N * hd; i += nthr) {
    const int n = i / hd;
    const int d = i - n * hd;
    const T* row = base + static_cast<size_t>(n) * row_stride + d;
    qs[n * ld + d] = to_f32<T>(row[0]);
    ks[n * ld + d] = to_f32<T>(row[C]);
    vs[n * ld + d] = to_f32<T>(row[2 * C]);
    gs[n * ld + d] = to_f32<T>(gbase[static_cast<size_t>(n) * C + d]);
  }
  for (int i = tid; i < N * N; i += nthr) {
    const int r = i / N;
    const int c = i - r * N;
    const float pv = pblk[i];
    ps[r * lds + c] = pv;
    dps[r * lds + c] = round_to<T>(pv);
  }
  __syncthreads();

  // 2. inverse L2 norms and active flags, then round(q̂), round(k̂)
  for (int r = tid; r < 2 * N; r += nthr) {
    const float* x = r < N ? qs + r * ld : ks + (r - N) * ld;
    float s2 = 0.f;
    for (int d = 0; d < hd; ++d) s2 = fmaf(x[d], x[d], s2);
    rn[r] = rsqrtf(fmaxf(s2, kEps2));
    an[r] = s2 > kEps2 ? 1.f : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < N * hd; i += nthr) {
    const int n = i / hd;
    const int d = i - n * hd;
    qs[n * ld + d] = round_to<T>(qs[n * ld + d] * rn[n]);
    ks[n * ld + d] = round_to<T>(ks[n * ld + d] * rn[N + n]);
  }

  // 3. dv = round(p)ᵀ·g straight to the output (no write to shared memory
  //    above is read here, so the barrier after step 1 suffices)
  for (int i = tid; i < N * hd; i += nthr) {
    const int j = i / hd;
    const int d = i - j * hd;
    float acc = 0.f;
    for (int r = 0; r < N; ++r)
      acc = fmaf(dps[r * lds + j], gs[r * ld + d], acc);
    dbase[static_cast<size_t>(j) * row_stride + 2 * C + d] = from_f32<T>(acc);
  }
  __syncthreads();

  // 4. dp = g·vᵀ
  for (int i = tid; i < N * N; i += nthr) {
    const int r = i / N;
    const int c = i - r * N;
    const float* gr = gs + r * ld;
    const float* vr = vs + c * ld;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc = fmaf(gr[d], vr[d], acc);
    dps[r * lds + c] = acc;
  }
  __syncthreads();

  // 5. ds = p∘(dp − rowsum(dp∘p)), one warp per row: its dbias partial and
  //    round(ds·scale) kept for the products
  const float sc = scale[h];
  float* part = partial + static_cast<size_t>(blockIdx.x) * (N * N + 1);
  for (int r = warp; r < N; r += nwarps) {
    const float* pr = ps + r * lds;
    float* dr = dps + r * lds;
    float t = 0.f;
    for (int c = lane; c < N; c += 32) t = fmaf(dr[c], pr[c], t);
    t = warp_sum(t);
    for (int c = lane; c < N; c += 32) {
      const float ds = pr[c] * (dr[c] - t);
      part[r * N + c] = ds;
      dr[c] = round_to<T>(ds * sc);
    }
  }
  __syncthreads();

  // 6. dq̂ = dsc·round(k̂), dk̂ = dscᵀ·round(q̂)
  for (int i = tid; i < N * hd; i += nthr) {
    const int n = i / hd;
    const int d = i - n * hd;
    float aq = 0.f;
    float ak = 0.f;
    for (int j = 0; j < N; ++j) {
      aq = fmaf(dps[n * lds + j], ks[j * ld + d], aq);
      ak = fmaf(dps[j * lds + n], qs[j * ld + d], ak);
    }
    dqs[n * ld + d] = aq;
    dks[n * ld + d] = ak;
  }
  __syncthreads();

  // 7. the L2-norm backward needs the unrounded q̂, k̂: recompute them from
  //    the inputs, then the row sums of dq̂∘q̂ and dk̂∘k̂, dscale's share, and
  //    dq, dk
  for (int i = tid; i < N * hd; i += nthr) {
    const int n = i / hd;
    const int d = i - n * hd;
    const T* row = base + static_cast<size_t>(n) * row_stride + d;
    qs[n * ld + d] = to_f32<T>(row[0]) * rn[n];
    ks[n * ld + d] = to_f32<T>(row[C]) * rn[N + n];
  }
  __syncthreads();
  for (int r = tid; r < 2 * N; r += nthr) {
    const float* x = r < N ? qs + r * ld : ks + (r - N) * ld;
    const float* dx = r < N ? dqs + r * ld : dks + (r - N) * ld;
    float t = 0.f;
    for (int d = 0; d < hd; ++d) t = fmaf(dx[d], x[d], t);
    rs[r] = t;
  }
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int n = 0; n < N; ++n) total += rs[n];
    part[N * N] = total / sc;
  }
  for (int i = tid; i < N * hd; i += nthr) {
    const int n = i / hd;
    const int d = i - n * hd;
    const float dq = rn[n] * (dqs[n * ld + d] -
                              an[n] * qs[n * ld + d] * rs[n]);
    const float dk = rn[N + n] * (dks[n * ld + d] -
                                  an[N + n] * ks[n * ld + d] * rs[N + n]);
    T* drow = dbase + static_cast<size_t>(n) * row_stride + d;
    drow[0] = from_f32<T>(dq);
    drow[C] = from_f32<T>(dk);
  }
}

template <typename T>
cudaError_t launch_bwd(const void* qkv, const void* scale, const void* p,
                       const void* g, void* dqkv, void* partial, void* out,
                       long long n_windows, int N, int C, int num_heads,
                       int threads, cudaStream_t stream) {
  const size_t smem = sizeof(float) * bwd_smem_floats(N, C / num_heads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_attn_bwd_stats_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>(n_windows * num_heads);
  window_attn_bwd_stats_kernel<T><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(scale),
      static_cast<const float*>(p), static_cast<const T*>(g),
      static_cast<T*>(dqkv), static_cast<float*>(partial), N, C, num_heads);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_window_sum(partial, out, n_windows, num_heads, N * N + 1,
                           stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. p receives (n_windows, num_heads,
// N, N) f32. Returns the launch's cudaGetLastError(); the kernel runs
// asynchronously on `stream`.
extern "C" int window_attn_fwd_stats(const void* qkv, const void* scale,
                                     const void* bias16, const void* mask,
                                     void* out, void* p, long long n_windows,
                                     int N, int C, int num_heads,
                                     int n_win_per_img, int in_dtype,
                                     int out_dtype, int threads,
                                     void* stream) {
  return window_attn_fwd_entry<true>(qkv, scale, bias16, mask, out, p,
                                     n_windows, N, C, num_heads,
                                     n_win_per_img, in_dtype, out_dtype,
                                     threads, WindowRows{N}, stream);
}

// dtype code: 0 = float32, 1 = bfloat16, for qkv, g and dqkv alike. p is
// the forward's (n_windows, num_heads, N, N) f32; partial holds
// n_windows·num_heads·(N·N + 1) floats of scratch; out receives
// (num_heads, N·N + 1): dbias in the first N·N columns, dscale in the last.
extern "C" int window_attn_bwd_stats(const void* qkv, const void* scale,
                                     const void* p, const void* g,
                                     void* dqkv, void* partial, void* out,
                                     long long n_windows, int N, int C,
                                     int num_heads, int dtype, int threads,
                                     void* stream) {
  if (n_windows <= 0 || N <= 0 || num_heads <= 0 || C % num_heads != 0 ||
      threads <= 0 || threads > 1024 || threads % 32 != 0 ||
      n_windows * num_heads > INT_MAX || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(qkv, scale, p, g, dqkv, partial, out, n_windows,
                             N, C, num_heads, threads, s);
  return launch_bwd<__nv_bfloat16>(qkv, scale, p, g, dqkv, partial, out,
                                   n_windows, N, C, num_heads, threads, s);
}
