// The recompute backward of cosine window attention, shared by
// window_attn_bwd.cu (the windows API, rows 2 and 6 of ROADMAP §2),
// window_attn_spatial.cu (the (B, H, W, ·) layout, row 17) and
// window_attn_qkv.cu (the entry-fused backward, row 18): the shared-memory
// layout, the staging of q, k, v and g, the body after staging, the kernel
// and its launch with the fixed-order sum of dscale and dbias. The math is
// described in window_attn_bwd.cu. Everything sits in an anonymous
// namespace, so each source that includes it gets its own copy.

#pragma once

#include "window_attn_common.cuh"

namespace {

// Shared memory, in floats: q̂, k̂, dq̂, dk̂, v and g as (N, hd+1), the
// padded row keeping every product loop free of bank conflicts; s_raw, p
// and dp/ds as (N, N+1); 6N row values (two inverse norms, two active
// flags, two row sums); 32 per-warp partial sums. The Python wrapper
// computes the same size (_bwd_smem_bytes).
__host__ __device__ inline size_t recompute_bwd_smem_floats(int N, int hd) {
  const size_t n = static_cast<size_t>(N);
  return 6 * n * (hd + 1) + 3 * n * (N + 1) + 6 * n + 32;
}

// Stages the raw q, k, v and g (rounded to T by the wrapper) of head h of
// window w into the backward's shared memory.
template <typename T, typename Rows>
__device__ __forceinline__ void bwd_stage(float* smem,
                                          const T* __restrict__ qkv,
                                          const T* __restrict__ g, int N,
                                          int C, int hd, long long w, int h,
                                          const Rows& rows) {
  const int ld = hd + 1;
  float* qs = smem;
  float* ks = qs + N * ld;
  float* vs = ks + 3 * N * ld;
  float* gs = vs + N * ld;
  const size_t head_off = static_cast<size_t>(h) * hd;
  for (int i = threadIdx.x; i < N * hd; i += blockDim.x) {
    const int n = i / hd;
    const int d = i - n * hd;
    const size_t r = rows.row(w, n);
    const T* row = qkv + r * 3 * C + head_off + d;
    qs[n * ld + d] = to_f32<T>(row[0]);
    ks[n * ld + d] = to_f32<T>(row[C]);
    vs[n * ld + d] = to_f32<T>(row[2 * C]);
    gs[n * ld + d] = to_f32<T>(g[r * C + head_off + d]);
  }
}

// Steps 2-9 of the backward once the raw q, k, v and g of head h of window
// w are in shared memory. The L2-norm backward needs the unrounded q̂, k̂
// again at the end: from ``raw`` (raw q then raw k, (N, hd+1) each, in
// shared memory) when it is not null, else re-read from qkv through rows.
// dq, dk, dv go to dqkv through rows in the type D (T, or f32 unrounded
// for the entry-fused backward); partial[w·num_heads + h] receives this
// block's ds (N·N values) and its Σ ds·s_raw (one value). Every value is
// rounded to T once, where _bwd_jnp casts it, and kept rounded in shared
// memory for the products.
template <typename T, typename D, typename Rows>
__device__ void bwd_attend(float* smem, const T* __restrict__ qkv,
                           const float* raw, const float* __restrict__ scale,
                           const float* __restrict__ bias16,
                           const float* __restrict__ mask,
                           D* __restrict__ dqkv, float* __restrict__ partial,
                           int N, int C, int num_heads, int n_win_per_img,
                           long long w, int h, const Rows& rows) {
  const int hd = C / num_heads;
  const int ld = hd + 1;
  const int lds = N + 1;
  float* qs = smem;            // q, then round(q̂), then q̂ (f32)
  float* ks = qs + N * ld;     // k, then round(k̂), then k̂
  float* dqs = ks + N * ld;    // dq̂
  float* dks = dqs + N * ld;   // dk̂
  float* vs = dks + N * ld;    // v
  float* gs = vs + N * ld;     // g in the compute dtype
  float* sr = gs + N * ld;     // s_raw
  float* ps = sr + N * lds;    // s, then p
  float* dps = ps + N * lds;   // round(p), then dp, then round(ds·scale)
  float* rn = dps + N * lds;   // 1/‖q‖ (N), 1/‖k‖ (N)
  float* an = rn + 2 * N;      // Σx² > eps² for q (N), k (N)
  float* rs = an + 2 * N;      // row sums
  float* wsum = rs + 2 * N;    // one partial sum per warp

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const size_t head_off = static_cast<size_t>(h) * hd;

  // 2. inverse L2 norms and active flags of the q and k rows
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
  __syncthreads();

  // 3. s_raw and the scaled, biased (and masked) scores
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
    sr[r * lds + c] = acc;
    ps[r * lds + c] = s;
  }
  __syncthreads();

  // 4. p = softmax(s) in f32, one warp per row, max per head; round(p)
  for (int r = warp; r < N; r += nwarps) {
    float* pr = ps + r * lds;
    float m = -INFINITY;
    for (int c = lane; c < N; c += 32) m = fmaxf(m, pr[c]);
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float e = expf(pr[c] - m);
      pr[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < N; c += 32) {
      pr[c] = pr[c] / sum;
      dps[r * lds + c] = round_to<T>(pr[c]);
    }
  }
  __syncthreads();

  // 5. dv = round(p)ᵀ·g straight to the output
  for (int i = tid; i < N * hd; i += nthr) {
    const int j = i / hd;
    const int d = i - j * hd;
    float acc = 0.f;
    for (int r = 0; r < N; ++r)
      acc = fmaf(dps[r * lds + j], gs[r * ld + d], acc);
    dqkv[rows.row(w, j) * 3 * C + 2 * C + head_off + d] = from_f32<D>(acc);
  }
  __syncthreads();

  // 6. dp = g·vᵀ
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

  // 7. ds = p∘(dp − rowsum(dp∘p)), one warp per row: its dbias partial,
  //    its share of Σ ds·s_raw, and round(ds·scale) kept for the products
  float* pblk = partial + (static_cast<size_t>(w) * num_heads + h) *
                              (N * N + 1);
  float dsc_acc = 0.f;
  for (int r = warp; r < N; r += nwarps) {
    const float* pr = ps + r * lds;
    float* dr = dps + r * lds;
    float t = 0.f;
    for (int c = lane; c < N; c += 32) t = fmaf(dr[c], pr[c], t);
    t = warp_sum(t);
    for (int c = lane; c < N; c += 32) {
      const float ds = pr[c] * (dr[c] - t);
      pblk[r * N + c] = ds;
      dsc_acc = fmaf(ds, sr[r * lds + c], dsc_acc);
      dr[c] = round_to<T>(ds * sc);
    }
  }
  dsc_acc = warp_sum(dsc_acc);
  if (lane == 0) wsum[warp] = dsc_acc;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int i = 0; i < nwarps; ++i) total += wsum[i];
    pblk[N * N] = total;
  }

  // 8. dq̂ = dsc·round(k̂), dk̂ = dscᵀ·round(q̂)
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

  // 9. the L2-norm backward needs the unrounded q̂, k̂: recompute them from
  //    the raw q, k, then the row sums of dq̂∘q̂ and dk̂∘k̂, then dq, dk
  for (int i = tid; i < N * hd; i += nthr) {
    const int n = i / hd;
    const int d = i - n * hd;
    float q, k;
    if (raw != nullptr) {
      q = raw[n * ld + d];
      k = raw[N * ld + n * ld + d];
    } else {
      const T* row = qkv + rows.row(w, n) * 3 * C + head_off + d;
      q = to_f32<T>(row[0]);
      k = to_f32<T>(row[C]);
    }
    qs[n * ld + d] = q * rn[n];
    ks[n * ld + d] = k * rn[N + n];
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
  for (int i = tid; i < N * hd; i += nthr) {
    const int n = i / hd;
    const int d = i - n * hd;
    const float dq = rn[n] * (dqs[n * ld + d] -
                              an[n] * qs[n * ld + d] * rs[n]);
    const float dk = rn[N + n] * (dks[n * ld + d] -
                                  an[N + n] * ks[n * ld + d] * rs[N + n]);
    D* drow = dqkv + rows.row(w, n) * 3 * C + head_off + d;
    drow[0] = from_f32<D>(dq);
    drow[C] = from_f32<D>(dk);
  }
}

// One block per (window, head); blockIdx.x = window·num_heads + head.
template <typename T, typename Rows>
__global__ void window_attn_bwd_kernel(const T* __restrict__ qkv,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ bias16,
                                       const float* __restrict__ mask,
                                       const T* __restrict__ g,
                                       T* __restrict__ dqkv,
                                       float* __restrict__ partial, int N,
                                       int C, int num_heads,
                                       int n_win_per_img, Rows rows) {
  extern __shared__ float smem[];
  const long long w = blockIdx.x / num_heads;
  const int h = static_cast<int>(blockIdx.x - w * num_heads);
  // 1. stage this head's q, k, v and g
  bwd_stage<T>(smem, qkv, g, N, C, C / num_heads, w, h, rows);
  __syncthreads();
  bwd_attend<T, T>(smem, qkv, nullptr, scale, bias16, mask, dqkv, partial,
                   N, C, num_heads, n_win_per_img, w, h, rows);
}

template <typename T, typename Rows>
cudaError_t launch_bwd(const void* qkv, const void* scale, const void* bias16,
                       const void* mask, const void* g, void* dqkv,
                       void* partial, void* out, long long n_windows, int N,
                       int C, int num_heads, int n_win_per_img, int threads,
                       const Rows& rows, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * recompute_bwd_smem_floats(N, C / num_heads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_attn_bwd_kernel<T, Rows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>(n_windows * num_heads);
  window_attn_bwd_kernel<T, Rows><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(scale),
      static_cast<const float*>(bias16), static_cast<const float*>(mask),
      static_cast<const T*>(g), static_cast<T*>(dqkv),
      static_cast<float*>(partial), N, C, num_heads, n_win_per_img, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_window_sum(partial, out, n_windows, num_heads, N * N + 1,
                           stream);
}

// The backward's C entry for either row layout; dtype code: 0 = float32,
// 1 = bfloat16, for qkv, g and dqkv alike. partial holds
// n_windows·num_heads·(N·N + 1) floats of scratch; out receives
// (num_heads, N·N + 1): dbias in the first N·N columns, dscale in the last.
template <typename Rows>
int window_attn_bwd_entry(const void* qkv, const void* scale,
                          const void* bias16, const void* mask, const void* g,
                          void* dqkv, void* partial, void* out,
                          long long n_windows, int N, int C, int num_heads,
                          int n_win_per_img, int dtype, int threads,
                          const Rows& rows, void* stream) {
  if (n_windows <= 0 || N <= 0 || num_heads <= 0 || C % num_heads != 0 ||
      n_win_per_img <= 0 || threads <= 0 || threads > 1024 ||
      threads % 32 != 0 || n_windows * num_heads > INT_MAX ||
      n_windows > INT_MAX || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(qkv, scale, bias16, mask, g, dqkv, partial, out,
                             n_windows, N, C, num_heads, n_win_per_img,
                             threads, rows, s);
  return launch_bwd<__nv_bfloat16>(qkv, scale, bias16, mask, g, dqkv, partial,
                                   out, n_windows, N, C, num_heads,
                                   n_win_per_img, threads, rows, s);
}

}  // namespace
