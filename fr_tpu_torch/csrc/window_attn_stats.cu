// Cosine window attention with stored softmax statistics, for NVIDIA Hopper
// (sm_90a): a forward that also writes the f32 softmax p, and a backward
// that starts from that p instead of recomputing the scores.
//
// Replaces four TPU kernels of fr_tpu/ops/fused_window_attn.py, which the
// port serves with one pair because both of its entries compute one
// per-head function (the packed TPU kernel's shared softmax max is not
// carried over, ROADMAP §3):
//   forward storing p   _fwd_stats_pallas (per-head, body _fwd_body_stats,
//                       row 7) and _pk_fwd_stats_pallas (packed, row 3);
//   backward from p     _bwd_stats_pallas (per-head, body _bwd_body_stats,
//                       row 8) and _pk_bwd_stats_pallas (packed, row 4).
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
// ~8·N²·hd flops. Storing p costs 4·N² bytes each way, and saves the
// score and softmax recompute of the recompute backward. dscale and dbias
// are summed over all windows as in window_attn_bwd.cu: partials, then
// window_sum_kernel adds them in a fixed order, so the bits are the same on
// every run.
//
// Two bodies each, chosen by the Python wrapper by dtype and shape
// (fused_window_attn.py, tensor_core_route) as the recompute kernels'
// are, with no fallback from one to the other; both count on
// route_launches under the forward and backward keys:
//  - window_attn_fwd_stats_tc, window_attn_bwd_stats_tc: bf16 with N ≤ 64
//    and an even head dim ≤ 64, every shape of the models' path, on the
//    tensor cores (mma.sync m16n8k16) with the row-1/row-2 kernels' plan
//    and building blocks (window_attn_tc.cuh): a CTA per (run of windows,
//    head), warp i on query and key rows 16i.., cp.async double-buffering.
//    The forward is the row-1 body (window_attn_fwd_tc_kernel) that also
//    parks its f32 p fragments in an (N, N) shared tile and copies the
//    tile out as N² contiguous floats after the window's barrier: `out`
//    is the row-1 kernel's bit for bit.
//    The backward is the row-2 body (tc_bwd_window) with no score
//    recompute, no softmax and no mask slice: p lands by cp.async beside
//    q, k, v and g (16-byte copies where N is even, else 4-byte: at N 9
//    and 49 a row of p starts at a 4-byte boundary only) and is read at
//    the accumulator positions; round(p), dp, ds, dq̂ and dk̂ then follow
//    the row-2 body's helpers in its order, so dq, dk and dv are the row-2
//    kernel's bits given the p that body computes. dbias stays in
//    registers over the CTA's windows and dscale is the row sums of
//    dq̂∘q̂ that the L2-norm backward forms (tc_norm_backward_rowsum); one
//    partial row per CTA, not per (window, head).
//  - window_attn_fwd_stats, window_attn_bwd_stats: bf16 beyond the tile,
//    or f32 (TF32 would break the f32 tolerance). One block per (window,
//    head); every product with
//    f32 FMAs on the CUDA cores. The forward is window_attn_common.cuh's
//    kernel instantiated to store p; the backward stages its operands in
//    shared memory as f32 and writes one N·N + 1 partial per (window, head).

#include "window_attn_tc.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core bodies (bf16).
// ---------------------------------------------------------------------------

// p[w, h] as a shared tile: N·N f32, padded to whole 16-byte words.
__host__ __device__ inline int tc_p_floats(int N) { return (N * N + 3) & ~3; }

// Shared memory of the two kernels, in bytes. The Python wrapper computes
// the same sizes (_tc_stats_smem_bytes). The forward: the row-1 kernel's
// layout with one p tile after the bias (and mask) tiles. The backward:
// 4·NP + 32 f32 of norms, flags and sums, two stages of p, then the row-2
// kernel's bf16 tiles (a zero row, q̂, k̂, two stages of q, k, v, g, the
// round(p) and round(ds·scale) tiles); no bias or mask tile.
inline size_t tc_fwd_stats_smem_bytes(int N, int hd, bool masked) {
  return tc_fwd_smem_bytes(N, hd, masked) +
         4 * static_cast<size_t>(tc_p_floats(N));
}

inline size_t tc_bwd_stats_smem_bytes(int N, int hd) {
  const int np = 16 * tc_tiles(N);
  const size_t ld = tc_ld(hd);
  return 4 * (4 * static_cast<size_t>(np) + 32 + 2 * tc_p_floats(N)) +
         2 * (ld + 10 * N * ld + 2 * static_cast<size_t>(np) * (np + 8));
}

// Issues the copies of one (window, head) block of p, nn contiguous floats,
// into dst: 16-byte copies with pvec 16 (nn a multiple of 4 and src
// 16-byte aligned), else 4-byte ones.
__device__ __forceinline__ void tc_stage_p(float* dst,
                                           const float* __restrict__ src,
                                           int nn, int pvec) {
  if (pvec == 16) {
    for (int i = 4 * threadIdx.x; i < nn; i += 4 * blockDim.x)
      cp_async<16>(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < nn; i += blockDim.x)
      cp_async<4>(dst + i, src + i);
  }
}

// The f32 p of the warp's query rows at the accumulator positions (rows
// r0 and r0 + 8, columns 8jj + c0 and +1) from the (N, N) tile ps: the
// values tc_softmax leaves there, 0 at rows and columns past N.
template <int NT>
__device__ __forceinline__ void tc_load_p(float (&p)[2 * NT][4],
                                          const float* ps, int r0, int c0,
                                          int N) {
  const bool in0 = r0 < N, in1 = r0 + 8 < N;
  const float* p0 = ps + (in0 ? r0 : 0) * N;
  const float* p1 = ps + (in1 ? r0 + 8 : 0) * N;
#pragma unroll
  for (int jj = 0; jj < 2 * NT; ++jj) {
    const int c = 8 * jj + c0;
    p[jj][0] = in0 && c < N ? p0[c] : 0.f;
    p[jj][1] = in0 && c + 1 < N ? p0[c + 1] : 0.f;
    p[jj][2] = in1 && c < N ? p1[c] : 0.f;
    p[jj][3] = in1 && c + 1 < N ? p1[c + 1] : 0.f;
  }
}

// The forward's p fragments into the (N, N) tile ps, rows and columns < N.
template <int NT>
__device__ __forceinline__ void tc_park_p(float* ps,
                                          const float (&p)[2 * NT][4],
                                          int r0, int c0, int N) {
#pragma unroll
  for (int jj = 0; jj < 2 * NT; ++jj) {
    const int c = 8 * jj + c0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (e < 2 ? 0 : 8);
      const int cc = c + (e & 1);
      if (r < N && cc < N) ps[r * N + cc] = p[jj][e];
    }
  }
}

// tc_norm_backward (window_attn_tc.cuh) that also returns the thread's share
// of Σ rowsum(dx̂∘x̂) over the warp's rows: the quad's sum once per row,
// from its first lane. The arithmetic of dx is tc_norm_backward's, in its
// order; it is repeated here so that the kernels on that function keep
// their machine code.
template <int DT>
__device__ __forceinline__ float tc_norm_backward_rowsum(
    float (&dxn)[2 * DT][4], const __nv_bfloat16* raw, const float* rn,
    const float* act, int row0, int N, int hd, int ld) {
  const int lane = threadIdx.x & 31;
  float own = 0.f;
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
    if (in && (lane & 3) == 0) own += t;
#pragma unroll
    for (int nd = 0; nd < 2 * DT; ++nd) {
      dxn[nd][2 * half] = rr * (dxn[nd][2 * half] - aa * x[nd][0] * t);
      dxn[nd][2 * half + 1] =
          rr * (dxn[nd][2 * half + 1] - aa * x[nd][1] * t);
    }
  }
  return own;
}

// The stats forward: window_attn_fwd_tc_kernel's body (one CTA per (run of
// windows, head), NT warps, blockIdx.x = CTA·num_heads + head) that parks
// each window's f32 p in the shared tile ps and, after the window's last
// barrier, copies it out to p_out[w, h], 16 bytes a thread with pvec 16
// (N even and p_out 16-byte aligned), else 4.
template <int NT, int DT>
__global__ void __launch_bounds__(32 * NT)
    window_attn_fwd_stats_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ bias16,
                                    const float* __restrict__ mask,
                                    void* __restrict__ out, bool out_bf16,
                                    float* __restrict__ p_out, int N, int C,
                                    int num_heads, int vec, int pvec,
                                    TcPlan plan) {
  constexpr int NP = 16 * NT;
  constexpr int ld = 16 * DT + 8;
  constexpr int ldb = NP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WindowRows rows{N};
  const int hd = C / num_heads;
  const int h = static_cast<int>(blockIdx.x % num_heads);
  const long long cta = blockIdx.x / num_heads;
  const int j = static_cast<int>(cta / plan.ipc);
  const long long r_first = (cta - j * plan.ipc) * plan.wpc;
  const int nwin = static_cast<int>(
      min(static_cast<long long>(plan.wpc), plan.R - r_first));
  const int nn = N * N;

  float* bias_s = reinterpret_cast<float*>(smem_raw);
  float* mask_s = mask != nullptr ? bias_s + N * ldb : nullptr;
  float* ps = bias_s + tc_bias_floats(N, NP, mask != nullptr);
  __nv_bfloat16* zero_row =
      reinterpret_cast<__nv_bfloat16*>(ps + tc_p_floats(N));
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
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * static_cast<int>(threadIdx.x >> 5);
  const int r0 = row0 + (lane >> 2);
  const int c0 = 2 * (lane & 3);

  for (int s = 0; s < nwin; ++s) {
    __nv_bfloat16* qs = stage + (s & 1) * stage_elems;
    __nv_bfloat16* ks = qs + N * ld;
    const __nv_bfloat16* vs = ks + N * ld;
    const long long w = window(s);
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
    tc_park_p<NT>(ps, p, r0, c0, N);
    uint32_t pa[NT][4];
    tc_to_operand<NT>(pa, p);
    float o[2 * DT][4] = {};
    tc_times_tile<NT, DT>(o, pa, vs, zero_row, N, ld);
    tc_store_rows<DT>(o, out, out_bf16, static_cast<size_t>(C),
                      static_cast<size_t>(h) * hd, row0, N, hd, w, rows);
    // every warp's rows of p are in ps; the stage is refilled two windows
    // on, and ps rewritten only after two more barriers
    __syncthreads();
    float* dst = p_out + (static_cast<size_t>(w) * num_heads + h) * nn;
    if (pvec == 16) {
      for (int i = 4 * threadIdx.x; i < nn; i += 4 * blockDim.x)
        *reinterpret_cast<float4*>(dst + i) =
            *reinterpret_cast<const float4*>(ps + i);
    } else {
      for (int i = threadIdx.x; i < nn; i += blockDim.x) dst[i] = ps[i];
    }
  }
}

// One window of the stats backward, once q̂, k̂ and the norms are in place:
// tc_bwd_window (window_attn_tc.cuh) with p read from the tile ps in
// place of the scores and the softmax. For queries row0..: round(p) to the
// P tile pt, dp = g·vᵀ, ds, its dbias sums, round(ds·scale) (to dt and as
// the A operand of dq̂ = dsc·k̂), dq, and the row sums of dq̂∘q̂ into rowsum;
// then, after the CTA's barrier, for keys row0..: dv = round(p)ᵀ·g and
// dk̂ = dscᵀ·q̂, dk.
template <int NT, int DT>
__device__ __forceinline__ void tc_bwd_stats_window(
    float (&dbias)[2 * NT][4], float& rowsum, const float* ps,
    const __nv_bfloat16* qs, const __nv_bfloat16* ks,
    const __nv_bfloat16* vs, const __nv_bfloat16* gs,
    const __nv_bfloat16* qn, const __nv_bfloat16* kn, __nv_bfloat16* pt,
    __nv_bfloat16* dt, const __nv_bfloat16* zero_row, const float* rn,
    const float* act, float sc, __nv_bfloat16* dqkv, int C, size_t C3,
    size_t head_off, int warp, int row0, int r0, int c0, int N, int hd,
    long long w) {
  constexpr int LDP = 16 * NT + 8;
  constexpr int ld = 16 * DT + 8;
  const WindowRows rows{N};
  {  // queries row0..row0+15
    float p[2 * NT][4];
    tc_load_p<NT>(p, ps, r0, c0, N);
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
    rowsum += tc_norm_backward_rowsum<DT>(dq, qs, rn, act, row0, N, hd, ld);
    tc_store_rows<DT>(dq, dqkv, true, C3, head_off, row0, N, hd, w, rows);
  }
  __syncthreads();  // every warp's rows of round(p) and round(ds·scale)
  {  // keys row0..row0+15
    uint32_t a[NT][4];
    tc_load_transposed<NT>(a, pt, warp);
    float acc[2 * DT][4] = {};
    tc_times_tile<NT, DT>(acc, a, gs, zero_row, N, ld);
    tc_store_rows<DT>(acc, dqkv, true, C3,
                      2 * static_cast<size_t>(C) + head_off, row0, N, hd, w,
                      rows);
    tc_load_transposed<NT>(a, dt, warp);
#pragma unroll
    for (int nd = 0; nd < 2 * DT; ++nd)
      acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
    tc_times_tile<NT, DT>(acc, a, qn, zero_row, N, ld);
    tc_norm_backward<DT>(acc, ks, rn + N, act + N, row0, N, hd, ld);
    tc_store_rows<DT>(acc, dqkv, true, C3, static_cast<size_t>(C) + head_off,
                      row0, N, hd, w, rows);
  }
}

// The stats backward: one CTA per (run of windows, head), NT warps, the
// windows API's rows and no mask slices (plan.G = 1). Per window the next
// window's q, k, v, g and p[w, h] land by cp.async while this one
// computes: q̂, k̂ and the norms, then tc_bwd_stats_window. The CTA's
// partial (dbias N·N values, then Σ rowsum(dq̂∘q̂)/scale) goes to
// partial[blockIdx.x].
template <int NT, int DT>
__global__ void __launch_bounds__(32 * NT)
    window_attn_bwd_stats_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ p,
                                    const __nv_bfloat16* __restrict__ g,
                                    __nv_bfloat16* __restrict__ dqkv,
                                    float* __restrict__ partial, int N, int C,
                                    int num_heads, int vec, int pvec,
                                    TcPlan plan) {
  constexpr int NP = 16 * NT;
  constexpr int LDP = NP + 8;
  constexpr int ld = 16 * DT + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WindowRows rows{N};
  const int hd = C / num_heads;
  const int h = static_cast<int>(blockIdx.x % num_heads);
  const long long cta = blockIdx.x / num_heads;
  const int j = static_cast<int>(cta / plan.ipc);
  const long long r_first = (cta - j * plan.ipc) * plan.wpc;
  const int nwin = static_cast<int>(
      min(static_cast<long long>(plan.wpc), plan.R - r_first));
  const int nn = N * N;
  const int pf = tc_p_floats(N);

  float* rn = reinterpret_cast<float*>(smem_raw);  // 2·NP
  float* act = rn + 2 * NP;                         // 2·NP
  float* red = act + 2 * NP;                        // 32
  float* pstage = red + 32;                         // two stages of p
  __nv_bfloat16* zero_row =
      reinterpret_cast<__nv_bfloat16*>(pstage + 2 * pf);
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
  auto p_of = [&](long long w) {
    return p + (static_cast<size_t>(w) * num_heads + h) * nn;
  };
  tc_stage(stage, qkv, g, N, C, hd, ld, cp, window(0), h, rows);
  tc_stage_p(pstage, p_of(window(0)), nn, pvec);
  cp_async_commit();
  const float sc = scale[h];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = 16 * warp;
  const int r0 = row0 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const size_t head_off = static_cast<size_t>(h) * hd;
  const size_t C3 = 3 * static_cast<size_t>(C);

  float dbias[2 * NT][4] = {};
  float rowsum = 0.f;

  for (int s = 0; s < nwin; ++s) {
    const __nv_bfloat16* qs = stage + (s & 1) * stage_elems;
    const __nv_bfloat16* ks = qs + N * ld;
    const __nv_bfloat16* vs = ks + N * ld;
    const __nv_bfloat16* gs = vs + N * ld;
    const float* ps = pstage + (s & 1) * pf;
    const long long w = window(s);
    if (s + 1 < nwin) {
      tc_stage(stage + ((s + 1) & 1) * stage_elems, qkv, g, N, C, hd, ld, cp,
               window(s + 1), h, rows);
      tc_stage_p(pstage + ((s + 1) & 1) * pf, p_of(window(s + 1)), nn, pvec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    tc_normalize(qs, ks, qn, kn, rn, act, N, hd, ld);
    __syncthreads();
    tc_bwd_stats_window<NT, DT>(dbias, rowsum, ps, qs, ks, vs, gs, qn, kn, pt,
                                dt, zero_row, rn, act, sc, dqkv, C, C3,
                                head_off, warp, row0, r0, c0, N, hd, w);
    __syncthreads();  // the stages and the tiles are refilled
  }

  // this CTA's partial: dbias from the warps' own rows, then dscale's share
  tc_store_partial<NT>(dbias, rowsum / sc,
                       partial + static_cast<size_t>(blockIdx.x) * (nn + 1),
                       red, warp, r0, c0, N);
}

// 16-byte copies of p where every (window, head) block starts at a 16-byte
// boundary: N even and p itself 16-byte aligned.
inline int tc_p_vec(int N, const void* p) {
  return N % 2 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0 ? 16 : 4;
}

template <int NT, int DT>
cudaError_t launch_fwd_stats_tc(const void* qkv, const void* scale,
                                const void* bias16, const void* mask,
                                void* out, bool out_bf16, void* p, int N,
                                int C, int num_heads, int vec,
                                const TcPlan& plan, cudaStream_t stream) {
  return tc_launch<NT>(
      window_attn_fwd_stats_tc_kernel<NT, DT>,
      tc_fwd_stats_smem_bytes(N, C / num_heads, mask != nullptr), plan,
      num_heads, stream, static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(scale), static_cast<const float*>(bias16),
      static_cast<const float*>(mask), out, out_bf16, static_cast<float*>(p),
      N, C, num_heads, vec, tc_p_vec(N, p), plan);
}

template <int NT, int DT>
cudaError_t launch_bwd_stats_tc(const void* qkv, const void* scale,
                                const void* p, const void* g, void* dqkv,
                                void* partial, int N, int C, int num_heads,
                                int vec, const TcPlan& plan,
                                cudaStream_t stream) {
  return tc_launch<NT>(
      window_attn_bwd_stats_tc_kernel<NT, DT>,
      tc_bwd_stats_smem_bytes(N, C / num_heads), plan, num_heads, stream,
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(scale), static_cast<const float*>(p),
      static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(dqkv),
      static_cast<float*>(partial), N, C, num_heads, vec, tc_p_vec(N, p),
      plan);
}

template <int NT, int DT>
cudaError_t stats_tc_occupancy(int* ctas, bool backward, int N, int hd,
                               bool masked) {
  const size_t smem = backward ? tc_bwd_stats_smem_bytes(N, hd)
                               : tc_fwd_stats_smem_bytes(N, hd, masked);
  const void* kernel =
      backward ? reinterpret_cast<const void*>(
                     window_attn_bwd_stats_tc_kernel<NT, DT>)
               : reinterpret_cast<const void*>(
                     window_attn_fwd_stats_tc_kernel<NT, DT>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, 32 * NT,
                                                       smem);
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

// The tensor-core stats forward: qkv bf16; out_dtype 0 = float32,
// 1 = bfloat16; p receives (n_windows, num_heads, N, N) f32. wpc: windows
// per CTA; vec: 16- or 4-byte copies of qkv (every source address must be
// aligned to it). Returns the launch's cudaGetLastError().
extern "C" int window_attn_fwd_stats_tc(const void* qkv, const void* scale,
                                        const void* bias16, const void* mask,
                                        void* out, void* p,
                                        long long n_windows, int N, int C,
                                        int num_heads, int n_win_per_img,
                                        int out_dtype, int wpc, int vec,
                                        void* stream) {
  if (!tc_args_ok(n_windows, N, C, num_heads, n_win_per_img, wpc, vec,
                  {qkv}) ||
      (out_dtype != 0 && out_dtype != 1) ||
      reinterpret_cast<uintptr_t>(out) % (out_dtype == 0 ? 8 : 4) != 0 ||
      reinterpret_cast<uintptr_t>(p) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const TcPlan plan = tc_plan(n_windows, n_win_per_img, mask != nullptr, wpc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(TC_DISPATCH(
      launch_fwd_stats_tc, N, C / num_heads, qkv, scale, bias16, mask, out,
      out_dtype == 1, p, N, C, num_heads, vec, plan, s));
}

// The tensor-core stats backward: qkv, g and dqkv bf16, p the forward's
// f32. partial holds ⌈n_windows / wpc⌉·num_heads rows of (N·N + 1) floats,
// one per CTA (fused_window_attn.py, tensor_core_plan with no mask); out
// receives (num_heads, N·N + 1) as window_attn_bwd_stats's.
extern "C" int window_attn_bwd_stats_tc(const void* qkv, const void* scale,
                                        const void* p, const void* g,
                                        void* dqkv, void* partial, void* out,
                                        long long n_windows, int N, int C,
                                        int num_heads, int wpc, int vec,
                                        void* stream) {
  if (!tc_args_ok(n_windows, N, C, num_heads, 1, wpc, vec, {qkv, g}) ||
      reinterpret_cast<uintptr_t>(dqkv) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(p) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const TcPlan plan = tc_plan(n_windows, 1, false, wpc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = TC_DISPATCH(launch_bwd_stats_tc, N, C / num_heads,
                                      qkv, scale, p, g, dqkv, partial, N, C,
                                      num_heads, vec, plan, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_window_sum(partial, out, plan.ipc, num_heads, N * N + 1, s));
}

// CTAs of the tensor-core stats forward (backward 0; masked: with the mask
// tile) or backward (backward 1) that one SM holds at once, or the negated
// CUDA error.
extern "C" int window_attn_stats_tc_occupancy(int N, int C, int num_heads,
                                              int masked, int backward) {
  if (N <= 0 || N > 64 || num_heads <= 0 || C % num_heads != 0 ||
      C / num_heads > 64)
    return -static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0;
  const cudaError_t err =
      TC_DISPATCH(stats_tc_occupancy, N, C / num_heads, &ctas, backward != 0,
                  N, C / num_heads, masked != 0);
  return err == cudaSuccess ? ctas : -static_cast<int>(err);
}
