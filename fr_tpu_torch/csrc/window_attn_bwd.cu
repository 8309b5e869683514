// Cosine window attention, backward (recompute), for NVIDIA Hopper (sm_90a).
//
// Replaces two TPU kernels of fr_tpu/ops/fused_window_attn.py, the
// recompute backwards the models run (stored_stats=False): the packed
// entry's _pk_bwd_pallas (body _pk_bwd_groups) and the per-head entry's
// _bwd_pallas (N 49, head dims 32 and 38: the padded row lengths hd+1 = 33
// and 39 are odd, so a warp reading one channel of k̂, v or g across 32
// token rows still hits 32 banks). Their contract is that file's per-head
// jnp math, _bwd_jnp: per window w and head h, with g the output cotangent
// rounded to the compute dtype T,
//   q̂, k̂  = L2-normalised q, k in f32 (eps 1e-12, rsqrt form);
//   s_raw  = round_T(q̂)·round_T(k̂)ᵀ accumulated in f32;
//   p      = softmax(s_raw·scale[h] + bias16[h] (+ mask[w mod nW])) in f32,
//            max per head;
//   dp     = g·vᵀ,  dv = round_T(p)ᵀ·g       (f32 accumulation);
//   ds     = p ∘ (dp − rowsum(dp ∘ p));
//   dbias[h] += ds,  dscale[h] += Σ ds ∘ s_raw;
//   dq̂     = round_T(ds·scale[h])·round_T(k̂),  dk̂ = round_T(ds·scale[h])ᵀ·round_T(q̂);
//   dq     = r_q·(dq̂ − [Σx² > eps²]·q̂·rowsum(dq̂ ∘ q̂)), and dk alike.
// dqkv is written in T with fr_tpu's channel layout (q heads, k heads,
// v heads); dscale (h,) and dbias (h, N, N) are f32 sums over all windows.
//
// What bounds it on the card: like the forward, device-memory bytes (qkv
// and g in, dqkv out, about 7·N·hd elements per (window, head) against
// ~10·N²·hd flops) plus the per-block dbias partials. One block per
// (window, head) recomputes the forward with everything in shared memory:
// the scores, p and ds never touch device memory.
//
// dscale and dbias are sums over every window. A block writes its own
// (N·N + 1) partials to a scratch buffer and a second kernel sums them over
// the windows in a fixed order: the result is the same bit for bit from run
// to run, which f32 atomicAdd would not give. The TPU kernel's lane
// packing (segment matrices, head-repeated k/v, a softmax max shared by all
// heads of a row) is not carried over, as in the forward.
//
// This first version computes every product with f32 FMAs on the CUDA
// cores; tensor cores and TMA are later steps. The kernel itself is in
// window_attn_bwd.cuh, templated on the row layout so that the spatial
// backward (window_attn_spatial.cu) and the entry-fused backward
// (window_attn_qkv.cu) share its body.

#include "window_attn_bwd.cuh"

// dtype code: 0 = float32, 1 = bfloat16, for qkv, g and dqkv alike.
// partial holds n_windows·num_heads·(N·N + 1) floats of scratch; out
// receives (num_heads, N·N + 1): dbias in the first N·N columns, dscale in
// the last. Returns the launches' cudaGetLastError(); both kernels run
// asynchronously on `stream`.
extern "C" int window_attn_bwd(const void* qkv, const void* scale,
                               const void* bias16, const void* mask,
                               const void* g, void* dqkv, void* partial,
                               void* out, long long n_windows, int N, int C,
                               int num_heads, int n_win_per_img, int dtype,
                               int threads, void* stream) {
  return window_attn_bwd_entry(qkv, scale, bias16, mask, g, dqkv, partial,
                               out, n_windows, N, C, num_heads, n_win_per_img,
                               dtype, threads, WindowRows{N}, stream);
}
