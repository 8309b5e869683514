// Cosine window attention, backward (recompute), for NVIDIA Hopper (sm_90a).
//
// Replaces these TPU kernels of fr_tpu/ops/fused_window_attn.py (rows of
// ROADMAP §2), the recompute backwards the models run (stored_stats=False):
// the packed entry's _pk_bwd_pallas (row 2), the per-head entry's
// _bwd_pallas (row 6; N 49, head dims 32 and 38) and the grouped route's
// _pkg_bwd of fused_window_attn_variants.py (row 16); the same templates
// serve the spatial backward (row 17b, window_attn_spatial.cu) and the
// entry-fused route's hybrid backward calls this entry. Their contract is
// fused_window_attn.py's per-head jnp math, _bwd_jnp: per window w and head
// h, with g the output cotangent rounded to the compute dtype T,
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
// The TPU kernel's lane packing is not carried over, as in the forward.
//
// What bounds it on the card: device-memory bytes (qkv and g in, dqkv out,
// 7·N·hd elements per (window, head), against 10·N²·hd flops): 0.26 ms at
// the twelve AlterNet50 sites of one step, 0.29 ms at the eighteen Swin50 +
// EffiAlter_m ones (chip_smoke.py's bounds, bf16). dscale and dbias are sums
// over every window: blocks write partials to a scratch buffer and a second
// kernel (window_sum_kernel) adds them in a fixed order, so the result is
// the same bit for bit on every run, which f32 atomicAdd would not give.
//
// Two bodies, chosen by the Python wrapper by dtype and shape
// (fused_window_attn.py, tensor_core_route), each with its own entry and
// launch counter:
//  - window_attn_bwd_tc: bf16 with N ≤ 64 and an even head dim ≤ 64, every
//    shape of the models' path. The five products on the tensor cores
//    (mma.sync m16n8k16), scores, p, dp and ds in registers, a CTA per run
//    of windows of one head with bias16[h] (and the mask slice) staged
//    once, cp.async double-buffering of q, k, v and g, and one dbias/dscale
//    partial per CTA instead of one per (window, head): the partials' round
//    trip through device memory shrinks by the windows per CTA.
//    window_attn_tc.cuh has the design. From -Xptxas -v (CUDA 12.8,
//    sm_90a; chip_smoke.py [build]): the main path's <1,2>, <3,2>, <4,2>
//    and <4,3> take 112, 168, 230 and 224 registers; the tiles of 48
//    tokens spill 4 (<3,2>), 8 (<3,3>) and 24 bytes (<3,4>), no other.
//    At 230 registers an SM holds two CTAs of N = 49 (eight warps): the
//    registers, not shared memory, cap its occupancy.
//  - window_attn_bwd: f32 (TF32 would break the f32 tolerance) and bf16
//    shapes beyond the tile. One block per (window, head) recomputes the
//    forward with everything in shared memory as f32, every product with
//    f32 FMAs on the CUDA cores, one partial per block; the kernel is in
//    window_attn_bwd.cuh, which the spatial and entry-fused backwards
//    share.

#include "window_attn_bwd.cuh"
#include "window_attn_tc.cuh"

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

// The tensor-core backward: qkv, g and dqkv bf16. partial holds one
// (N·N + 1) row per CTA and head (fused_window_attn.py, tensor_core_plan);
// out as window_attn_bwd's. wpc: windows per CTA; vec: 16- or 4-byte
// copies.
extern "C" int window_attn_bwd_tc(const void* qkv, const void* scale,
                                  const void* bias16, const void* mask,
                                  const void* g, void* dqkv, void* partial,
                                  void* out, long long n_windows, int N,
                                  int C, int num_heads, int n_win_per_img,
                                  int wpc, int vec, void* stream) {
  return window_attn_bwd_tc_entry(qkv, scale, bias16, mask, g, dqkv, partial,
                                  out, n_windows, N, C, num_heads,
                                  n_win_per_img, wpc, vec, WindowRows{N},
                                  stream);
}

// CTAs of the tensor-core backward one SM holds at once for these tiles
// (masked: with the mask tile), or the negated CUDA error.
extern "C" int window_attn_bwd_tc_occupancy(int N, int C, int num_heads,
                                            int masked) {
  return window_attn_tc_occupancy_entry<WindowRows>(N, C, num_heads, masked,
                                                    1);
}
