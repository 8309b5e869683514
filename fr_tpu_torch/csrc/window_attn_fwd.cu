// Cosine window attention, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces these TPU kernels of fr_tpu/ops/fused_window_attn.py (rows of
// ROADMAP §2): the packed entry's _pk_fwd_pallas (row 1; the AlterNet
// shapes, N 9 and 36, head dim 32), the per-head entry's _fwd_pallas (row 5;
// the Swin and EffiAlterNet shapes, N 49, head dims 32 and 38) and the
// grouped route's _pkg_fwd of fused_window_attn_variants.py (row 15); the
// same templates serve the spatial variant (row 17, window_attn_spatial.cu).
// All answer to fused_window_attn.py's per-head jnp math, _heads_fwd: per
// window w and head h,
//   q̂, k̂ = L2-normalised q, k in f32 (eps 1e-12, rsqrt form), rounded to
//          the compute dtype (the dtype of qkv);
//   s     = (q̂·k̂ᵀ accumulated in f32)·scale[h] + bias16[h] (+ mask[w mod nW]);
//   p     = softmax(s) in f32 with a max per head, rounded to the compute dtype;
//   out   = p·v accumulated in f32, written in the output dtype with the
//           heads concatenated: out[w, n, h·hd + d].
// The TPU kernel's lane packing (segment matrices, head-repeated k/v, one
// softmax max shared by all heads of a row) is not carried over: it exists
// for the TPU's 128-lane layout, and the shared max makes the TPU kernel
// return non-finite values when one head's scores sit ~88 below another's.
//
// What bounds it on the card: device-memory bytes. qkv comes in once and
// the output goes out once, 4·N·hd elements per (window, head), against
// 4·N²·hd flops: 0.16 ms at the twelve AlterNet50 sites of one encoder
// call, 0.15 ms at the eighteen Swin50 + EffiAlter_m ones (chip_smoke.py's
// bounds, bf16, 3.35 TB/s).
//
// Two bodies, chosen by the Python wrapper by dtype and shape
// (fused_window_attn.py, tensor_core_route), each with its own entry and
// launch counter:
//  - window_attn_fwd_tc: bf16 with N ≤ 64 and an even head dim ≤ 64, every
//    shape of the models' path. Both products on the tensor cores
//    (mma.sync m16n8k16, bf16 → f32), scores and p in registers, a CTA per
//    run of windows of one head with bias16[h] (and the mask slice) staged
//    once, cp.async double-buffering; window_attn_tc.cuh has the design.
//    From -Xptxas -v (CUDA 12.8, sm_90a; chip_smoke.py [build]): 62-94
//    registers and no spills over the sixteen tile instances; the main
//    path's <token tiles, head-dim tiles> = <1,2> (N 9), <3,2> (N 36),
//    <4,2> (N 49, hd 32) and <4,3> (hd 38) take 62, 63, 80 and 72.
//  - window_attn_fwd: f32 (TF32 would break the f32 tolerance of 5e-5 and
//    the f32 goldens) and bf16 shapes beyond the tile. One block per
//    (window, head) stages q, k and v in shared memory as f32 and computes
//    both products with f32 FMAs on the CUDA cores; the kernel is in
//    window_attn_common.cuh, which the stored-stats forward
//    (window_attn_stats.cu) and the entry-fused forward
//    (window_attn_qkv.cu) also instantiate.

#include "window_attn_tc.cuh"

// dtype codes: 0 = float32, 1 = bfloat16. Returns the launch's
// cudaGetLastError(); the kernel runs asynchronously on `stream`.
extern "C" int window_attn_fwd(const void* qkv, const void* scale,
                               const void* bias16, const void* mask,
                               void* out, long long n_windows, int N, int C,
                               int num_heads, int n_win_per_img, int in_dtype,
                               int out_dtype, int threads, void* stream) {
  return window_attn_fwd_entry<false>(qkv, scale, bias16, mask, out, nullptr,
                                      n_windows, N, C, num_heads,
                                      n_win_per_img, in_dtype, out_dtype,
                                      threads, WindowRows{N}, stream);
}

// The tensor-core forward: qkv bf16; out_dtype 0 = float32, 1 = bfloat16.
// wpc: windows per CTA; vec: 16- or 4-byte copies (every source address
// must be aligned to it). Returns the launch's cudaGetLastError().
extern "C" int window_attn_fwd_tc(const void* qkv, const void* scale,
                                  const void* bias16, const void* mask,
                                  void* out, long long n_windows, int N,
                                  int C, int num_heads, int n_win_per_img,
                                  int out_dtype, int wpc, int vec,
                                  void* stream) {
  return window_attn_fwd_tc_entry(qkv, scale, bias16, mask, out, n_windows,
                                  N, C, num_heads, n_win_per_img, out_dtype,
                                  wpc, vec, WindowRows{N}, stream);
}

// CTAs of the tensor-core forward one SM holds at once for these tiles
// (masked: with the mask tile), or the negated CUDA error.
extern "C" int window_attn_fwd_tc_occupancy(int N, int C, int num_heads,
                                            int masked) {
  return window_attn_tc_occupancy_entry<WindowRows>(N, C, num_heads, masked,
                                                    0);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
