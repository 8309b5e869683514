// Cosine window attention, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces two TPU kernels of fr_tpu/ops/fused_window_attn.py: the packed
// entry's _pk_fwd_pallas (body _pk_fwd_groups; the AlterNet shapes, N 9 and
// 36, head dim 32) and the per-head entry's _fwd_pallas (batched bodies;
// the Swin and EffiAlterNet shapes, N 49, head dims 32 and 38). Both answer
// to that file's per-head jnp math, _heads_fwd: per window w and head h,
//   q̂, k̂ = L2-normalised q, k in f32 (eps 1e-12, rsqrt form), rounded to
//          the compute dtype (the dtype of qkv);
//   s     = (q̂·k̂ᵀ accumulated in f32)·scale[h] + bias16[h] (+ mask[w mod nW]);
//   p     = softmax(s) in f32 with a max per head, rounded to the compute dtype;
//   out   = p·v accumulated in f32, written in the output dtype with the
//           heads concatenated: out[w, n, h·hd + d].
//
// What bounds it on the card: device-memory bytes. qkv comes in once and
// the output goes out once; per (window, head) that is 4·N·hd elements
// against about 4·N²·hd flops. The design keeps everything else on-chip:
// one block per (window, head) stages q, k and v in shared memory, and the
// (N, N) scores live only in shared memory, so they never touch device
// memory. The TPU kernel's lane packing (segment matrices, head-repeated
// k/v, one softmax max shared by all heads of a row) is not carried over:
// it exists for the TPU's 128-lane layout, and the shared max makes the
// TPU kernel return non-finite values when one head's scores sit ~88 below
// another's.
//
// The kernel itself is in window_attn_common.cuh, which the stored-stats
// forward (window_attn_stats.cu) instantiates to also write p. This first
// version computes both products with f32 FMAs on the CUDA cores. Moving them to the tensor cores (mma.sync or wgmma) and staging
// with TMA are later steps.

#include "window_attn_common.cuh"

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

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
