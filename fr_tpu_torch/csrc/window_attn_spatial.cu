// Cosine window attention on the spatial layout, forward and backward, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the spatial variant of fr_tpu/ops/fused_window_attn_variants.py:
// _sp_fwd (pallas_call :272) and _sp_bwd_rule (:336), which window the
// (B, H, W, ·) arrays inside the kernel instead of partitioning and
// reversing them outside. Contract, per window and head, the windows API's
// (window_attn_fwd.cu, window_attn_bwd.cu): the off-TPU twin _sp_jnp is
// window_partition → _heads_fwd → window_reverse, and the backward
// _bwd_jnp on the partitioned qkv and g. Here
//   forward:  qkv (B, H, W, 3C) in the compute dtype, already rolled for
//             SW-MSA → out (B, H, W, C) in f32, as fr_tpu returns it;
//   backward: g (B, H, W, C) rounded to the compute dtype → dqkv
//             (B, H, W, 3C) in the compute dtype, dscale (h,) and dbias
//             (h, N, N) in f32, summed over all windows.
// The mask is indexed by window mod nWy·nWx, window_partition's order. The
// roll of SW-MSA stays outside, as in fr_tpu.
//
// The kernels are the windows API's, instantiated on SpatialRows
// (window_attn_common.cuh): the row of token n = (ty, tx) of window
// w = (img, wy, wx) is ((img·H + wy·ws + ty)·W + wx·ws + tx), so a block
// reads its window's rows straight out of the image layout and writes its
// output rows back there. What bounds them is what bounds the windows API's
// kernels (device-memory bytes: qkv, g in; out or dqkv out); the rows a
// block touches are ws runs of ws·3C contiguous values instead of one run of
// N·3C, which costs nothing at these widths (3C ≥ 384 elements per row).
// What the layout saves is the partition and reverse copies around the
// windows API (two passes over qkv and one over out forward; over g and
// dqkv backward). As in the windows API, bf16 at N ≤ 64 and an even head
// dim ≤ 64 takes the tensor-core kernels of window_attn_tc.cuh
// (window_attn_spatial_fwd_tc, window_attn_spatial_bwd_tc) and everything
// else the CUDA-core ones; the Python wrapper picks the entry.

#include "window_attn_bwd.cuh"
#include "window_attn_tc.cuh"

namespace {

bool spatial_shape_ok(long long B, int H, int W, int C, int num_heads,
                      int ws) {
  return B > 0 && ws > 0 && H > 0 && W > 0 && H % ws == 0 && W % ws == 0 &&
         num_heads > 0 && C % num_heads == 0 &&
         B * (H / ws) * (W / ws) * num_heads <= INT_MAX;
}

SpatialRows spatial_rows(int H, int W, int ws) {
  return SpatialRows{H, W, ws, H / ws, W / ws};
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (out_dtype is 0 on the model's
// path: fr_tpu's spatial op returns f32). mask (nWy·nWx, N, N) or null.
// Returns the launch's cudaGetLastError(); the kernel runs asynchronously
// on `stream`.
extern "C" int window_attn_spatial_fwd(const void* qkv, const void* scale,
                                       const void* bias16, const void* mask,
                                       void* out, long long B, int H, int W,
                                       int C, int num_heads, int ws,
                                       int in_dtype, int out_dtype,
                                       int threads, void* stream) {
  if (!spatial_shape_ok(B, H, W, C, num_heads, ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (H / ws) * (W / ws);
  return window_attn_fwd_entry<false>(
      qkv, scale, bias16, mask, out, nullptr, B * nw, ws * ws, C, num_heads,
      nw, in_dtype, out_dtype, threads, spatial_rows(H, W, ws), stream);
}

// dtype code: 0 = float32, 1 = bfloat16, for qkv, g and dqkv alike. partial
// holds B·nWy·nWx·num_heads·(N·N + 1) floats of scratch; out receives
// (num_heads, N·N + 1): dbias in the first N·N columns, dscale in the last.
extern "C" int window_attn_spatial_bwd(const void* qkv, const void* scale,
                                       const void* bias16, const void* mask,
                                       const void* g, void* dqkv,
                                       void* partial, void* out, long long B,
                                       int H, int W, int C, int num_heads,
                                       int ws, int dtype, int threads,
                                       void* stream) {
  if (!spatial_shape_ok(B, H, W, C, num_heads, ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (H / ws) * (W / ws);
  return window_attn_bwd_entry(qkv, scale, bias16, mask, g, dqkv, partial,
                               out, B * nw, ws * ws, C, num_heads, nw, dtype,
                               threads, spatial_rows(H, W, ws), stream);
}

// The tensor-core forward: qkv bf16, out f32 (as fr_tpu's spatial op
// returns it); wpc: windows per CTA; vec: 16- or 4-byte copies.
extern "C" int window_attn_spatial_fwd_tc(const void* qkv, const void* scale,
                                          const void* bias16,
                                          const void* mask, void* out,
                                          long long B, int H, int W, int C,
                                          int num_heads, int ws, int wpc,
                                          int vec, void* stream) {
  if (!spatial_shape_ok(B, H, W, C, num_heads, ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (H / ws) * (W / ws);
  return window_attn_fwd_tc_entry(qkv, scale, bias16, mask, out, B * nw,
                                  ws * ws, C, num_heads, nw, 0, wpc, vec,
                                  spatial_rows(H, W, ws), stream);
}

// The tensor-core backward: qkv, g and dqkv bf16; partial holds one
// (N·N + 1) row per CTA and head (fused_window_attn.py, tensor_core_plan);
// out as window_attn_spatial_bwd's.
extern "C" int window_attn_spatial_bwd_tc(const void* qkv, const void* scale,
                                          const void* bias16,
                                          const void* mask, const void* g,
                                          void* dqkv, void* partial,
                                          void* out, long long B, int H,
                                          int W, int C, int num_heads, int ws,
                                          int wpc, int vec, void* stream) {
  if (!spatial_shape_ok(B, H, W, C, num_heads, ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (H / ws) * (W / ws);
  return window_attn_bwd_tc_entry(qkv, scale, bias16, mask, g, dqkv, partial,
                                  out, B * nw, ws * ws, C, num_heads, nw, wpc,
                                  vec, spatial_rows(H, W, ws), stream);
}

// CTAs of the spatial tensor-core forward (backward 0) or backward (1) one
// SM holds at once for these tiles, or the negated CUDA error.
extern "C" int window_attn_spatial_tc_occupancy(int N, int C, int num_heads,
                                                int masked, int backward) {
  return window_attn_tc_occupancy_entry<SpatialRows>(N, C, num_heads, masked,
                                                     backward);
}
