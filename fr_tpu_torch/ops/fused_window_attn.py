"""Cosine window attention for the AlterNet shapes: the Hopper kernels'
launch wrappers, their plain PyTorch versions and the autograd Function
that joins them.

Counterpart of fr_tpu/ops/fused_window_attn.py::fused_window_attention_packed.
The forward kernel (csrc/window_attn_fwd.cu) replaces the TPU kernel
``_pk_fwd_pallas``; its contract is fr_tpu's per-head pure-jnp math
``_heads_fwd``. Per window and head:

    L2-normalise q, k in f32 (eps 1e-12, rsqrt form) → cast to the compute
    dtype → scores q̂·k̂ᵀ accumulated in f32 → ·scale_h + bias16_h
    (+ mask[w mod nW]) → f32 softmax with a per-head max → p cast to the
    compute dtype → p·v accumulated in f32 → heads concatenated

The backward kernel (csrc/window_attn_bwd.cu) replaces the recompute
backward ``_pk_bwd_pallas`` that the model runs (it passes
stored_stats=False); its contract is ``_bwd_jnp``. The Function saves qkv,
scale, bias16 and the mask, never p, and the backward recomputes the
forward, as fr_tpu's does, so no activation checkpointing is needed. It
returns dqkv in the compute dtype, dscale (h,) and dbias (h, N, N) in f32
(sums over all windows); the mask gets no gradient.

The compute dtype is qkv's dtype (bf16 or f32). The softmax max is taken
per head, as ``_heads_fwd`` does; the packed TPU kernel shares one max over
all heads of a row and returns non-finite output when one head's scores sit
~88 below another's (ROADMAP §3), which the port does not copy.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 128
_SMEM_LIMIT = 48 * 1024
_BWD_THREADS = 256
_BWD_SMEM_LIMIT = 227 * 1024


def window_attention_reference(qkv: torch.Tensor, scale: torch.Tensor,
                               bias16: torch.Tensor, num_heads: int,
                               mask: Optional[torch.Tensor] = None,
                               out_dtype: Optional[torch.dtype] = None
                               ) -> torch.Tensor:
    """Plain PyTorch twin of fr_tpu's ``_heads_fwd``.

    qkv (B·nW, N, 3C) in the compute dtype, windows image-major; scale (h,)
    f32; bias16 (h, N, N) f32; mask (nW, N, N) f32 or None →
    (B·nW, N, C) in out_dtype (default f32). Compute-dtype products with
    f32 accumulation are taken as f32 products of the rounded operands,
    which is what ``preferred_element_type=f32`` computes."""
    W, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    cd = qkv.dtype
    heads = qkv.reshape(W, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = heads[0].float(), heads[1].float(), heads[2]   # (W, h, N, hd)

    def norm(x):
        ss = torch.sum(x * x, dim=-1, keepdim=True)
        return (x * torch.rsqrt(torch.clamp_min(ss, 1e-24))).to(cd).float()

    s = torch.matmul(norm(q), norm(k).transpose(-1, -2))     # (W, h, N, N)
    s = s * scale.reshape(1, num_heads, 1, 1) + bias16[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(W // nW, nW, num_heads, N, N) + mask[None, :, None]
             ).reshape(W, num_heads, N, N)
    p = torch.softmax(s, dim=-1).to(cd).float()
    out = torch.matmul(p, v.float())                         # (W, h, N, hd)
    return out.permute(0, 2, 1, 3).reshape(W, N, C).to(
        out_dtype or torch.float32)


def window_attention_backward_reference(
        qkv: torch.Tensor, scale: torch.Tensor, bias16: torch.Tensor,
        g: torch.Tensor, num_heads: int, mask: Optional[torch.Tensor] = None):
    """Plain PyTorch twin of fr_tpu's ``_bwd_jnp`` (its ``_norm`` is the
    norm below), all heads at once.

    g (B·nW, N, C), any float dtype, is rounded to the compute dtype (qkv's)
    before the products, as ``_bwd_jnp`` does. Returns dqkv (B·nW, N, 3C) in
    the compute dtype, dscale (h,) f32 = Σ ds·s_raw and dbias (h, N, N) f32
    = Σ ds, both summed over the windows."""
    W, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    cd = qkv.dtype
    heads = qkv.reshape(W, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = heads[0].float(), heads[1].float(), heads[2].float()

    def norm(x):
        s2 = torch.sum(x * x, dim=-1, keepdim=True)
        r = torch.rsqrt(torch.clamp_min(s2, 1e-24))
        return x * r, r, s2 > 1e-24

    qn, qr, qa = norm(q)
    kn, kr, ka = norm(k)
    qnc, knc = qn.to(cd).float(), kn.to(cd).float()
    s_raw = torch.matmul(qnc, knc.transpose(-1, -2))          # (W, h, N, N)
    s = s_raw * scale.reshape(1, num_heads, 1, 1) + bias16[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(W // nW, nW, num_heads, N, N) + mask[None, :, None]
             ).reshape(W, num_heads, N, N)
    p = torch.softmax(s, dim=-1)
    gc = g.reshape(W, N, num_heads, hd).permute(0, 2, 1, 3).to(cd).float()
    dp = torch.matmul(gc, v.transpose(-1, -2))
    dv = torch.matmul(p.to(cd).float().transpose(-1, -2), gc)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dbias = torch.sum(ds, dim=0)
    dscale = torch.sum(ds * s_raw, dim=(0, 2, 3))
    dsc = (ds * scale.reshape(1, num_heads, 1, 1)).to(cd).float()
    dqn = torch.matmul(dsc, knc)
    dkn = torch.matmul(dsc.transpose(-1, -2), qnc)
    dq = qr * (dqn - torch.where(
        qa, qn * torch.sum(dqn * qn, dim=-1, keepdim=True), 0.0))
    dk = kr * (dkn - torch.where(
        ka, kn * torch.sum(dkn * kn, dim=-1, keepdim=True), 0.0))
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(W, N, C3)
    return dqkv.to(cd), dscale, dbias


def _attention_forward(qkv, scale, bias16, num_heads, n_win_per_img, mask,
                       out_dtype):
    """The forward on qkv's device: the plain version on the CPU, the kernel
    on CUDA (counted on fused_window_attention_packed.launches)."""
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, scale, bias16, num_heads,
                                          mask, out_dtype)
    if qkv.device.type != "cuda":
        raise ValueError(f"no window-attention kernel for device "
                         f"{qkv.device}")
    out = _launch(qkv, scale, bias16, num_heads, n_win_per_img, mask,
                  out_dtype)
    fused_window_attention_packed.launches += 1
    return out


def window_attention_backward(qkv: torch.Tensor, scale: torch.Tensor,
                              bias16: torch.Tensor, g: torch.Tensor,
                              num_heads: int, n_win_per_img: int,
                              mask: Optional[torch.Tensor] = None):
    """(dqkv, dscale, dbias) of fused_window_attention_packed for the output
    cotangent g. A CPU tensor takes the plain version; a CUDA tensor
    launches the Hopper backward kernel, or raises. ``launches`` counts
    kernel launches."""
    if qkv.device.type == "cpu":
        return window_attention_backward_reference(qkv, scale, bias16, g,
                                                   num_heads, mask)
    if qkv.device.type != "cuda":
        raise ValueError(f"no window-attention kernel for device "
                         f"{qkv.device}")
    grads = _launch_bwd(qkv, scale, bias16, g, num_heads, n_win_per_img,
                        mask)
    window_attention_backward.launches += 1
    return grads


window_attention_backward.launches = 0


class _PackedWindowAttention(torch.autograd.Function):
    """fr_tpu's custom_vjp of fused_window_attention_packed with the
    recompute backward: saves the inputs, not p."""

    @staticmethod
    def forward(ctx, qkv, scale, bias16, mask, num_heads, n_win_per_img,
                out_dtype):
        ctx.save_for_backward(qkv, scale, bias16, mask)
        ctx.num_heads = num_heads
        ctx.n_win_per_img = n_win_per_img
        return _attention_forward(qkv, scale, bias16, num_heads,
                                  n_win_per_img, mask, out_dtype)

    @staticmethod
    def backward(ctx, g):
        qkv, scale, bias16, mask = ctx.saved_tensors
        dqkv, dscale, dbias = window_attention_backward(
            qkv, scale, bias16, g, ctx.num_heads, ctx.n_win_per_img, mask)
        return dqkv, dscale, dbias, None, None, None, None


def fused_window_attention_packed(qkv: torch.Tensor, scale: torch.Tensor,
                                  bias16: torch.Tensor, num_heads: int,
                                  n_win_per_img: int,
                                  mask: Optional[torch.Tensor] = None,
                                  out_dtype: Optional[torch.dtype] = None
                                  ) -> torch.Tensor:
    """fr_tpu's packed-entry contract: qkv (B·nW, N, 3C) compute-dtype →
    (B·nW, N, C) out_dtype (default f32); scale (h,), bias16 (h, N, N) and
    mask (n_win_per_img, N, N) f32, the mask indexed by window mod nW.
    Differentiable in qkv, scale and bias16 (window_attention_backward).

    A CPU tensor takes the plain version. A CUDA tensor launches the Hopper
    kernel, or raises; there is no fallback. ``launches`` counts forward
    kernel launches. fr_tpu's TPU tiling arguments (block_rows, interpret,
    head_group, stored_stats) have no counterpart here."""
    out_dtype = out_dtype or torch.float32
    if mask is not None and mask.shape[0] != n_win_per_img:
        raise ValueError(f"mask has {mask.shape[0]} windows, "
                         f"n_win_per_img is {n_win_per_img}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (qkv, scale, bias16)):
        return _PackedWindowAttention.apply(qkv, scale, bias16, mask,
                                            num_heads, n_win_per_img,
                                            out_dtype)
    return _attention_forward(qkv, scale, bias16, num_heads, n_win_per_img,
                              mask, out_dtype)


fused_window_attention_packed.launches = 0


def _smem_bytes(N: int, hd: int) -> int:
    """Dynamic shared memory of one (window, head) block: q̂ and k̂ with a
    padded row (N, hd+1), v (N, hd), scores (N, N+1), row norms (2N)."""
    return 4 * (2 * N * (hd + 1) + N * hd + N * (N + 1) + 2 * N)


def _checked_operands(qkv, scale, bias16, num_heads, n_win_per_img, mask,
                      smem_bytes, smem_limit):
    """Validates what both kernels take; returns (B·nW, N, C) and the
    operands made contiguous."""
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (B·nW, N, 3C), got {tuple(qkv.shape)}")
    B_, N, C3 = qkv.shape
    C = C3 // 3
    if C % num_heads:
        raise ValueError(f"C={C} is not divisible by {num_heads} heads")
    hd = C // num_heads
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"qkv {qkv.dtype}: the kernel takes float32 or "
                        f"bfloat16")
    if B_ % n_win_per_img:
        raise ValueError(f"{B_} windows are not whole images of "
                         f"{n_win_per_img}")
    if smem_bytes(N, hd) > smem_limit:
        raise ValueError(f"N={N}, head dim {hd} needs {smem_bytes(N, hd)} B "
                         f"of shared memory; the kernel takes ≤ {smem_limit}")
    dev = qkv.device
    expect = {"scale": (scale, (num_heads,)),
              "bias16": (bias16, (num_heads, N, N))}
    if mask is not None:
        expect["mask"] = (mask, (n_win_per_img, N, N))
    for name, (t, shape) in expect.items():
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be float32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return ((B_, N, C), qkv.contiguous(), scale.contiguous(),
            bias16.contiguous(), mask.contiguous() if mask is not None
            else None)


def _launch(qkv, scale, bias16, num_heads, n_win_per_img, mask, out_dtype):
    from fr_tpu_torch.ops._build import check_launch, load_library

    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"qkv {qkv.dtype} / out {out_dtype}: the kernel "
                        f"takes float32 or bfloat16")
    (B_, N, C), qkv, scale, bias16, mask = _checked_operands(
        qkv, scale, bias16, num_heads, n_win_per_img, mask, _smem_bytes,
        _SMEM_LIMIT)
    out = torch.empty((B_, N, C), dtype=out_dtype, device=qkv.device)
    if B_ == 0:
        return out
    lib = load_library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.window_attn_fwd(
            qkv.data_ptr(), scale.data_ptr(), bias16.data_ptr(),
            mask.data_ptr() if mask is not None else None, out.data_ptr(),
            B_, N, C, num_heads, n_win_per_img,
            _DTYPE_CODE[qkv.dtype], _DTYPE_CODE[out_dtype], _THREADS,
            ctypes.c_void_p(stream))
    check_launch(lib, err, "window_attn_fwd")
    return out


def _bwd_smem_bytes(N: int, hd: int) -> int:
    """Dynamic shared memory of one backward (window, head) block: q̂, k̂,
    dq̂, dk̂, v, g (N, hd+1); s_raw, p, ds (N, N+1); 6N row values and 32
    per-warp sums."""
    return 4 * (6 * N * (hd + 1) + 3 * N * (N + 1) + 6 * N + 32)


def _launch_bwd(qkv, scale, bias16, g, num_heads, n_win_per_img, mask):
    from fr_tpu_torch.ops._build import check_launch, load_library

    (B_, N, C), qkv, scale, bias16, mask = _checked_operands(
        qkv, scale, bias16, num_heads, n_win_per_img, mask, _bwd_smem_bytes,
        _BWD_SMEM_LIMIT)
    dev = qkv.device
    if tuple(g.shape) != (B_, N, C) or g.device != dev:
        raise ValueError(f"g must be {(B_, N, C)} on {dev}, got "
                         f"{tuple(g.shape)} on {g.device}")
    # _bwd_jnp rounds g to the compute dtype before every product
    g = g.to(qkv.dtype).contiguous()
    cols = N * N + 1
    dqkv = torch.empty_like(qkv)
    partial = torch.empty((B_ * num_heads, cols), dtype=torch.float32,
                          device=dev)
    sums = torch.empty((num_heads, cols), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.window_attn_bwd(
            qkv.data_ptr(), scale.data_ptr(), bias16.data_ptr(),
            mask.data_ptr() if mask is not None else None, g.data_ptr(),
            dqkv.data_ptr(), partial.data_ptr(), sums.data_ptr(),
            B_, N, C, num_heads, n_win_per_img, _DTYPE_CODE[qkv.dtype],
            _BWD_THREADS, ctypes.c_void_p(stream))
    check_launch(lib, err, "window_attn_bwd")
    dbias = sums[:, :N * N].reshape(num_heads, N, N).contiguous()
    return dqkv, sums[:, N * N].contiguous(), dbias
