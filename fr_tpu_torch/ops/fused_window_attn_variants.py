"""fr_tpu's two further window-attention designs: the spatial variant and
the entry-fused variant (counterpart of
fr_tpu/ops/fused_window_attn_variants.py). Both compute the per-head
function of fused_window_attn.py; only where the window partition and the
qkv projection happen differs. Neither is a default in fr_tpu: a caller
opts in, as swin_common.WindowAttention does for a listed (window, dim)
(``SPATIAL_KERNEL_CONFIGS``) or with ``entry_fused``.

    fused_window_attention_spatial     qkv (B, H, W, 3C) → (B, H, W, C) f32:
        window partition, attention and window reverse in one kernel
        (csrc/window_attn_spatial.cu; row 17 of ROADMAP §2, fr_tpu's _sp_fwd
        and _sp_bwd_rule). Its plain versions are the twin of fr_tpu's
        ``_sp_jnp`` and a backward built from
        ``window_attention_backward_reference``.
    fused_window_attention_packed_qkv  x (B·nW, N, C) and the qkv
        projection's weight and bias → (B·nW, N, C): the projection inside
        the attention kernel (csrc/window_attn_qkv.cu; row 18, fr_tpu's
        _pkx_fwd and _pkx_bwd_rule). Its backward takes one of fr_tpu's two
        routes by ``_PKX_HYBRID_BWD``, read at backward time:
          True (fr_tpu's default), the hybrid: qkv recomputed with
            torch.matmul (a product outside any kernel in fr_tpu too), the
            row-2 recompute backward kernel, then dx and dW with
            torch.matmul, as fr_tpu does with XLA dots; db sums the
            compute-dtype dqkv;
          False, the all-in-kernel backward (csrc/window_attn_qkv.cu): dx,
            dW and db from hand-written kernels; db sums the unrounded f32
            dqkv, so the routes differ in bf16 (fr_tpu's do too).

The weight is nn.Linear's (3C, C) f32, the module's own parameter: the
transpose of fr_tpu's (C, 3C) w. The kernels read that layout, so no copy is
made, and dW comes back in it.

Launch counters (ROADMAP §2 rows):

    row 17  fused_window_attention_spatial.launches, .backward_launches;
            bf16 at N ≤ 64 takes the tensor-core kernels, as the windows
            API does (fused_window_attn.tensor_core_route), and every
            launch also counts on fused_window_attn.route_launches
    row 18  fused_window_attention_packed_qkv.launches (forward),
            .backward_launches (the all-in-kernel backward); the hybrid
            backward counts on window_attention_backward.launches (row 2)

A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from fr_tpu_torch.ops.fused_window_attn import (
    _BWD_SMEM_LIMIT, _BWD_THREADS, _DTYPE_CODE, _SMEM_LIMIT, _THREADS, _bump,
    _bwd_smem_bytes, _checked_cotangent, _checked_operands, _checked_params,
    _device, _grad_products, _smem_bytes, _softmax_probs, _stream,
    _tc_check, _tc_operands, _tc_slots, checked_head_group, route_launches,
    tensor_core_plan, tensor_core_route, window_attention_backward,
    window_attention_backward_reference, window_attention_reference)

# fr_tpu's backward switch for the entry-fused op (variants.py:577): True is
# the hybrid backward, False the all-in-kernel one.
_PKX_HYBRID_BWD = True

# token rows per dW/db partial of the all-in-kernel backward
_QKV_CHUNK_ROWS = 2048
_PROJ_CHUNK = 32   # csrc/window_attn_qkv.cu's kProjChunk


# ---------------------------------------------------------------------------
# Spatial variant (row 17)
# ---------------------------------------------------------------------------

def _to_windows(t: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, c) → (B·nWy·nWx, ws·ws, c) in window_partition's order."""
    B, H, W, c = t.shape
    t = t.reshape(B, H // ws, ws, W // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(-1, ws * ws, c)


def _from_windows(t: torch.Tensor, B: int, H: int, W: int, ws: int
                  ) -> torch.Tensor:
    """The inverse of _to_windows."""
    c = t.shape[-1]
    t = t.reshape(B, H // ws, W // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(B, H, W, c)


def window_attention_spatial_reference(qkv: torch.Tensor,
                                       scale: torch.Tensor,
                                       bias16: torch.Tensor, num_heads: int,
                                       ws: int,
                                       mask: Optional[torch.Tensor] = None
                                       ) -> torch.Tensor:
    """Plain PyTorch twin of fr_tpu's ``_sp_jnp``: qkv (B, H, W, 3C) in the
    compute dtype, already rolled for SW-MSA → (B, H, W, C) f32, through
    the windows, the per-head function and the reverse."""
    B, H, W, _ = qkv.shape
    out = window_attention_reference(_to_windows(qkv, ws), scale, bias16,
                                     num_heads, mask)
    return _from_windows(out, B, H, W, ws)


def window_attention_spatial_backward_reference(
        qkv: torch.Tensor, scale: torch.Tensor, bias16: torch.Tensor,
        g: torch.Tensor, num_heads: int, ws: int,
        mask: Optional[torch.Tensor] = None):
    """The spatial backward's plain version, as fr_tpu's interpret branch
    of ``_sp_bwd_rule`` builds it: the windows API's backward on the
    partitioned qkv and g (g rounded to the compute dtype), dqkv reversed.
    Returns dqkv (B, H, W, 3C) in the compute dtype, dscale (h,) and dbias
    (h, N, N) f32."""
    B, H, W, _ = qkv.shape
    dqkv, dscale, dbias = window_attention_backward_reference(
        _to_windows(qkv, ws), scale, bias16, _to_windows(g, ws), num_heads,
        mask)
    return _from_windows(dqkv, B, H, W, ws), dscale, dbias


def _spatial_route(qkv, num_heads, ws) -> bool:
    """tensor_core_route for a spatial qkv (B, H, W, 3C)."""
    return (qkv.dim() == 4 and tensor_core_route(
        qkv.dtype, ws * ws, qkv.shape[3] // 3 // num_heads))


def _spatial_operands(qkv, scale, bias16, num_heads, ws, mask, smem_bytes,
                      smem_limit):
    """Validates what the spatial kernels take; returns (B, H, W, C) and the
    operands contiguous. The windows API's checks run on a (B·nW, N, 3C)
    view of the same memory: no partition is made, the kernel reads the
    image layout."""
    if qkv.dim() != 4 or qkv.shape[3] % 3:
        raise ValueError(f"qkv must be (B, H, W, 3C), got "
                         f"{tuple(qkv.shape)}")
    B, H, W, C3 = qkv.shape
    if ws <= 0 or H % ws or W % ws:
        raise ValueError(f"a {H}×{W} map is not whole windows of {ws}")
    nw = (H // ws) * (W // ws)
    qkv = qkv.contiguous()
    _, _, scale, bias16, mask = _checked_operands(
        qkv.view(B * nw, ws * ws, C3), scale, bias16, num_heads, nw, mask,
        smem_bytes, smem_limit)
    return (B, H, W, C3 // 3), qkv, scale, bias16, mask


def _launch_spatial(qkv, scale, bias16, num_heads, ws, mask):
    from fr_tpu_torch.ops._build import check_launch, load_library

    tc = _spatial_route(qkv, num_heads, ws)
    (B, H, W, C), qkv, scale, bias16, mask = _spatial_operands(
        qkv, scale, bias16, num_heads, ws, mask,
        *(_tc_check(False, mask is not None) if tc
          else (_smem_bytes, _SMEM_LIMIT)))
    out = torch.empty((B, H, W, C), dtype=torch.float32, device=qkv.device)
    if B == 0:
        return out
    lib = load_library()
    with torch.cuda.device(qkv.device):
        if tc:
            nw = (H // ws) * (W // ws)
            vec, (qkv,) = _tc_operands(C // num_heads, C, qkv)
            masked = mask is not None
            wpc, _ = tensor_core_plan(
                B * nw, nw, num_heads, masked,
                _tc_slots("window_attn_spatial_tc_occupancy",
                          qkv.device.index or 0, ws * ws, C, num_heads,
                          int(masked), 0))
            name = "window_attn_spatial_fwd_tc"
            err = lib.window_attn_spatial_fwd_tc(
                qkv.data_ptr(), scale.data_ptr(), bias16.data_ptr(),
                mask.data_ptr() if mask is not None else None,
                out.data_ptr(), B, H, W, C, num_heads, ws, wpc, vec,
                _stream(qkv.device))
        else:
            name = "window_attn_spatial_fwd"
            err = lib.window_attn_spatial_fwd(
                qkv.data_ptr(), scale.data_ptr(), bias16.data_ptr(),
                mask.data_ptr() if mask is not None else None,
                out.data_ptr(), B, H, W, C, num_heads, ws,
                _DTYPE_CODE[qkv.dtype], _DTYPE_CODE[torch.float32],
                _THREADS, _stream(qkv.device))
    check_launch(lib, err, name)
    route_launches["fwd_tensor_cores" if tc else "fwd_cuda_cores"] += 1
    return out


def _launch_spatial_bwd(qkv, scale, bias16, g, num_heads, ws, mask):
    from fr_tpu_torch.ops._build import check_launch, load_library

    tc = _spatial_route(qkv, num_heads, ws)
    (B, H, W, C), qkv, scale, bias16, mask = _spatial_operands(
        qkv, scale, bias16, num_heads, ws, mask,
        *(_tc_check(True, mask is not None) if tc
          else (_bwd_smem_bytes, _BWD_SMEM_LIMIT)))
    N = ws * ws
    nw = (H // ws) * (W // ws)
    dev = qkv.device
    if tuple(g.shape) != (B, H, W, C) or g.device != dev:
        raise ValueError(f"g must be {(B, H, W, C)} on {dev}, got "
                         f"{tuple(g.shape)} on {g.device}")
    # fr_tpu rounds g to the compute dtype before every product
    g = g.to(qkv.dtype).contiguous()
    cols = N * N + 1
    dqkv = torch.empty_like(qkv)
    sums = torch.empty((num_heads, cols), dtype=torch.float32, device=dev)
    lib = load_library()
    f32 = dict(dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        if tc:
            vec, (qkv, g) = _tc_operands(C // num_heads, C, qkv, g)
            masked = mask is not None
            wpc, ctas = tensor_core_plan(
                B * nw, nw, num_heads, masked,
                _tc_slots("window_attn_spatial_tc_occupancy", dev.index or 0,
                          N, C, num_heads, int(masked), 1))
            partial = torch.empty((ctas * num_heads, cols), **f32)
            name = "window_attn_spatial_bwd_tc"
            err = lib.window_attn_spatial_bwd_tc(
                qkv.data_ptr(), scale.data_ptr(), bias16.data_ptr(),
                mask.data_ptr() if mask is not None else None, g.data_ptr(),
                dqkv.data_ptr(), partial.data_ptr(), sums.data_ptr(), B, H,
                W, C, num_heads, ws, wpc, vec, _stream(dev))
        else:
            partial = torch.empty((B * nw * num_heads, cols), **f32)
            name = "window_attn_spatial_bwd"
            err = lib.window_attn_spatial_bwd(
                qkv.data_ptr(), scale.data_ptr(), bias16.data_ptr(),
                mask.data_ptr() if mask is not None else None, g.data_ptr(),
                dqkv.data_ptr(), partial.data_ptr(), sums.data_ptr(), B, H,
                W, C, num_heads, ws, _DTYPE_CODE[qkv.dtype], _BWD_THREADS,
                _stream(dev))
    check_launch(lib, err, name)
    route_launches["bwd_tensor_cores" if tc else "bwd_cuda_cores"] += 1
    dbias = sums[:, :N * N].reshape(num_heads, N, N).contiguous()
    return dqkv, sums[:, N * N].contiguous(), dbias


def spatial_attention_backward(qkv: torch.Tensor, scale: torch.Tensor,
                               bias16: torch.Tensor, g: torch.Tensor,
                               num_heads: int, ws: int,
                               mask: Optional[torch.Tensor] = None):
    """(dqkv, dscale, dbias) of fused_window_attention_spatial for the
    output cotangent g (B, H, W, C): the kernel on a CUDA tensor (counted on
    fused_window_attention_spatial.backward_launches), the plain version on
    a CPU tensor."""
    if _device(qkv) == "cpu":
        return window_attention_spatial_backward_reference(
            qkv, scale, bias16, g, num_heads, ws, mask)
    grads = _launch_spatial_bwd(qkv, scale, bias16, g, num_heads, ws, mask)
    _bump((fused_window_attention_spatial, "backward_launches"))
    return grads


def _spatial_forward(qkv, scale, bias16, num_heads, ws, mask):
    if _device(qkv) == "cpu":
        return window_attention_spatial_reference(qkv, scale, bias16,
                                                  num_heads, ws, mask)
    out = _launch_spatial(qkv, scale, bias16, num_heads, ws, mask)
    _bump((fused_window_attention_spatial, "launches"))
    return out


class _SpatialAttention(torch.autograd.Function):
    """fr_tpu's custom_vjp of the spatial op: saves the inputs, the backward
    recomputes the forward (_sp_bwd_rule); the mask gets no gradient."""

    @staticmethod
    def forward(ctx, qkv, scale, bias16, mask, num_heads, ws):
        ctx.num_heads, ctx.ws = num_heads, ws
        ctx.save_for_backward(qkv, scale, bias16, mask)
        return _spatial_forward(qkv, scale, bias16, num_heads, ws, mask)

    @staticmethod
    def backward(ctx, g):
        qkv, scale, bias16, mask = ctx.saved_tensors
        grads = spatial_attention_backward(qkv, scale, bias16, g,
                                           ctx.num_heads, ctx.ws, mask)
        return (*grads, None, None, None)


def fused_window_attention_spatial(qkv: torch.Tensor, scale: torch.Tensor,
                                   bias16: torch.Tensor, num_heads: int,
                                   ws: int,
                                   mask: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """fr_tpu's spatial op: qkv (B, H, W, 3C) in the compute dtype
    (already rolled for SW-MSA), scale (h,), bias16 (h, N, N) and mask
    (nWy·nWx, N, N) f32 → (B, H, W, C) f32. Differentiable in qkv, scale
    and bias16."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (qkv, scale, bias16)):
        return _SpatialAttention.apply(qkv, scale, bias16, mask, num_heads,
                                       ws)
    return _spatial_forward(qkv, scale, bias16, num_heads, ws, mask)


fused_window_attention_spatial.launches = 0
fused_window_attention_spatial.backward_launches = 0


# ---------------------------------------------------------------------------
# Entry-fused variant (row 18)
# ---------------------------------------------------------------------------

def _project(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """fr_tpu's ``_pkx_qkv``: qkv = round(x·round(w)ᵀ accumulated in f32 +
    b), rounded once, after the f32 bias add. w is (3C, C)."""
    cd = x.dtype
    qkv32 = torch.matmul(x.float(), w.to(cd).float().t()) + b.float()
    return qkv32.to(cd)


def window_attention_qkv_reference(x: torch.Tensor, w: torch.Tensor,
                                   b: torch.Tensor, scale: torch.Tensor,
                                   bias16: torch.Tensor, num_heads: int,
                                   mask: Optional[torch.Tensor] = None,
                                   out_dtype: Optional[torch.dtype] = None
                                   ) -> torch.Tensor:
    """Plain PyTorch twin of fr_tpu's ``_pkx_jnp``: the projection as the
    kernel forms it, then the per-head function → (B·nW, N, C) out_dtype
    (default f32)."""
    return window_attention_reference(_project(x, w, b), scale, bias16,
                                      num_heads, mask, out_dtype)


def _chain(x, w, dqkv, db_from):
    """The projection's backward (fr_tpu :634-641, :790-799): dx =
    round(round(dqkv)·round(w)) in x's dtype, dw = round(dqkv)ᵀ·x in f32
    ((3C, C), nn.Linear's layout), db = Σ db_from in f32."""
    cd = x.dtype
    B_, N, C = x.shape
    d2 = dqkv.to(cd).float().reshape(B_ * N, 3 * C)
    dx = torch.matmul(d2, w.to(cd).float()).to(cd).reshape(B_, N, C)
    dw = torch.matmul(d2.t(), x.reshape(B_ * N, C).float())
    db = db_from.float().reshape(B_ * N, 3 * C).sum(dim=0)
    return dx, dw, db


def window_attention_qkv_backward_reference(
        x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
        scale: torch.Tensor, bias16: torch.Tensor, g: torch.Tensor,
        num_heads: int, mask: Optional[torch.Tensor] = None):
    """Plain version of the all-in-kernel backward (fr_tpu's
    ``_pkx_bwd_body``): (dx, dw, db, dscale, dbias), with db the sum of the
    unrounded f32 dqkv."""
    qkv = _project(x, w, b)
    p, s_raw = _softmax_probs(qkv, scale, bias16, num_heads, mask)
    dqkv32, ds, _ = _grad_products(qkv, scale, p, g, num_heads)
    return (*_chain(x, w, dqkv32, dqkv32),
            torch.sum(ds * s_raw, dim=(0, 2, 3)), torch.sum(ds, dim=0))


def _qkv_smem_bytes(N: int, hd: int, backward: bool) -> int:
    """Dynamic shared memory of one entry-fused block
    (csrc/window_attn_qkv.cu): the forward's or the recompute backward's,
    plus the projection's staging (an x chunk and the head's rows of W),
    plus in the backward the raw q and k."""
    stage = N * _PROJ_CHUNK + 3 * hd * (_PROJ_CHUNK + 1)
    if backward:
        return _bwd_smem_bytes(N, hd) + 4 * (2 * N * (hd + 1) + stage)
    return _smem_bytes(N, hd) + 4 * stage


def _qkv_operands(x, w, b, scale, bias16, num_heads, n_win_per_img, mask,
                  backward):
    if x.dim() != 3:
        raise ValueError(f"x must be (B·nW, N, C), got {tuple(x.shape)}")
    B_, N, C = x.shape
    if C % num_heads:
        raise ValueError(f"C={C} is not divisible by {num_heads} heads")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x {x.dtype}: the kernel takes float32 or bfloat16")
    if B_ % n_win_per_img:
        raise ValueError(f"{B_} windows are not whole images of "
                         f"{n_win_per_img}")
    smem = _qkv_smem_bytes(N, C // num_heads, backward)
    if smem > _BWD_SMEM_LIMIT:
        raise ValueError(f"N={N}, head dim {C // num_heads} needs {smem} B "
                         f"of shared memory; the kernel takes ≤ "
                         f"{_BWD_SMEM_LIMIT}")
    dev = x.device
    for name, t, shape in (("w", w, (3 * C, C)), ("b", b, (3 * C,))):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be float32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return ((B_, N, C), x.contiguous(), w.contiguous(), b.contiguous(),
            *_checked_params(dev, num_heads, N, n_win_per_img, scale, bias16,
                             mask))


def _launch_qkv(x, w, b, scale, bias16, num_heads, n_win_per_img, mask,
                out_dtype):
    from fr_tpu_torch.ops._build import check_launch, load_library

    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out {out_dtype}: the kernel writes float32 or "
                        f"bfloat16")
    (B_, N, C), x, w, b, scale, bias16, mask = _qkv_operands(
        x, w, b, scale, bias16, num_heads, n_win_per_img, mask, False)
    out = torch.empty((B_, N, C), dtype=out_dtype, device=x.device)
    if B_ == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.window_attn_qkv_fwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
            bias16.data_ptr(), mask.data_ptr() if mask is not None else None,
            out.data_ptr(), B_, N, C, num_heads, n_win_per_img,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], _THREADS,
            _stream(x.device))
    check_launch(lib, err, "window_attn_qkv_fwd")
    return out


def _launch_qkv_bwd(x, w, b, scale, bias16, g, num_heads, n_win_per_img,
                    mask):
    from fr_tpu_torch.ops._build import check_launch, load_library

    (B_, N, C), x, w, b, scale, bias16, mask = _qkv_operands(
        x, w, b, scale, bias16, num_heads, n_win_per_img, mask, True)
    g = _checked_cotangent(g, x, B_, N, C)
    dev = x.device
    rows = B_ * N
    chunks = -(-rows // _QKV_CHUNK_ROWS)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dqkv32 = torch.empty((rows, 3 * C), **f32)
    partial = torch.empty((B_ * num_heads, N * N + 1), **f32)
    sums = torch.empty((num_heads, N * N + 1), **f32)
    wpartial = torch.empty((chunks, 3 * C, C + 1), **f32)
    wsums = torch.empty((3 * C, C + 1), **f32)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.window_attn_qkv_bwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
            bias16.data_ptr(), mask.data_ptr() if mask is not None else None,
            g.data_ptr(), dx.data_ptr(), dqkv32.data_ptr(),
            partial.data_ptr(), sums.data_ptr(), wpartial.data_ptr(),
            wsums.data_ptr(), B_, N, C, num_heads, n_win_per_img,
            _DTYPE_CODE[x.dtype], _BWD_THREADS, _QKV_CHUNK_ROWS,
            _stream(dev))
    check_launch(lib, err, "window_attn_qkv_bwd")
    dbias = sums[:, :N * N].reshape(num_heads, N, N).contiguous()
    return (dx, wsums[:, :C].contiguous(), wsums[:, C].contiguous(),
            sums[:, N * N].contiguous(), dbias)


def qkv_attention_backward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           scale: torch.Tensor, bias16: torch.Tensor,
                           g: torch.Tensor, num_heads: int,
                           n_win_per_img: int,
                           mask: Optional[torch.Tensor] = None):
    """(dx, dw, db, dscale, dbias) of the all-in-kernel backward: the
    kernels of csrc/window_attn_qkv.cu on a CUDA tensor (counted on
    fused_window_attention_packed_qkv.backward_launches), the plain version
    on a CPU tensor."""
    if _device(x) == "cpu":
        return window_attention_qkv_backward_reference(
            x, w, b, scale, bias16, g, num_heads, mask)
    grads = _launch_qkv_bwd(x, w, b, scale, bias16, g, num_heads,
                            n_win_per_img, mask)
    _bump((fused_window_attention_packed_qkv, "backward_launches"))
    return grads


def hybrid_backward(x, w, b, scale, bias16, g, num_heads, n_win_per_img,
                    mask=None):
    """fr_tpu's default backward of the entry-fused op (:775-803): qkv
    recomputed with torch.matmul, the row-2 recompute backward
    (window_attention_backward: a kernel on a CUDA tensor), then dx and dw
    with torch.matmul; db sums the compute-dtype dqkv."""
    qkv = _project(x, w, b)
    dqkv, dscale, dbias = window_attention_backward(
        qkv, scale, bias16, g, num_heads, n_win_per_img, mask)
    return (*_chain(x, w, dqkv, dqkv), dscale, dbias)


def _qkv_forward(x, w, b, scale, bias16, num_heads, n_win_per_img, mask,
                 out_dtype):
    if _device(x) == "cpu":
        return window_attention_qkv_reference(x, w, b, scale, bias16,
                                              num_heads, mask, out_dtype)
    out = _launch_qkv(x, w, b, scale, bias16, num_heads, n_win_per_img,
                      mask, out_dtype)
    _bump((fused_window_attention_packed_qkv, "launches"))
    return out


class _EntryFusedAttention(torch.autograd.Function):
    """fr_tpu's custom_vjp of the entry-fused op: saves the inputs; the
    backward route is read from _PKX_HYBRID_BWD when it runs."""

    @staticmethod
    def forward(ctx, x, w, b, scale, bias16, mask, num_heads, n_win_per_img,
                out_dtype):
        ctx.num_heads, ctx.n_win_per_img = num_heads, n_win_per_img
        ctx.save_for_backward(x, w, b, scale, bias16, mask)
        return _qkv_forward(x, w, b, scale, bias16, num_heads, n_win_per_img,
                            mask, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, b, scale, bias16, mask = ctx.saved_tensors
        route = hybrid_backward if _PKX_HYBRID_BWD else qkv_attention_backward
        grads = route(x, w, b, scale, bias16, g, ctx.num_heads,
                      ctx.n_win_per_img, mask)
        return (*grads, None, None, None, None)


def fused_window_attention_packed_qkv(x: torch.Tensor, w: torch.Tensor,
                                      b: torch.Tensor, scale: torch.Tensor,
                                      bias16: torch.Tensor, num_heads: int,
                                      n_win_per_img: int,
                                      mask: Optional[torch.Tensor] = None,
                                      out_dtype: Optional[torch.dtype] = None,
                                      head_group: int = 0) -> torch.Tensor:
    """fr_tpu's entry-fused op: x (B·nW, N, C) in the compute dtype, w
    (3C, C) and b (3C,) f32, scale (h,), bias16 (h, N, N), mask
    (n_win_per_img, N, N) f32 → (B·nW, N, C) out_dtype (default f32), equal
    to the packed entry on round(x·wᵀ + b). Differentiable in x, w, b,
    scale and bias16. head_group (0 = all heads) must divide the heads, as
    fr_tpu asserts; the port computes the per-head function at every
    grouping. fr_tpu's block_rows and interpret have no counterpart."""
    checked_head_group(num_heads, head_group)
    if mask is not None and mask.shape[0] != n_win_per_img:
        raise ValueError(f"mask has {mask.shape[0]} windows, "
                         f"n_win_per_img is {n_win_per_img}")
    out_dtype = out_dtype or torch.float32
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, b, scale, bias16)):
        return _EntryFusedAttention.apply(x, w, b, scale, bias16, mask,
                                          num_heads, n_win_per_img, out_dtype)
    return _qkv_forward(x, w, b, scale, bias16, num_heads, n_win_per_img,
                        mask, out_dtype)


fused_window_attention_packed_qkv.launches = 0
fused_window_attention_packed_qkv.backward_launches = 0
