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
        _pkx_fwd and _pkx_bwd_rule). Its forward has two bodies, picked by
        dtype and shape (``_qkv_tc_route``), with no fallback from one to
        the other:
          tensor cores  bf16 on the row-1 kernel's tile (tensor_core_route),
                        C a multiple of 16 and a one-lane CTA's shared
                        memory (_qkv_tc_smem_bytes) within 227 KB, every
                        AlterNet50 site: window_attn_qkv_fwd_tc, the
                        projection by mma.sync from the head's slice of W
                        into the row-1 tensor-core body, several windows a
                        CTA in window lanes (qkv_tc_lanes picks how many);
          CUDA cores    f32, or bf16 off that tile: window_attn_qkv_fwd.
        Its backward takes one of fr_tpu's two routes by
        ``_PKX_HYBRID_BWD``, read at backward time:
          True (fr_tpu's default), the hybrid: qkv recomputed with
            torch.matmul (a product outside any kernel in fr_tpu too), the
            row-2 recompute backward kernel, then dx and dW with
            torch.matmul, as fr_tpu does with XLA dots; db sums the
            compute-dtype dqkv;
          False, the all-in-kernel backward (csrc/window_attn_qkv.cu,
            fr_tpu's _pkx_bwd program, pallas_call :835): dx, dW and db
            from hand-written kernels; db sums the unrounded f32 dqkv, so
            the routes differ in bf16 (fr_tpu's do too). Two bodies, picked
            by ``_qkv_bwd_tc_route`` as the forward's:
              tensor cores  bf16 on the same tile with the backward's
                            one-lane CTA (_qkv_bwd_tc_smem_bytes) within
                            227 KB, every AlterNet50 site:
                            window_attn_qkv_bwd_tc. The scalar projection
                            bounded the CUDA-core body (two shared-memory
                            reads per FMA); here a CTA per (run of windows,
                            head) holds the head's bf16 slice of W, recomputes
                            q, k, v by mma.sync and runs the row-2 kernel's
                            recompute backward in window lanes, sums db from
                            the f32 dq, dk, dv and writes them once rounded
                            to a bf16 dqkv; dx and dW are mma.sync products
                            of that dqkv (dW in row chunks that fill the
                            card, qkv_dw_chunk_rows), every sum in a fixed
                            order;
              CUDA cores    f32, or bf16 off that tile:
                            window_attn_qkv_bwd, the f32 dqkv through
                            device memory and 64×64 f32 FMA products.

The weight is nn.Linear's (3C, C) f32, the module's own parameter: the
transpose of fr_tpu's (C, 3C) w. The kernels read that layout, so no copy is
made, and dW comes back in it.

Launch counters (ROADMAP §2 rows):

    row 17  fused_window_attention_spatial.launches, .backward_launches;
            bf16 at N ≤ 64 takes the tensor-core kernels, as the windows
            API does (fused_window_attn.tensor_core_route), and every
            launch also counts on fused_window_attn.route_launches
    row 18  fused_window_attention_packed_qkv.launches (forward; each
            launch also counts on fused_window_attn.route_launches,
            "fwd_tensor_cores" or "fwd_cuda_cores" by body),
            .backward_launches (the all-in-kernel backward, row 18b; each
            launch also counts on route_launches, "bwd_tensor_cores" or
            "bwd_cuda_cores" by body); the hybrid backward counts on
            window_attention_backward.launches (row 2) and on
            route_launches as the row-2 kernel does

A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
or raises.
"""

from __future__ import annotations

import functools
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

# token rows per dW/db partial of the all-in-kernel backward's CUDA-core body
_QKV_CHUNK_ROWS = 2048
# the tensor-core backward's products (window_attn_qkv.cu): CTA tiles of
# kMmaBM × kMmaBN outputs, k staged kMmaBK deep; the dW product's row chunks
# are sized so that its grid holds about _QKV_DW_CTAS CTAs (two for each of
# an H100's 132 SMs)
_MMA_BM, _MMA_BN, _MMA_BK = 128, 64, 32
_QKV_DW_CTAS = 264
_PROJ_CHUNK = 32   # csrc/window_attn_qkv.cu's kProjChunk
# window lanes of the tensor-core forward: at most 32 warps a CTA (1,024
# threads) and 15 lanes (its named barriers 1..15)
_QKV_MAX_WARPS = 32
_QKV_MAX_LANES = 15


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
    """Dynamic shared memory of one entry-fused block on the CUDA cores
    (csrc/window_attn_qkv.cu): the forward's or the recompute backward's,
    plus the projection's staging (an x chunk and the head's rows of W),
    plus in the backward the raw q and k."""
    stage = N * _PROJ_CHUNK + 3 * hd * (_PROJ_CHUNK + 1)
    if backward:
        return _bwd_smem_bytes(N, hd) + 4 * (2 * N * (hd + 1) + stage)
    return _smem_bytes(N, hd) + 4 * stage


def _qkv_tc_smem_bytes(N: int, C: int, hd: int, masked: bool,
                       lanes: int) -> int:
    """Dynamic shared memory of a tensor-core forward CTA
    (window_attn_qkv.cu's qkv_tc_smem_bytes). Shared by its window lanes:
    the f32 bias (and mask) tiles (N, NP + 8) and the head's 3·HDP values of
    b; a bf16 zero row and the head's slice of W (3·HDP, C + 8). Per lane:
    the q, k, v tiles (N, HDP + 8) and one x window (N, C + 8). NP and HDP
    are N and hd padded to 16."""
    np_ = 16 * -(-N // 16)
    hdp = 16 * -(-hd // 16)
    ld = hdp + 8
    bias = N * (np_ + 8) * (2 if masked else 1)
    return 4 * (bias + 3 * hdp) + 2 * (ld + 3 * hdp * (C + 8) + lanes * (
        3 * N * ld + N * (C + 8)))


def _qkv_bwd_tc_smem_bytes(N: int, C: int, hd: int, masked: bool,
                           lanes: int) -> int:
    """Dynamic shared memory of a tensor-core backward CTA
    (window_attn_qkv.cu's qkv_bwd_tc_smem_bytes): the forward's shared part
    (bias and mask tiles, the head's b, a zero row, W's slice) and per lane
    f32 the norms and flags of the q and k rows (4·NP), the warps' column
    sums of one window's dq, dk, dv (NT·3·HDP) and the lane's db (3·HDP);
    bf16 q̂, k̂, the raw q, k, v and two g tiles (N, HDP + 8), the round(p)
    and round(ds·scale) tiles (NP, NP + 8) and one x window (N, C + 8)."""
    nt = -(-N // 16)
    np_ = 16 * nt
    hdp = 16 * -(-hd // 16)
    ld = hdp + 8
    bias = N * (np_ + 8) * (2 if masked else 1)
    lane_f32 = 4 * np_ + (nt + 1) * 3 * hdp
    lane_bf16 = 7 * N * ld + 2 * np_ * (np_ + 8) + N * (C + 8)
    return 4 * (bias + 3 * hdp + lanes * lane_f32) + 2 * (
        ld + 3 * hdp * (C + 8) + lanes * lane_bf16)


def _qkv_tc_fits(x: torch.Tensor, num_heads: int, masked: bool,
                 smem_bytes) -> bool:
    """bf16 on the row-1 kernel's tile (tensor_core_route), C a multiple of
    16 (whole k-steps of the projection, 16-byte copies of x) and a
    one-lane CTA, ``smem_bytes(N, C, hd, masked, 1)``, within the card's
    227 KB of shared memory."""
    if x.dim() != 3 or x.shape[2] % num_heads:
        return False
    _, N, C = x.shape
    hd = C // num_heads
    return (C % 16 == 0 and tensor_core_route(x.dtype, N, hd)
            and smem_bytes(N, C, hd, masked, 1) <= _BWD_SMEM_LIMIT)


def _qkv_tc_route(x: torch.Tensor, num_heads: int, masked: bool) -> bool:
    """Whether an entry-fused forward takes the tensor-core body
    (_qkv_tc_fits with the forward's CTA). Every other call takes the
    CUDA-core kernel."""
    return _qkv_tc_fits(x, num_heads, masked, _qkv_tc_smem_bytes)


def _qkv_bwd_tc_route(x: torch.Tensor, num_heads: int, masked: bool
                      ) -> bool:
    """Whether an all-in-kernel backward takes the tensor-core body
    (_qkv_tc_fits with the backward's CTA). Every other call takes the
    CUDA-core kernels."""
    return _qkv_tc_fits(x, num_heads, masked, _qkv_bwd_tc_smem_bytes)


def qkv_tc_lanes(N: int, C: int, hd: int, masked: bool, ctas_per_sm,
                 smem_bytes=_qkv_tc_smem_bytes) -> int:
    """The window lanes per CTA of a tensor-core entry-fused kernel (the
    forward's CTA by default, ``smem_bytes`` the backward's): of the lane
    counts whose CTA fits 227 KB (at most _QKV_MAX_WARPS warps and
    _QKV_MAX_LANES lanes), the one that keeps the most warps resident on an
    SM, ctas_per_sm(lanes)·lanes·NT (the card's occupancy API, which counts
    shared memory and registers); a tie goes to more lanes, which stage W
    fewer times."""
    nt = -(-N // 16)
    best, most = 1, -1
    for lanes in range(1, min(_QKV_MAX_LANES, _QKV_MAX_WARPS // nt) + 1):
        if smem_bytes(N, C, hd, masked, lanes) > _BWD_SMEM_LIMIT:
            break
        warps = ctas_per_sm(lanes) * lanes * nt
        if warps >= most:
            best, most = lanes, warps
    return best


@functools.lru_cache(maxsize=None)
def _qkv_tc_launch(index: int, N: int, C: int, num_heads: int,
                   masked: bool, backward: bool = False):
    """(window lanes, CTAs that card ``index`` holds at once) of the
    tensor-core forward (or backward) at these shapes, from
    window_attn_qkv_tc_occupancy (window_attn_qkv_bwd_tc_occupancy)."""
    from fr_tpu_torch.ops._build import check_launch, load_library

    lib = load_library()
    entry = ("window_attn_qkv_bwd_tc_occupancy" if backward
             else "window_attn_qkv_tc_occupancy")

    def per_sm(lanes):
        with torch.cuda.device(index):
            n = getattr(lib, entry)(N, C, num_heads, int(masked), lanes)
        check_launch(lib, -n if n < 0 else 0, entry)
        return n
    lanes = qkv_tc_lanes(N, C, C // num_heads, masked, per_sm,
                         _qkv_bwd_tc_smem_bytes if backward
                         else _qkv_tc_smem_bytes)
    ctas = per_sm(lanes)
    if ctas == 0:
        raise RuntimeError(f"{entry}: no CTA fits on an SM at N={N}, "
                           f"C={C}, {num_heads} heads")
    return lanes, ctas * torch.cuda.get_device_properties(
        index).multi_processor_count


def _qkv_operands(x, w, b, scale, bias16, num_heads, n_win_per_img, mask,
                  smem_bytes):
    """Validates what the entry-fused kernels take, with ``smem_bytes(N,
    hd)`` the body's shared memory; returns (B·nW, N, C) and the operands
    contiguous."""
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
    smem = smem_bytes(N, C // num_heads)
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


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it at a 16-byte-aligned address (a view can start
    anywhere)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_qkv(x, w, b, scale, bias16, num_heads, n_win_per_img, mask,
                out_dtype):
    from fr_tpu_torch.ops._build import check_launch, load_library

    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out {out_dtype}: the kernel writes float32 or "
                        f"bfloat16")
    masked = mask is not None
    tc = _qkv_tc_route(x, num_heads, masked)
    if tc:
        C = x.shape[2]

        def smem(N, hd):
            return _qkv_tc_smem_bytes(N, C, hd, masked, 1)
    else:
        def smem(N, hd):
            return _qkv_smem_bytes(N, hd, False)
    (B_, N, C), x, w, b, scale, bias16, mask = _qkv_operands(
        x, w, b, scale, bias16, num_heads, n_win_per_img, mask, smem)
    out = torch.empty((B_, N, C), dtype=out_dtype, device=x.device)
    if B_ == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        if tc:
            x, w = _aligned16(x), _aligned16(w)
            lanes, slots = _qkv_tc_launch(x.device.index or 0, N, C,
                                          num_heads, masked)
            wpc, _ = tensor_core_plan(B_, n_win_per_img, num_heads, masked,
                                      slots)
            name = "window_attn_qkv_fwd_tc"
            err = lib.window_attn_qkv_fwd_tc(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
                bias16.data_ptr(),
                mask.data_ptr() if mask is not None else None,
                out.data_ptr(), B_, N, C, num_heads, n_win_per_img,
                _DTYPE_CODE[out_dtype], wpc, lanes, _stream(x.device))
        else:
            name = "window_attn_qkv_fwd"
            err = lib.window_attn_qkv_fwd(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
                bias16.data_ptr(),
                mask.data_ptr() if mask is not None else None,
                out.data_ptr(), B_, N, C, num_heads, n_win_per_img,
                _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], _THREADS,
                _stream(x.device))
    check_launch(lib, err, name)
    route_launches["fwd_tensor_cores" if tc else "fwd_cuda_cores"] += 1
    return out


def qkv_dw_chunk_rows(rows: int, C: int) -> int:
    """Token rows per dW partial of the tensor-core backward: the dW
    product's (3C, C) output is ⌈3C / 128⌉·⌈C / 64⌉ CTA tiles, and the rows
    are cut into enough chunks (whole k steps of 32) that the grid holds
    about _QKV_DW_CTAS CTAs. A function of the shapes alone, so the sum
    order, and with it dW's bits, does not depend on the card."""
    tiles = -(-3 * C // _MMA_BM) * -(-C // _MMA_BN)
    chunks = max(1, -(-_QKV_DW_CTAS // tiles))
    return _MMA_BK * max(1, -(-rows // (chunks * _MMA_BK)))


def _launch_qkv_bwd(x, w, b, scale, bias16, g, num_heads, n_win_per_img,
                    mask):
    from fr_tpu_torch.ops._build import check_launch, load_library

    masked = mask is not None
    tc = _qkv_bwd_tc_route(x, num_heads, masked)
    if tc:
        C = x.shape[2]

        def smem(N, hd):
            return _qkv_bwd_tc_smem_bytes(N, C, hd, masked, 1)
    else:
        def smem(N, hd):
            return _qkv_smem_bytes(N, hd, True)
    (B_, N, C), x, w, b, scale, bias16, mask = _qkv_operands(
        x, w, b, scale, bias16, num_heads, n_win_per_img, mask, smem)
    g = _checked_cotangent(g, x, B_, N, C)
    dev = x.device
    rows = B_ * N
    hd = C // num_heads
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    lib = load_library()
    if tc:
        x, w, g = _aligned16(x), _aligned16(w), _aligned16(g)
        lanes, slots = _qkv_tc_launch(dev.index or 0, N, C, num_heads,
                                      masked, True)
        wpc, ctas = tensor_core_plan(B_, n_win_per_img, num_heads, masked,
                                     slots)
        chunk = qkv_dw_chunk_rows(rows, C)
        cols = N * N + 1 + 3 * hd
        dqkv = torch.empty((rows, 3 * C), dtype=torch.bfloat16, device=dev)
        w16 = torch.empty((3 * C, C), dtype=torch.bfloat16, device=dev)
        partial = torch.empty((ctas * lanes * num_heads, cols), **f32)
        sums = torch.empty((num_heads, cols), **f32)
        wpartial = torch.empty((-(-rows // chunk), 3 * C, C), **f32)
        wsums = torch.empty((3 * C, C), **f32)
        with torch.cuda.device(dev):
            err = lib.window_attn_qkv_bwd_tc(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
                bias16.data_ptr(), mask.data_ptr() if masked else None,
                g.data_ptr(), dx.data_ptr(), dqkv.data_ptr(), w16.data_ptr(),
                partial.data_ptr(), sums.data_ptr(), wpartial.data_ptr(),
                wsums.data_ptr(), B_, N, C, num_heads, n_win_per_img, wpc,
                lanes, chunk, _stream(dev))
        check_launch(lib, err, "window_attn_qkv_bwd_tc")
        # each head's db columns of q, k and v, in b's order
        db = sums[:, N * N + 1:].reshape(num_heads, 3, hd).transpose(
            0, 1).reshape(3 * C)
        dw = wsums
    else:
        chunks = -(-rows // _QKV_CHUNK_ROWS)
        dqkv32 = torch.empty((rows, 3 * C), **f32)
        partial = torch.empty((B_ * num_heads, N * N + 1), **f32)
        sums = torch.empty((num_heads, N * N + 1), **f32)
        wpartial = torch.empty((chunks, 3 * C, C + 1), **f32)
        wsums = torch.empty((3 * C, C + 1), **f32)
        with torch.cuda.device(dev):
            err = lib.window_attn_qkv_bwd(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
                bias16.data_ptr(), mask.data_ptr() if masked else None,
                g.data_ptr(), dx.data_ptr(), dqkv32.data_ptr(),
                partial.data_ptr(), sums.data_ptr(), wpartial.data_ptr(),
                wsums.data_ptr(), B_, N, C, num_heads, n_win_per_img,
                _DTYPE_CODE[x.dtype], _BWD_THREADS, _QKV_CHUNK_ROWS,
                _stream(dev))
        check_launch(lib, err, "window_attn_qkv_bwd")
        db = wsums[:, C].contiguous()
        dw = wsums[:, :C].contiguous()
    route_launches["bwd_tensor_cores" if tc else "bwd_cuda_cores"] += 1
    dbias = sums[:, :N * N].reshape(num_heads, N, N).contiguous()
    return dx, dw, db, sums[:, N * N].contiguous(), dbias


def qkv_attention_backward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           scale: torch.Tensor, bias16: torch.Tensor,
                           g: torch.Tensor, num_heads: int,
                           n_win_per_img: int,
                           mask: Optional[torch.Tensor] = None):
    """(dx, dw, db, dscale, dbias) of the all-in-kernel backward: the
    kernels of csrc/window_attn_qkv.cu on a CUDA tensor (counted on
    fused_window_attention_packed_qkv.backward_launches and on
    route_launches by body), the plain version on a CPU tensor."""
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
