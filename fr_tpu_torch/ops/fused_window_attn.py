"""Cosine window attention: the Hopper kernels' launch wrappers, their plain
PyTorch versions, and the autograd Function behind fr_tpu's two entries.

Counterpart of fr_tpu/ops/fused_window_attn.py. Both of fr_tpu's entries are
here: ``fused_window_attention_packed`` (the AlterNet shapes, heads·N ≤ 288)
and ``fused_window_attention`` (the per-head entry of the Swin and
EffiAlterNet N=49 shapes). Both compute one per-head function, whose
contract is fr_tpu's pure-jnp math ``_heads_fwd``. Per window and head:

    L2-normalise q, k in f32 (eps 1e-12, rsqrt form) → cast to the compute
    dtype → scores q̂·k̂ᵀ accumulated in f32 → ·scale_h + bias16_h
    (+ mask[w mod nW]) → f32 softmax with a per-head max → p cast to the
    compute dtype → p·v accumulated in f32 → heads concatenated

The packed TPU kernel shares one softmax max over all heads of a row and
returns non-finite output when one head's scores sit ~88 below another's
(ROADMAP §3); the port does not copy that, so one set of kernels serves
both entries:

    csrc/window_attn_fwd.cu    forward             rows 1 (packed), 5 (per-head)
    csrc/window_attn_bwd.cu    recompute backward  rows 2, 6; contract _bwd_jnp
    csrc/window_attn_stats.cu  forward storing p   rows 3, 7; _fwd_body_stats
                               backward from p     rows 4, 8; _bwd_body_stats

(rows of ROADMAP §2). The forward and the recompute backward have two
bodies each, and the wrapper picks one by dtype and shape
(``tensor_core_route``), with no fallback from one to the other:

    tensor cores  bf16, N ≤ 64, an even head dim ≤ 64 (every shape of the
                  models' path: N 9, 36, 49; head dims 32, 38):
                  window_attn_fwd_tc, window_attn_bwd_tc (window_attn_tc.cuh)
    CUDA cores    f32 (TF32 would break the f32 tolerance and goldens), and
                  bf16 beyond that tile, or with ``TENSOR_CORES`` off:
                  window_attn_fwd, window_attn_bwd

Every launch of the two bodies, from any entry or route of this module and
of fused_window_attn_variants.py, also counts on ``route_launches``.

Under autograd an entry takes one of two arms, chosen as fr_tpu chooses:
the recompute arm saves qkv, scale, bias16 and the mask and its backward
recomputes the forward; the stored-stats arm saves the f32 softmax p,
(B·nW, h, N, N), and its backward starts from p. The entry's
``stored_stats`` argument picks the arm (default True on the packed entry,
False on the per-head one, as in fr_tpu); FR_ATTN_STORED_STATS=0/1
overrides it. A call without autograd runs the forward kernel alone. Both
backwards return dqkv in the compute dtype, dscale (h,) and dbias (h, N, N)
in f32, summed over all windows; the mask gets no gradient.

The compute dtype is qkv's dtype (bf16 or f32). A CPU tensor takes the
plain versions; a CUDA tensor launches the kernels or raises.

Kernel launches are counted per entry and per kernel (ROADMAP §2 rows):

    row 1   fused_window_attention_packed.launches
    row 2   window_attention_backward.launches
    row 3   fused_window_attention_packed.stats_launches
    row 4   fused_window_attention_packed.stats_backward_launches
    row 5   fused_window_attention.launches
    row 6   fused_window_attention.backward_launches
    row 7   fused_window_attention.stats_launches
    row 8   fused_window_attention.stats_backward_launches
    row 15  fused_window_attention_packed.grouped_launches
    row 16  fused_window_attention_packed.grouped_backward_launches

Rows 15/16 are fr_tpu's grid-axis head grouping (``_pkg_fwd``/``_pkg_bwd``
of fused_window_attn_variants.py), which its packed entry takes when the
caller passes a head_group with ``_pkg_use``: more than one group and 128-
aligned group channels. The port computes the same per-head function at
every grouping, so the row-1 forward and row-2 backward kernels serve them;
only the counters and the arm differ (the grouped route never stores p, as
fr_tpu's ``_pk_fwd_rule`` switches the stats arm off there).

Direct calls of the wrappers outside the entries count on the wrappers'
own ``launches``: window_attention_backward (also the packed entry's row
2), window_attention_forward_stats and window_attention_backward_stats.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 128
_SMEM_LIMIT = 48 * 1024
_BWD_THREADS = 256
_BWD_SMEM_LIMIT = 227 * 1024
# The tensor-core kernels pad N and the head dim to tiles of 16, at most 4.
_TC_MAX = 64
# CTAs per launch of the tensor-core kernels: at most _TC_WAVES times the
# CTAs of that kernel the card holds at once (the CUDA occupancy API's count
# per SM, times the SMs), each walking an equal run of windows.
_TC_WAVES = 1

# launches of the forward and recompute-backward kernels by body
route_launches = {"fwd_tensor_cores": 0, "fwd_cuda_cores": 0,
                  "bwd_tensor_cores": 0, "bwd_cuda_cores": 0}

# The bf16 body switch, read at every call: True (the default) puts bf16
# calls within the tile on the tensor cores; False puts every call on the
# CUDA-core kernels, whose arithmetic the stored-stats and entry-fused
# kernels share. chip_smoke.py turns it off only to hold those against the
# recompute arm bit for bit in the forward (bf16 training at init amplifies
# any change of rounding; PERF.md §6).
TENSOR_CORES = True


def tensor_core_route(dtype: torch.dtype, N: int, hd: int) -> bool:
    """Whether a call takes the tensor-core kernels (csrc/window_attn_tc.cuh):
    bf16 with N and the head dim at most 64 and the head dim even (its values
    move in bf16 pairs), while TENSOR_CORES is on. f32 and every other bf16
    shape take the CUDA-core kernels."""
    return (TENSOR_CORES and dtype == torch.bfloat16 and 0 < N <= _TC_MAX
            and 0 < hd <= _TC_MAX and hd % 2 == 0)


def tensor_core_plan(n_windows: int, n_win_per_img: int, num_heads: int,
                     masked: bool, slots: int):
    """The tensor-core kernels' launch plan: (windows per CTA, CTAs per
    head). The grid is CTAs · num_heads, block = CTA·num_heads + head, and
    the backward's scratch holds one (N·N + 1) row per block. With a mask a
    CTA's windows share one mask slice (w mod n_win_per_img), so that the
    CTA stages it once. The runs are as short as keeps the grid within
    _TC_WAVES · slots CTAs (slots: the CTAs the card holds at once), so
    that one wave covers every window and bias16[h] is staged as few times
    as that allows. csrc/window_attn_tc.cuh (tc_plan) walks the same runs."""
    groups = n_win_per_img if masked else 1
    per_group = n_windows // groups
    room = max(1, _TC_WAVES * slots)
    wpc = min(per_group, max(1, -(-n_windows * num_heads // room)))
    while (wpc < per_group
           and num_heads * groups * -(-per_group // wpc) > room):
        wpc += 1
    return wpc, groups * -(-per_group // wpc)


def tensor_core_windows(block: int, n_windows: int, n_win_per_img: int,
                        num_heads: int, masked: bool, slots: int):
    """(head, windows) of one block of the plan, in the order the kernel
    walks them."""
    wpc, _ = tensor_core_plan(n_windows, n_win_per_img, num_heads, masked,
                              slots)
    groups = n_win_per_img if masked else 1
    per_group = n_windows // groups
    cta, h = divmod(block, num_heads)
    per_slice = -(-per_group // wpc)
    j, first = cta // per_slice, (cta % per_slice) * wpc
    return h, [r * groups + j
               for r in range(first, min(first + wpc, per_group))]


def _tc_smem_bytes(N: int, hd: int, masked: bool, backward: bool) -> int:
    """Dynamic shared memory of a tensor-core CTA (window_attn_tc.cuh's
    tc_fwd_smem_bytes, tc_bwd_smem_bytes): the f32 bias (and mask) tiles
    (N, NP + 8); bf16 token tiles (N, HDP + 8) — a zero row and two stages
    of q, k, v (forward) or q, k, v, g plus q̂, k̂ (backward); in the
    backward also the round(p) and round(ds·scale) tiles (NP, NP + 8) and
    4·NP + 32 f32 of norms, flags and sums."""
    np_ = 16 * -(-N // 16)
    ld = 16 * -(-hd // 16) + 8
    bias = 4 * N * (np_ + 8) * (2 if masked else 1)
    if backward:
        return (bias + 4 * (4 * np_ + 32)
                + 2 * (ld + 10 * N * ld + 2 * np_ * (np_ + 8)))
    return bias + 2 * (ld + 6 * N * ld)


def _tc_check(backward: bool, masked: bool):
    """The shared-memory size and limit _checked_operands holds a
    tensor-core call to."""
    return (lambda N, hd: _tc_smem_bytes(N, hd, masked, backward),
            _BWD_SMEM_LIMIT)


@functools.lru_cache(maxsize=None)
def _tc_slots(entry: str, index: int, *args) -> int:
    """The CTAs of a tensor-core kernel that card ``index`` holds at once:
    the occupancy entry's count per SM (csrc/window_attn_tc.cuh,
    window_attn_tc_occupancy_entry) times the SMs."""
    from fr_tpu_torch.ops._build import check_launch, load_library

    lib = load_library()
    with torch.cuda.device(index):
        per_sm = getattr(lib, entry)(*args)
    check_launch(lib, -per_sm if per_sm < 0 else 0, entry)
    if per_sm == 0:
        raise RuntimeError(f"{entry}{args}: no CTA fits on an SM")
    return per_sm * torch.cuda.get_device_properties(
        index).multi_processor_count


def _tc_operands(hd: int, C: int, *tensors):
    """The tensors at 4-byte-aligned addresses (a view can start at an odd
    bf16 element; such a one is copied), and the widest copy the kernels
    can make: 16 bytes when every row and head offset and every tensor is
    16-byte aligned, else 4."""
    tensors = [t if t.data_ptr() % 4 == 0 else t.clone() for t in tensors]
    vec = 16 if (hd % 8 == 0 and C % 8 == 0
                 and all(t.data_ptr() % 16 == 0 for t in tensors)) else 4
    return vec, tensors


def _split_heads(qkv: torch.Tensor, num_heads: int):
    """(B·nW, N, 3C) → q, k, v as (B·nW, h, N, hd), in qkv's dtype."""
    W, N, C3 = qkv.shape
    hd = C3 // 3 // num_heads
    heads = qkv.reshape(W, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    return heads[0], heads[1], heads[2]


def _norm(x):
    """fr_tpu's ``_norm``: (x·r, r, active) with r = rsqrt(max(Σx², eps²))
    and active = Σx² > eps²."""
    s2 = torch.sum(x * x, dim=-1, keepdim=True)
    r = torch.rsqrt(torch.clamp_min(s2, 1e-24))
    return x * r, r, s2 > 1e-24


def _softmax_probs(qkv, scale, bias16, num_heads, mask):
    """f32 softmax p (B·nW, h, N, N) and s_raw of ``_heads_fwd``."""
    W, N, _ = qkv.shape
    cd = qkv.dtype
    q, k, _ = _split_heads(qkv, num_heads)
    qnc = _norm(q.float())[0].to(cd).float()
    knc = _norm(k.float())[0].to(cd).float()
    s_raw = torch.matmul(qnc, knc.transpose(-1, -2))          # (W, h, N, N)
    s = s_raw * scale.reshape(1, num_heads, 1, 1) + bias16[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(W // nW, nW, num_heads, N, N) + mask[None, :, None]
             ).reshape(W, num_heads, N, N)
    return torch.softmax(s, dim=-1), s_raw


def _attend(p, qkv, num_heads, out_dtype):
    """round(p)·v accumulated in f32, heads concatenated → out_dtype."""
    W, N, C3 = qkv.shape
    _, _, v = _split_heads(qkv, num_heads)
    out = torch.matmul(p.to(qkv.dtype).float(), v.float())   # (W, h, N, hd)
    return out.permute(0, 2, 1, 3).reshape(W, N, C3 // 3).to(
        out_dtype or torch.float32)


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
    p, _ = _softmax_probs(qkv, scale, bias16, num_heads, mask)
    return _attend(p, qkv, num_heads, out_dtype)


def window_attention_forward_stats_reference(
        qkv: torch.Tensor, scale: torch.Tensor, bias16: torch.Tensor,
        num_heads: int, mask: Optional[torch.Tensor] = None,
        out_dtype: Optional[torch.dtype] = None):
    """Plain PyTorch twin of fr_tpu's ``_fwd_body_stats``: the forward's
    output and the unrounded f32 softmax p, (B·nW, h, N, N) (the port's
    layout: one (window, head) block's p is contiguous)."""
    p, _ = _softmax_probs(qkv, scale, bias16, num_heads, mask)
    return _attend(p, qkv, num_heads, out_dtype), p


def _grad_products(qkv, scale, p, g, num_heads):
    """The backward's products once p is known (``_bwd_jnp`` and
    ``_bwd_body_stats`` alike): dqkv in f32 (before fr_tpu rounds it to the
    compute dtype), ds and the row sums of dq̂∘q̂."""
    W, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    cd = qkv.dtype
    q, k, v = _split_heads(qkv, num_heads)
    qn, qr, qa = _norm(q.float())
    kn, kr, ka = _norm(k.float())
    qnc, knc = qn.to(cd).float(), kn.to(cd).float()
    gc = g.reshape(W, N, num_heads, hd).permute(0, 2, 1, 3).to(cd).float()
    dp = torch.matmul(gc, v.float().transpose(-1, -2))
    dv = torch.matmul(p.to(cd).float().transpose(-1, -2), gc)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dsc = (ds * scale.reshape(1, num_heads, 1, 1)).to(cd).float()
    dqn = torch.matmul(dsc, knc)
    dkn = torch.matmul(dsc.transpose(-1, -2), qnc)
    rs_q = torch.sum(dqn * qn, dim=-1, keepdim=True)
    dq = qr * (dqn - torch.where(qa, qn * rs_q, 0.0))
    dk = kr * (dkn - torch.where(
        ka, kn * torch.sum(dkn * kn, dim=-1, keepdim=True), 0.0))
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(W, N, C3)
    return dqkv, ds, rs_q


def window_attention_backward_reference(
        qkv: torch.Tensor, scale: torch.Tensor, bias16: torch.Tensor,
        g: torch.Tensor, num_heads: int, mask: Optional[torch.Tensor] = None):
    """Plain PyTorch twin of fr_tpu's ``_bwd_jnp``, all heads at once.

    g (B·nW, N, C), any float dtype, is rounded to the compute dtype (qkv's)
    before the products, as ``_bwd_jnp`` does. Returns dqkv (B·nW, N, 3C) in
    the compute dtype, dscale (h,) f32 = Σ ds·s_raw and dbias (h, N, N) f32
    = Σ ds, both summed over the windows."""
    p, s_raw = _softmax_probs(qkv, scale, bias16, num_heads, mask)
    dqkv, ds, _ = _grad_products(qkv, scale, p, g, num_heads)
    return (dqkv.to(qkv.dtype), torch.sum(ds * s_raw, dim=(0, 2, 3)),
            torch.sum(ds, dim=0))


def window_attention_backward_stats_reference(
        qkv: torch.Tensor, scale: torch.Tensor, p: torch.Tensor,
        g: torch.Tensor, num_heads: int):
    """Plain PyTorch twin of fr_tpu's ``_bwd_body_stats``: the exact VJP from
    the stored f32 p (B·nW, h, N, N), with no score recompute; bias16 and
    the mask are not read. dscale comes from fr_tpu's identity
    Σ ds·s_raw = Σ (dq̂·q̂)/scale_h (fused_window_attn.py:595-602)."""
    dqkv, ds, rs_q = _grad_products(qkv, scale, p, g, num_heads)
    return (dqkv.to(qkv.dtype), torch.sum(rs_q, dim=(0, 2, 3)) / scale,
            torch.sum(ds, dim=0))


def _device(qkv: torch.Tensor) -> str:
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no window-attention kernel for device "
                         f"{qkv.device}")
    return qkv.device.type


def _bump(counter) -> None:
    """Adds one launch to (function, attribute name)."""
    fn, attr = counter
    setattr(fn, attr, getattr(fn, attr) + 1)


def _forward(qkv, scale, bias16, num_heads, n_win_per_img, mask, out_dtype,
             counter):
    if _device(qkv) == "cpu":
        return window_attention_reference(qkv, scale, bias16, num_heads,
                                          mask, out_dtype)
    out = _launch(qkv, scale, bias16, num_heads, n_win_per_img, mask,
                  out_dtype)
    _bump(counter)
    return out


def _backward(qkv, scale, bias16, g, num_heads, n_win_per_img, mask,
              counter):
    if _device(qkv) == "cpu":
        return window_attention_backward_reference(qkv, scale, bias16, g,
                                                   num_heads, mask)
    grads = _launch_bwd(qkv, scale, bias16, g, num_heads, n_win_per_img,
                        mask)
    _bump(counter)
    return grads


def _forward_stats(qkv, scale, bias16, num_heads, n_win_per_img, mask,
                   out_dtype, counter):
    if _device(qkv) == "cpu":
        return window_attention_forward_stats_reference(
            qkv, scale, bias16, num_heads, mask, out_dtype)
    res = _launch_fwd_stats(qkv, scale, bias16, num_heads, n_win_per_img,
                            mask, out_dtype)
    _bump(counter)
    return res


def _backward_stats(qkv, scale, p, g, num_heads, counter):
    if _device(qkv) == "cpu":
        return window_attention_backward_stats_reference(qkv, scale, p, g,
                                                         num_heads)
    grads = _launch_bwd_stats(qkv, scale, p, g, num_heads)
    _bump(counter)
    return grads


def window_attention_backward(qkv: torch.Tensor, scale: torch.Tensor,
                              bias16: torch.Tensor, g: torch.Tensor,
                              num_heads: int, n_win_per_img: int,
                              mask: Optional[torch.Tensor] = None):
    """(dqkv, dscale, dbias) of fused_window_attention_packed's recompute
    arm for the output cotangent g. A CPU tensor takes the plain version; a
    CUDA tensor launches the Hopper backward kernel, or raises.
    ``launches`` counts kernel launches."""
    return _backward(qkv, scale, bias16, g, num_heads, n_win_per_img, mask,
                     (window_attention_backward, "launches"))


window_attention_backward.launches = 0


def window_attention_forward_stats(qkv: torch.Tensor, scale: torch.Tensor,
                                   bias16: torch.Tensor, num_heads: int,
                                   n_win_per_img: int,
                                   mask: Optional[torch.Tensor] = None,
                                   out_dtype: Optional[torch.dtype] = None):
    """(out, p) of the stored-stats forward: the kernel of
    csrc/window_attn_stats.cu on a CUDA tensor, the plain version on a CPU
    tensor. ``launches`` counts kernel launches."""
    return _forward_stats(qkv, scale, bias16, num_heads, n_win_per_img,
                          mask, out_dtype or torch.float32,
                          (window_attention_forward_stats, "launches"))


window_attention_forward_stats.launches = 0


def window_attention_backward_stats(qkv: torch.Tensor, scale: torch.Tensor,
                                    p: torch.Tensor, g: torch.Tensor,
                                    num_heads: int):
    """(dqkv, dscale, dbias) from the stored p: the kernel of
    csrc/window_attn_stats.cu on a CUDA tensor, the plain version on a CPU
    tensor. ``launches`` counts kernel launches."""
    return _backward_stats(qkv, scale, p, g, num_heads,
                           (window_attention_backward_stats, "launches"))


window_attention_backward_stats.launches = 0


def stored_stats_arm(stored_stats: bool) -> bool:
    """fr_tpu's one stats switch (``_fwd_rule`` :1949-1953, ``_pk_fwd_rule``
    :1622-1626): FR_ATTN_STORED_STATS in {"0", "1"} overrides the entry's
    stored_stats argument."""
    env = os.environ.get("FR_ATTN_STORED_STATS")
    if env in ("0", "1"):
        return env == "1"
    return bool(stored_stats)


class _WindowAttention(torch.autograd.Function):
    """fr_tpu's custom_vjp of both entries. ``counters`` names the
    (function, attribute) each kernel's launches go to: forward, recompute
    backward, stats forward, stats backward. The recompute arm saves the
    inputs, the stored-stats arm saves p instead of bias16 and the mask."""

    @staticmethod
    def forward(ctx, qkv, scale, bias16, mask, num_heads, n_win_per_img,
                out_dtype, counters, stats):
        ctx.num_heads = num_heads
        ctx.n_win_per_img = n_win_per_img
        ctx.counters = counters
        ctx.stats = stats
        if stats:
            out, p = _forward_stats(qkv, scale, bias16, num_heads,
                                    n_win_per_img, mask, out_dtype,
                                    counters[2])
            ctx.save_for_backward(qkv, scale, p)
            return out
        ctx.save_for_backward(qkv, scale, bias16, mask)
        return _forward(qkv, scale, bias16, num_heads, n_win_per_img, mask,
                        out_dtype, counters[0])

    @staticmethod
    def backward(ctx, g):
        if ctx.stats:
            qkv, scale, p = ctx.saved_tensors
            grads = _backward_stats(qkv, scale, p, g, ctx.num_heads,
                                    ctx.counters[3])
        else:
            qkv, scale, bias16, mask = ctx.saved_tensors
            grads = _backward(qkv, scale, bias16, g, ctx.num_heads,
                              ctx.n_win_per_img, mask, ctx.counters[1])
        return (*grads, None, None, None, None, None, None)


def _entry(counters, qkv, scale, bias16, num_heads, n_win_per_img, mask,
           out_dtype, stored_stats):
    out_dtype = out_dtype or torch.float32
    if mask is not None and mask.shape[0] != n_win_per_img:
        raise ValueError(f"mask has {mask.shape[0]} windows, "
                         f"n_win_per_img is {n_win_per_img}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (qkv, scale, bias16)):
        return _WindowAttention.apply(qkv, scale, bias16, mask, num_heads,
                                      n_win_per_img, out_dtype, counters,
                                      stored_stats)
    return _forward(qkv, scale, bias16, num_heads, n_win_per_img, mask,
                    out_dtype, counters[0])


def checked_head_group(num_heads: int, head_group: int) -> int:
    """fr_tpu's head group: head_group, or all heads for 0; it must divide
    the heads, as fr_tpu asserts."""
    hg = head_group or num_heads
    if hg <= 0 or num_heads % hg:
        raise ValueError(f"head_group {head_group} does not divide "
                         f"{num_heads} heads")
    return hg


def grouped_route(num_heads: int, head_group: int, C: int) -> bool:
    """fr_tpu's ``_pkg_use(ng, Cg)`` (fused_window_attn.py:1455): the
    packed entry takes the grid-axis grouped kernels (rows 15/16) when the
    head_group splits the heads into more than one group of 128-aligned
    channels. head_group 0 means all heads, the full pack."""
    ng = num_heads // checked_head_group(num_heads, head_group)
    return ng > 1 and (C // ng) % 128 == 0


def fused_window_attention_packed(qkv: torch.Tensor, scale: torch.Tensor,
                                  bias16: torch.Tensor, num_heads: int,
                                  n_win_per_img: int,
                                  mask: Optional[torch.Tensor] = None,
                                  out_dtype: Optional[torch.dtype] = None,
                                  stored_stats: bool = True,
                                  head_group: int = 0) -> torch.Tensor:
    """fr_tpu's packed-entry contract: qkv (B·nW, N, 3C) compute-dtype →
    (B·nW, N, C) out_dtype (default f32); scale (h,), bias16 (h, N, N) and
    mask (n_win_per_img, N, N) f32, the mask indexed by window mod nW.
    Differentiable in qkv, scale and bias16.

    stored_stats (default True, as fr_tpu's op; the model passes its own
    choice) picks the stored-stats arm under autograd; FR_ATTN_STORED_STATS
    overrides it. head_group (0 = all heads) is fr_tpu's: it must divide
    the heads, and where ``grouped_route`` holds the call is fr_tpu's
    grid-axis grouped route (rows 15/16), which counts on
    ``grouped_launches``/``grouped_backward_launches`` and never takes the
    stats arm. A CPU tensor takes the plain versions. A CUDA tensor
    launches the Hopper kernels, or raises; there is no fallback. fr_tpu's
    TPU tiling arguments (block_rows, interpret) have no counterpart
    here."""
    entry = fused_window_attention_packed
    if grouped_route(num_heads, head_group, qkv.shape[-1] // 3):
        counters = ((entry, "grouped_launches"),
                    (entry, "grouped_backward_launches"), None, None)
        stats = False
    else:
        counters = ((entry, "launches"), (window_attention_backward,
                                          "launches"),
                    (entry, "stats_launches"),
                    (entry, "stats_backward_launches"))
        stats = stored_stats_arm(stored_stats)
    return _entry(counters, qkv, scale, bias16, num_heads, n_win_per_img,
                  mask, out_dtype, stats)


fused_window_attention_packed.launches = 0
fused_window_attention_packed.stats_launches = 0
fused_window_attention_packed.stats_backward_launches = 0
fused_window_attention_packed.grouped_launches = 0
fused_window_attention_packed.grouped_backward_launches = 0


def fused_window_attention(qkv: torch.Tensor, scale: torch.Tensor,
                           bias16: torch.Tensor, num_heads: int,
                           n_win_per_img: int,
                           mask: Optional[torch.Tensor] = None,
                           out_dtype: Optional[torch.dtype] = None,
                           stored_stats: bool = False) -> torch.Tensor:
    """fr_tpu's per-head entry (fused_window_attn.py:1784), the one its
    models take when heads·N > 288: the same contract as the packed entry,
    stored_stats default False as in fr_tpu. The same kernels serve it; its
    launches count on its own attributes (rows 5–8). fr_tpu's block_rows
    and FR_ATTN_BATCHED are TPU tiling and have no counterpart here."""
    entry = fused_window_attention
    counters = tuple((entry, a) for a in ("launches", "backward_launches",
                                          "stats_launches",
                                          "stats_backward_launches"))
    return _entry(counters, qkv, scale, bias16, num_heads, n_win_per_img,
                  mask, out_dtype, stored_stats_arm(stored_stats))


fused_window_attention.launches = 0
fused_window_attention.backward_launches = 0
fused_window_attention.stats_launches = 0
fused_window_attention.stats_backward_launches = 0


def _smem_bytes(N: int, hd: int) -> int:
    """Dynamic shared memory of one forward (window, head) block: q̂ and k̂
    with a padded row (N, hd+1), v (N, hd), scores (N, N+1), row norms
    (2N). The stored-stats forward uses the same."""
    return 4 * (2 * N * (hd + 1) + N * hd + N * (N + 1) + 2 * N)


def _checked_operands(qkv, scale, bias16, num_heads, n_win_per_img, mask,
                      smem_bytes, smem_limit):
    """Validates what the kernels take; returns (B·nW, N, C) and the
    operands made contiguous. bias16 None skips its check (the stored-stats
    backward does not read it)."""
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
    return ((B_, N, C), qkv.contiguous(), *_checked_params(
        qkv.device, num_heads, N, n_win_per_img, scale, bias16, mask))


def _checked_params(dev, num_heads, N, n_win_per_img, scale, bias16, mask):
    """Checks scale (h,), bias16 (h, N, N) and mask (n_win_per_img, N, N),
    all f32 on dev (bias16 and mask may be None); returns them
    contiguous."""
    expect = {"scale": (scale, (num_heads,))}
    if bias16 is not None:
        expect["bias16"] = (bias16, (num_heads, N, N))
    if mask is not None:
        expect["mask"] = (mask, (n_win_per_img, N, N))
    for name, (t, shape) in expect.items():
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be float32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")

    def contiguous(t):
        return t.contiguous() if t is not None else None
    return scale.contiguous(), contiguous(bias16), contiguous(mask)


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _windows_route(qkv, num_heads) -> bool:
    """tensor_core_route for a windows-API qkv (B·nW, N, 3C)."""
    return (qkv.dim() == 3 and tensor_core_route(
        qkv.dtype, qkv.shape[1], qkv.shape[2] // 3 // num_heads))


def _launch(qkv, scale, bias16, num_heads, n_win_per_img, mask, out_dtype,
            p_out=None):
    """The forward kernel, or with ``p_out`` (B·nW, h, N, N) f32 the
    stored-stats forward that also writes p there."""
    from fr_tpu_torch.ops._build import check_launch, load_library

    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"qkv {qkv.dtype} / out {out_dtype}: the kernel "
                        f"takes float32 or bfloat16")
    tc = p_out is None and _windows_route(qkv, num_heads)
    (B_, N, C), qkv, scale, bias16, mask = _checked_operands(
        qkv, scale, bias16, num_heads, n_win_per_img, mask,
        *(_tc_check(False, mask is not None) if tc
          else (_smem_bytes, _SMEM_LIMIT)))
    out = torch.empty((B_, N, C), dtype=out_dtype, device=qkv.device)
    if B_ == 0:
        return out
    lib = load_library()
    if tc:
        vec, (qkv,) = _tc_operands(C // num_heads, C, qkv)
        masked = mask is not None
        wpc, _ = tensor_core_plan(B_, n_win_per_img, num_heads, masked,
                                  _tc_slots("window_attn_fwd_tc_occupancy",
                                            qkv.device.index or 0, N, C,
                                            num_heads, int(masked)))
        with torch.cuda.device(qkv.device):
            err = lib.window_attn_fwd_tc(
                qkv.data_ptr(), scale.data_ptr(), bias16.data_ptr(),
                mask.data_ptr() if mask is not None else None,
                out.data_ptr(), B_, N, C, num_heads, n_win_per_img,
                _DTYPE_CODE[out_dtype], wpc, vec, _stream(qkv.device))
        check_launch(lib, err, "window_attn_fwd_tc")
        route_launches["fwd_tensor_cores"] += 1
        return out
    args = [qkv.data_ptr(), scale.data_ptr(), bias16.data_ptr(),
            mask.data_ptr() if mask is not None else None, out.data_ptr()]
    name = "window_attn_fwd"
    if p_out is not None:
        args.append(p_out.data_ptr())
        name = "window_attn_fwd_stats"
    with torch.cuda.device(qkv.device):
        err = getattr(lib, name)(
            *args, B_, N, C, num_heads, n_win_per_img,
            _DTYPE_CODE[qkv.dtype], _DTYPE_CODE[out_dtype], _THREADS,
            _stream(qkv.device))
    check_launch(lib, err, name)
    if p_out is None:
        route_launches["fwd_cuda_cores"] += 1
    return out


def _launch_fwd_stats(qkv, scale, bias16, num_heads, n_win_per_img, mask,
                      out_dtype):
    B_, N, _ = qkv.shape
    p = torch.empty((B_, num_heads, N, N), dtype=torch.float32,
                    device=qkv.device)
    return _launch(qkv, scale, bias16, num_heads, n_win_per_img, mask,
                   out_dtype, p_out=p), p


def _bwd_smem_bytes(N: int, hd: int) -> int:
    """Dynamic shared memory of one recompute-backward (window, head)
    block: q̂, k̂, dq̂, dk̂, v, g (N, hd+1); s_raw, p, ds (N, N+1); 6N row
    values and 32 per-warp sums."""
    return 4 * (6 * N * (hd + 1) + 3 * N * (N + 1) + 6 * N + 32)


def _bwd_stats_smem_bytes(N: int, hd: int) -> int:
    """The stored-stats backward's block: q̂, k̂, dq̂, dk̂, v, g (N, hd+1);
    p and round(p)/dp/ds (N, N+1); 6N row values."""
    return 4 * (6 * N * (hd + 1) + 2 * N * (N + 1) + 6 * N)


def _checked_cotangent(g, qkv, B_, N, C):
    if tuple(g.shape) != (B_, N, C) or g.device != qkv.device:
        raise ValueError(f"g must be {(B_, N, C)} on {qkv.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    # _bwd_jnp and _bwd_body_stats round g to the compute dtype before
    # every product
    return g.to(qkv.dtype).contiguous()


def _launch_bwd(qkv, scale, bias16, g, num_heads, n_win_per_img, mask):
    from fr_tpu_torch.ops._build import check_launch, load_library

    tc = _windows_route(qkv, num_heads)
    (B_, N, C), qkv, scale, bias16, mask = _checked_operands(
        qkv, scale, bias16, num_heads, n_win_per_img, mask,
        *(_tc_check(True, mask is not None) if tc
          else (_bwd_smem_bytes, _BWD_SMEM_LIMIT)))
    g = _checked_cotangent(g, qkv, B_, N, C)
    dev = qkv.device
    cols = N * N + 1
    dqkv = torch.empty_like(qkv)
    sums = torch.empty((num_heads, cols), dtype=torch.float32, device=dev)
    lib = load_library()
    if tc:
        vec, (qkv, g) = _tc_operands(C // num_heads, C, qkv, g)
        masked = mask is not None
        wpc, ctas = tensor_core_plan(
            B_, n_win_per_img, num_heads, masked,
            _tc_slots("window_attn_bwd_tc_occupancy", dev.index or 0, N, C,
                      num_heads, int(masked)))
        partial = torch.empty((ctas * num_heads, cols), dtype=torch.float32,
                              device=dev)
        with torch.cuda.device(dev):
            err = lib.window_attn_bwd_tc(
                qkv.data_ptr(), scale.data_ptr(), bias16.data_ptr(),
                mask.data_ptr() if mask is not None else None, g.data_ptr(),
                dqkv.data_ptr(), partial.data_ptr(), sums.data_ptr(),
                B_, N, C, num_heads, n_win_per_img, wpc, vec, _stream(dev))
        check_launch(lib, err, "window_attn_bwd_tc")
        route_launches["bwd_tensor_cores"] += 1
    else:
        partial = torch.empty((B_ * num_heads, cols), dtype=torch.float32,
                              device=dev)
        with torch.cuda.device(dev):
            err = lib.window_attn_bwd(
                qkv.data_ptr(), scale.data_ptr(), bias16.data_ptr(),
                mask.data_ptr() if mask is not None else None, g.data_ptr(),
                dqkv.data_ptr(), partial.data_ptr(), sums.data_ptr(),
                B_, N, C, num_heads, n_win_per_img, _DTYPE_CODE[qkv.dtype],
                _BWD_THREADS, _stream(dev))
        check_launch(lib, err, "window_attn_bwd")
        route_launches["bwd_cuda_cores"] += 1
    dbias = sums[:, :N * N].reshape(num_heads, N, N).contiguous()
    return dqkv, sums[:, N * N].contiguous(), dbias


def _launch_bwd_stats(qkv, scale, p, g, num_heads):
    from fr_tpu_torch.ops._build import check_launch, load_library

    (B_, N, C), qkv, scale, _, _ = _checked_operands(
        qkv, scale, None, num_heads, 1, None, _bwd_stats_smem_bytes,
        _BWD_SMEM_LIMIT)
    g = _checked_cotangent(g, qkv, B_, N, C)
    dev = qkv.device
    if (tuple(p.shape) != (B_, num_heads, N, N) or p.dtype != torch.float32
            or p.device != dev):
        raise ValueError(f"p must be float32 {(B_, num_heads, N, N)} on "
                         f"{dev}, got {p.dtype} {tuple(p.shape)} on "
                         f"{p.device}")
    p = p.contiguous()
    cols = N * N + 1
    dqkv = torch.empty_like(qkv)
    partial = torch.empty((B_ * num_heads, cols), dtype=torch.float32,
                          device=dev)
    sums = torch.empty((num_heads, cols), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.window_attn_bwd_stats(
            qkv.data_ptr(), scale.data_ptr(), p.data_ptr(), g.data_ptr(),
            dqkv.data_ptr(), partial.data_ptr(), sums.data_ptr(),
            B_, N, C, num_heads, _DTYPE_CODE[qkv.dtype], _BWD_THREADS,
            _stream(dev))
    check_launch(lib, err, "window_attn_bwd_stats")
    dbias = sums[:, :N * N].reshape(num_heads, N, N).contiguous()
    return dqkv, sums[:, N * N].contiguous(), dbias
