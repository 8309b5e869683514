"""Global multi-head attention, every token against every token of its
image: softmax(q·kᵀ·scale)·v of each head, read from the packed qkv
projection (B, L, 3·D), with its backward, as an autograd Function.

The ViT encoder (models/vit.py) calls ``global_attention(qkv, heads,
scale)`` once a block on its qkv projection's output and feeds the (B, L, D)
result to the output projection. On a bf16 CUDA tensor both walks are the
hand-written kernels of csrc/global_attn.cu (one CTA per image and head,
every row of the scores whole in a warp's registers; the source's header
has the design): the forward reads q, k and v from the projection by its
strides and writes o as (B, L, H, d) and each row's log-sum-exp in f32; the
backward recomputes P from q, k and that log-sum-exp and writes dq, dk and
dv into one (B, L, 3·D) buffer, the projection output's gradient. No L × L
tensor is ever in device memory. A CUDA tensor of another dtype, or of a
shape the kernels do not take (L > 144, a head dim that is not a multiple
of 16 up to 128), raises; nothing falls back.

The backward takes each row's Dᵢ = Σⱼ Pᵢⱼ dPᵢⱼ in f32 from the P and dP it
multiplies, so each row of the scores' gradient sums to nought with them.
Flash attention's backward takes Dᵢ as dOᵢ·Oᵢ of the bf16 output: where a
row's probabilities are near uniform and its tokens near their mean, as in
ViT-L's deeper blocks at the benchmark's weights, the true dq and dk are
second-order small and that rounding is not. On an H100 at 384 images × 8
heads × 136 tokens × 96, tokens spread 0.03 about a shared mean, flash's
dq is off by 21 times its norm and an exact-D backward's by 0.08; in ViT-L's
first training step flash put the q and k rows of each qkv weight's
gradient from block 2 on off by 2–7 times their norm.

Plain versions, in PyTorch:
- ``attention_reference``: softmax(q·kᵀ·scale)·v in f32, cast back, and
  ``attention_reference_packed``, the same on the packed projection; a
  CPU tensor takes it both ways, its backward autograd's through it;
- ``attention_forward_plain`` and ``attention_backward_plain``: the
  kernels' arithmetic (bf16 products summed in f32, the softmax, P from the
  log-sum-exp, dP and Dᵢ in f32, round(P) and round(dS) as operands), which
  the tests and chip_smoke.py hold the kernels against.

Both walks run inside the span ``encoder:attention`` (utils/profiling.py):
the forward inside the step's ``encoder:forward``, the backward, which the
autograd engine calls, inside ``encoder:backward``. ``global_attention.
launches`` counts the calls by entry (``fwd``, ``bwd``) on either route;
``global_attention.kernel_launches`` the kernels' launches (``fwd``,
``bwd``), one a call on the card.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from fr_tpu_torch.ops._build import check_launch, load_library
from fr_tpu_torch.utils import profiling as spans
from fr_tpu_torch.utils.profiling import span

MAX_TOKENS = 144     # the kernels hold a row of 9 strips of 16 keys
MAX_HEAD_DIM = 128   # a multiple of 16 up to this


def split_heads(qkv: torch.Tensor, heads: int):
    """q, k and v of a (B, L, 3·D) projection as (B, H, L, d) views."""
    b, n, d3 = qkv.shape
    return qkv.reshape(b, n, 3, heads, d3 // (3 * heads)).permute(
        2, 0, 3, 1, 4)


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(B, H, L, d) heads → (B, L, H·d)."""
    b, h, n, d = o.shape
    return o.transpose(1, 2).reshape(b, n, h * d)


def attention_reference(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v in f32, in q's dtype."""
    p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * scale, -1)
    return (p @ v.float()).to(q.dtype)


def attention_reference_packed(qkv: torch.Tensor, heads: int,
                               scale: float) -> torch.Tensor:
    """attention_reference on the (B, L, 3·D) projection, as (B, L, D)."""
    return merge_heads(attention_reference(*split_heads(qkv, heads), scale))


def attention_forward_plain(q, k, v, scale: float):
    """The forward kernel's arithmetic on (B, H, L, d) heads: S = q·kᵀ
    summed in f32, the softmax of S·scale in f32, P rounded to q's dtype
    for P·v summed in f32, o in q's dtype; and each row's log-sum-exp of
    S·scale in f32, (B, H, L)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, -1)
    o = (p.to(q.dtype).float() @ v.float()).to(q.dtype)
    return o, torch.logsumexp(s, -1)


def attention_backward_plain(q, k, v, lse, dout, scale: float):
    """The backward kernel's arithmetic on (B, H, L, d) heads: P = exp(S·
    scale − lse) and dP = dO·vᵀ in f32, Dᵢ = Σⱼ Pᵢⱼ dPᵢⱼ from those same
    values, dS = P∘(dP − D)·scale rounded to q's dtype; dq = dS·k, dk =
    dSᵀ·q and dv = round(P)ᵀ·dO summed in f32, in q's dtype."""
    dt = q.dtype
    q, k, v, dout = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp((q @ k.transpose(-1, -2)) * scale - lse.unsqueeze(-1))
    dp = dout @ v.transpose(-1, -2)
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True)) * scale).to(dt).float()
    dq = ds @ k
    dk = ds.transpose(-1, -2) @ q
    dv = p.to(dt).float().transpose(-1, -2) @ dout
    return dq.to(dt), dk.to(dt), dv.to(dt)


def kernel_shape_error(qkv: torch.Tensor, heads: int) -> Optional[str]:
    """Why the kernels do not take this (B, L, 3·D) projection, or None:
    bf16, 1 ≤ L ≤ 144, d a multiple of 16 up to 128, the last dimension
    contiguous, image and token strides of whole 16-byte words, the data
    16-byte aligned."""
    b, n, d3 = qkv.shape
    d = d3 // (3 * heads)
    if qkv.dtype != torch.bfloat16:
        return (f"the global-attention kernels take bf16, got {qkv.dtype} "
                f"(train with mixed precision)")
    if not 1 <= n <= MAX_TOKENS:
        return f"{n} tokens: the kernels take 1 to {MAX_TOKENS}"
    if d % 16 or not 16 <= d <= MAX_HEAD_DIM:
        return (f"head dim {d}: the kernels take multiples of 16 up to "
                f"{MAX_HEAD_DIM}")
    if (qkv.stride(2) != 1 or qkv.stride(0) % 8 or qkv.stride(1) % 8
            or qkv.data_ptr() % 16):
        return (f"strides {qkv.stride()}: the kernels read whole 16-byte "
                f"words of contiguous rows")
    return None


def _on_card(qkv: torch.Tensor, heads: int) -> bool:
    """The kernels for a CUDA tensor, the plain version on the CPU; a CUDA
    tensor the kernels do not take raises."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"qkv must be (B, L, 3·D) with D a multiple of "
                         f"{heads} heads, got {tuple(qkv.shape)}")
    if not qkv.is_cuda:
        return False
    err = kernel_shape_error(qkv, heads)
    if err is not None:
        raise ValueError(err)
    return True


def _launch(name: str, kind: str, dev: torch.device, *args) -> None:
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check_launch(lib, getattr(lib, name)(*args, stream), name)
    global_attention.kernel_launches[kind] += 1


def global_attn_forward(qkv: torch.Tensor, heads: int, scale: float):
    """The forward kernel on a bf16 CUDA projection the kernels take
    (kernel_shape_error): o (B, L, D) and each row's log-sum-exp of
    S·scale in f32, (B, H, L)."""
    b, n, d3 = qkv.shape
    out = torch.empty((b, n, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)
    _launch("global_attn_fwd", "fwd", qkv.device, qkv.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, n, heads, d3 // (3 * heads),
            qkv.stride(0), qkv.stride(1), scale)
    return out, lse


def global_attn_backward(qkv, lse, g, heads: int, scale: float):
    """The backward kernel: from the projection, the forward's log-sum-exp
    and o's gradient g (B, L, D), the projection's gradient (B, L, 3·D)."""
    b, n, d3 = qkv.shape
    g = g.to(qkv.dtype).contiguous()
    dqkv = torch.empty((b, n, d3), dtype=qkv.dtype, device=qkv.device)
    _launch("global_attn_bwd", "bwd", qkv.device, qkv.data_ptr(),
            g.data_ptr(), lse.data_ptr(), dqkv.data_ptr(), b, n, heads,
            d3 // (3 * heads), qkv.stride(0), qkv.stride(1), scale)
    return dqkv


class _GlobalAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, qkv, heads: int, scale: float):
        with span(spans.ENCODER_ATTENTION):
            global_attention.launches["fwd"] += 1
            ctx.heads, ctx.scale = heads, scale
            ctx.card = _on_card(qkv, heads)
            if not ctx.card:
                ctx.save_for_backward(qkv)
                return attention_reference_packed(qkv, heads, scale)
            out, lse = global_attn_forward(qkv, heads, scale)
            ctx.save_for_backward(qkv, lse)
            return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with span(spans.ENCODER_ATTENTION):
            global_attention.launches["bwd"] += 1
            if ctx.card:
                qkv, lse = ctx.saved_tensors
                return (global_attn_backward(qkv, lse, g, ctx.heads,
                                             ctx.scale), None, None)
            with torch.enable_grad():
                qkv = ctx.saved_tensors[0].detach().requires_grad_(True)
                out = attention_reference_packed(qkv, ctx.heads, ctx.scale)
                (dqkv,) = torch.autograd.grad(out, qkv, g)
            return dqkv, None, None


def global_attention(qkv: torch.Tensor, heads: int,
                     scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v of each of ``heads`` heads, q, k and v read
    from the (B, L, 3·D) projection laid out (B, L, 3, H, d); returns
    (B, L, D) in qkv's dtype, the heads in (H, d) order."""
    return _GlobalAttention.apply(qkv, int(heads), float(scale))


global_attention.launches = collections.Counter()
global_attention.kernel_launches = collections.Counter()
