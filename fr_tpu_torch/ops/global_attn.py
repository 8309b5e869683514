"""Global multi-head attention, every token against every token of its
image: softmax(q·kᵀ·scale)·v over (B, H, L, d) heads, with its backward, as
an autograd Function.

The ViT encoder (models/vit.py) calls it once a block. On a bf16 CUDA
tensor the forward is PyTorch's flash scaled-dot-product attention (public
``scaled_dot_product_attention`` held to the flash backend), which keeps no
L × L matrix; a CUDA tensor of another dtype, or one the flash kernels do
not take, raises. The backward is autograd's through
``tensor_core_attention``, recomputed from the saved q, k and v: the two
products and the three of the backward on the tensor cores in bf16, the
softmax and its backward in f32, so that each row of the scores' gradient
sums to nought with the probabilities and the output's gradient it was
made from.

Flash's own backward does not: it takes each row's Σⱼ Pᵢⱼ dPᵢⱼ as
dOᵢ·Oᵢ from the bf16-rounded output. Where a row's probabilities are near
uniform and its tokens near their mean, as in ViT-L's deeper blocks at the
benchmark's weights, the true dq and dk are second-order small and that
rounding is not. On an H100 at 384 images × 8 heads × 136 tokens × 96,
tokens spread 0.03 about a shared mean, flash's dq is off by 21 times its
norm and this backward's by 0.08; in ViT-L's first training step the q
and k rows of each qkv weight's gradient from block 2 on were off by 2–7
times their norm under flash, signs agreeing on 0.56–0.73 of the entries,
against 0.07–0.09 and 0.975 for f32 attention. AdamW moves each entry by
about lr whatever its gradient's size, so those rows went wherever
flash's error pointed. This backward takes about 2.1 ms a layer on the
H100 at that shape, flash's 1.2.

A CPU tensor takes the plain version both ways: ``attention_reference``,
the same arithmetic in f32 (q·kᵀ, the softmax and ·v), cast back to the
inputs' dtype, its backward autograd's through it.

Both walks run inside the span ``encoder:attention`` (utils/profiling.py):
the forward inside the step's ``encoder:forward``, the backward, which the
autograd engine calls, inside ``encoder:backward``. So a profile places the
attention's kernels in the span whichever thread launched them, and a
later hand-written kernel replaces what runs inside it.
``global_attention.launches`` counts the calls by entry (``fwd``, ``bwd``)
on either route.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable
from torch.nn.attention import SDPBackend, sdpa_kernel

from fr_tpu_torch.utils import profiling as spans
from fr_tpu_torch.utils.profiling import span


def attention_reference(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v in f32, in q's dtype."""
    p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * scale, -1)
    return (p @ v.float()).to(q.dtype)


def tensor_core_attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v with both products in q's dtype (f32
    accumulation) and the softmax in f32; autograd's backward through it
    is the card's."""
    p = torch.softmax((q @ k.transpose(-1, -2)).float() * scale, -1)
    return p.to(q.dtype) @ v


def _flash(q: torch.Tensor) -> bool:
    """The flash route for a CUDA tensor, the plain one on the CPU; a CUDA
    tensor the flash kernels do not take raises rather than fall to the
    plain route's L × L probabilities."""
    if not q.is_cuda:
        return False
    if q.dtype != torch.bfloat16:
        raise ValueError(f"global attention on the card runs the bf16 "
                         f"flash kernels; got {q.dtype} (train with "
                         f"mixed precision)")
    return True


class _GlobalAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        with span(spans.ENCODER_ATTENTION):
            global_attention.launches["fwd"] += 1
            ctx.scale = scale
            ctx.flash = _flash(q)
            ctx.save_for_backward(q, k, v)
            if not ctx.flash:
                return attention_reference(q, k, v, scale)
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                return F.scaled_dot_product_attention(q, k, v, scale=scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with span(spans.ENCODER_ATTENTION):
            global_attention.launches["bwd"] += 1
            plain = tensor_core_attention if ctx.flash \
                else attention_reference
            with torch.enable_grad():
                qkv = [t.detach().requires_grad_(True)
                       for t in ctx.saved_tensors]
                dq, dk, dv = torch.autograd.grad(plain(*qkv, ctx.scale),
                                                 qkv, g)
            return dq, dk, dv, None


def global_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v of (B, H, L, d) heads, in q's dtype; q, k and
    v may be strided views (of one qkv projection) with unit stride in d.
    The output is (B, H, L, d); on the flash route its memory is
    (B, L, H, d), so ``transpose(1, 2)`` of it is contiguous."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"q, k and v must be one (B, H, L, d) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return _GlobalAttention.apply(q, k, v, float(scale))


global_attention.launches = collections.Counter()
