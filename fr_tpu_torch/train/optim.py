"""Optimizers with fr_tpu's exact torch semantics (counterpart of
fr_tpu/train/optim.py).

- SGD: g ← g + wd·p; buf ← mom·buf + g; p ← p − lr·buf (zero-initialised
  buffers make the first step torch's buf ← g bootstrap).
- AdamW: p ← p·(1 − lr·wd); m ← β1·m + (1−β1)·g; v ← β2·v + (1−β2)·g²;
  p ← p − lr/(1−β1ᵗ)·m/(√v/√(1−β2ᵗ) + eps).
- global-norm clip: total = √Σ‖g‖² in f32, g·min(max_norm/(total+1e-6), 1),
  applied to the encoder's gradients only.

The order is weight decay, then momentum, then the step, exactly as
written. Unlike fr_tpu's functional updates, these update the tensors in
place (parameters, slots and the head's sampled rows), which keeps one copy
of the head and its slots in device memory. The encoder's updates and the
clip run as multi-tensor (``torch._foreach_*``) operations: a handful of
launches for all ~300 tensors instead of several per tensor.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from fr_tpu_torch.ops.sparse_rows import (bias_corrections, grouped_update,
                                          row_adamw_update, row_sgd_update)

Slots = Dict[str, List[torch.Tensor]]


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(clipped grads, the f32 global norm before clipping)."""
    flat = torch.cat([g.float().reshape(-1) for g in grads])
    total = torch.sqrt(torch.sum(flat * flat))
    coef = torch.clamp_max(max_norm / (total + 1e-6), 1.0)
    return list(torch._foreach_mul(list(grads), coef)), total


def init_slots(optimizer: str, params: Sequence[torch.Tensor]) -> Slots:
    zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
    if optimizer == "SGD":
        return {"momentum": zeros()}
    if optimizer == "AdamW":
        return {"exp_avg": zeros(), "exp_avg_sq": zeros()}
    raise ValueError(optimizer)


@torch.no_grad()
def sgd_update(params: List[torch.Tensor], grads: List[torch.Tensor],
               slots: Slots, lr: float, wd: float, mom: float) -> None:
    """Per tensor: b ← mom·b + (g + wd·p); p ← p − lr·b."""
    bufs = slots["momentum"]
    torch._foreach_mul_(bufs, mom)
    torch._foreach_add_(bufs, torch._foreach_add(grads, params, alpha=wd))
    torch._foreach_add_(params, bufs, alpha=-lr)


@torch.no_grad()
def adamw_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                 slots: Slots, lr: float, wd: float, b1: float, b2: float,
                 eps: float, count: int) -> None:
    """Per tensor: p ← p·(1 − lr·wd); m ← β1·m + (1−β1)·g;
    v ← β2·v + (1−β2)·g²; p ← p − lr/bc1 · m/(√v/√bc2 + eps)."""
    bc1, bc2 = bias_corrections(b1, b2, count)
    m, v = slots["exp_avg"], slots["exp_avg_sq"]
    torch._foreach_mul_(params, 1.0 - lr * wd)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, grads, alpha=1.0 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, torch._foreach_mul(grads, grads), alpha=1.0 - b2)
    denom = torch._foreach_sqrt(v)
    torch._foreach_div_(denom, bc2 ** 0.5)
    torch._foreach_add_(denom, eps)
    torch._foreach_add_(params, torch._foreach_div(m, denom),
                        alpha=-(lr / bc1))


def encoder_update(optimizer: str, conf, params, grads, slots: Slots, lr,
                   count: int) -> None:
    """Dispatch by conf.optimizer."""
    if optimizer == "SGD":
        return sgd_update(params, grads, slots, lr, conf.wd, conf.mom)
    if optimizer == "AdamW":
        b1, b2 = conf.betas
        return adamw_update(params, grads, slots, lr, conf.wd, b1, b2,
                            conf.eps, count)
    raise ValueError(optimizer)


def pfc_row_update(optimizer: str, conf, weight, slots, idx, grad_rows, lr,
                   count: int, gidx: Optional[torch.Tensor] = None,
                   block: int = 1) -> None:
    """The head's sampled-row update. With the drawn group ids ``gidx`` of
    block-aligned sampling (block > 1) it is the grouped in-place update of
    ops/sparse_rows.py; else the per-row one, which lives there too."""
    if gidx is not None and block > 1:
        return grouped_update(optimizer, conf, weight, slots, gidx,
                              grad_rows, lr, count, block)
    if optimizer == "SGD":
        return row_sgd_update(weight, slots, idx, grad_rows, lr, conf.wd,
                              conf.mom)
    if optimizer == "AdamW":
        b1, b2 = conf.betas
        return row_adamw_update(weight, slots, idx, grad_rows, lr, conf.wd,
                                b1, b2, conf.eps, count)
    raise ValueError(optimizer)
