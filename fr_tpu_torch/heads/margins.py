"""Margin-softmax logit transforms (counterpart of fr_tpu/heads/margins.py).

All functions take
    logits : (B, C) cosine logits in [-1, 1], float32
    labels : (B,)   int target column per row, or -1 for "no target here"
and return the transformed, scale-multiplied logits. Rows whose label is -1
are only scaled, so they contribute to the softmax denominator alone.
"""

from __future__ import annotations

import math
from functools import partial

import torch


def _one_hot_valid(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, C) bool one-hot; a label of -1 gives an all-False row."""
    cols = torch.arange(num_classes, device=labels.device)
    return cols[None, :] == labels[:, None]


def arcface(logits: torch.Tensor, labels: torch.Tensor, s: float = 64.0,
            m: float = 0.5, easy_margin: bool = False) -> torch.Tensor:
    """Additive angular margin: target cosθ → cos(θ+m); where cosθ ≤
    cos(π−m), cosθ − sin(π−m)·m keeps the transform monotone."""
    cos_m, sin_m = math.cos(m), math.sin(m)
    theta = math.cos(math.pi - m)
    sinmm = math.sin(math.pi - m) * m
    onehot = _one_hot_valid(labels, logits.shape[-1])
    # At |cosθ| = 1, reachable after the ±1 clamp, sqrt'(0) is infinite; the
    # inner where keeps that NaN out of the backward (same value).
    sq = 1.0 - logits * logits
    sin_theta = torch.where(
        sq > 0, torch.sqrt(torch.where(sq > 0, sq, torch.ones_like(sq))),
        torch.zeros_like(sq))
    cos_theta_m = logits * cos_m - sin_theta * sin_m
    if easy_margin:
        margined = torch.where(logits > 0, cos_theta_m, logits)
    else:
        margined = torch.where(logits > theta, cos_theta_m, logits - sinmm)
    return torch.where(onehot, margined, logits) * s


def cosface(logits: torch.Tensor, labels: torch.Tensor, s: float = 64.0,
            m: float = 0.4) -> torch.Tensor:
    """Additive cosine margin: target cosθ → cosθ − m."""
    onehot = _one_hot_valid(labels, logits.shape[-1])
    return (logits - onehot.to(logits.dtype) * m) * s


def combined_margin(logits: torch.Tensor, labels: torch.Tensor, s: float,
                    m1: float, m2: float, m3: float,
                    interclass_filtering_threshold: float = 0.0
                    ) -> torch.Tensor:
    """InsightFace's combined margin s·[cos(m1·θ + m2) − m3] in its two
    supported forms: (m1 = 1, m3 = 0) is ArcFace with m = m2, m3 > 0 is
    CosFace with m = m3. A threshold > 0 first zeroes every logit above it
    but a row's target column (all of them on a row labelled -1)."""
    if interclass_filtering_threshold > 0:
        dirty = (logits > interclass_filtering_threshold) & ~_one_hot_valid(
            labels, logits.shape[-1])
        logits = (1.0 - dirty.to(logits.dtype)) * logits
    if m1 == 1.0 and m3 == 0.0:
        return arcface(logits, labels, s=s, m=m2)
    if m3 > 0:
        return cosface(logits, labels, s=s, m=m3)
    raise ValueError(
        f"Unsupported combined margin (m1={m1}, m2={m2}, m3={m3})")


def get_margin_fn(name: str, s: float, m: float, easy_margin: bool = False):
    """Margin by conf.metric; CosFace has no easy_margin."""
    if name == "ArcFace":
        return partial(arcface, s=s, m=m, easy_margin=easy_margin)
    if name == "CosFace":
        return partial(cosface, s=s, m=m)
    raise ValueError(f"Unknown margin {name!r}")
