"""Model summary: parameter table and totals (counterpart of
fr_tpu/utils/summary.py, the same layout).

One row per top-level child of the encoder that holds parameters (and per
parameter held by the encoder itself), sorted by name as fr_tpu sorts its
top-level parameter keys; then the encoder total, the BatchNorm running
statistics (running mean and variance, as fr_tpu's ``batch_stats``; not
``num_batches_tracked``) and the PartialFC head at 4 bytes an element.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch
from torch import nn

_BN_STATS = ("running_mean", "running_var")


def _count(tensors: Iterable[torch.Tensor]) -> Tuple[int, int]:
    """(elements, bytes) of the tensors."""
    n = b = 0
    for t in tensors:
        n += t.numel()
        b += t.numel() * t.element_size()
    return n, b


def _row(name: str, n: int, nbytes: int) -> str:
    return f"{name:<40}{n:>12,}{nbytes / 2**20:>10.2f}"


def model_summary(encoder: nn.Module, head_params: int = 0) -> str:
    tops = {name: list(child.parameters())
            for name, child in encoder.named_children()}
    tops.update({name: [p] for name, p
                 in encoder.named_parameters(recurse=False)})
    lines = ["-" * 64, f"{'module':<40}{'params':>12}{'MB':>10}", "-" * 64]
    lines += [_row(name, *_count(tops[name])) for name in sorted(tops)
              if tops[name]]
    lines.append("-" * 64)
    lines.append(_row("encoder total", *_count(encoder.parameters())))
    stats = [b for name, b in encoder.named_buffers()
             if name.rsplit(".", 1)[-1] in _BN_STATS]
    if stats:
        lines.append(_row("BN running stats", *_count(stats)))
    if head_params:
        lines.append(_row("PartialFC head (sharded)", head_params,
                          head_params * 4))
    lines.append("-" * 64)
    return "\n".join(lines)
