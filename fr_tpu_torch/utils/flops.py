"""FLOP count of one encoder forward (counterpart of fr_tpu's
``count_flops``, fr_tpu/utils/flops.py:16-76, as its bench uses it).

The products and convolutions of one eval-mode forward, counted by
``torch.utils.flop_counter.FlopCounterMode`` on a copy of the encoder on the
CPU. On the CPU the window attention runs its plain version (its matmuls
count), so the count is the same whatever implements the attention on the
card, as fr_tpu counts with ``fused_attn: False``; the hand-written kernels,
launched through ctypes, would be invisible to the counter.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def encoder_forward_flops(conf, batch: int = 1) -> float:
    """Dot and convolution FLOPs of one eval-mode forward of conf's encoder
    at ``batch`` images of conf.img_size (multiply-add = 2)."""
    from fr_tpu_torch.models import build_encoder
    encoder = build_encoder(conf).eval()
    x = torch.zeros(batch, conf.img_size, conf.img_size, 3)
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        encoder(x)
    return float(counter.get_total_flops())
