"""SwinV2 backbone (counterpart of fr_tpu/models/swinv2.py).

Conv stem (3×3 s1 → BN → ReLU → max-pool 3×3 s2, hence 112 px input),
stages of unshifted window-7 SwinV2 blocks downsampled between stages by a
k2/s2 conv, each block W-MSA + BN residual then a 1×1-conv GELU MLP (ratio
4) + BN residual; head BN → Dropout(0.5) → adaptive pool 7×7 →
Dense(emd·49 → emd) → BN1d. Module names follow the reference
(layer{s}.{k} with the downsampling conv at k = 0, .attn, .mlp.fc1,
.mlp.fc2, .norm2, .norm3, bn2, fc, bn3), which
fr_tpu/utils/torch_export.py:208-253 also writes. A block whose (window,
dim) is in swin_common.SPATIAL_KERNEL_CONFIGS hands its map whole to the
attention (fr_tpu swinv2.py:45).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from fr_tpu_torch.models.common import (BatchNorm1d, BatchNorm2d, Conv, Dense,
                                        dropout, max_pool_3x3_s2)
from fr_tpu_torch.models.swin_common import (DropPath, WindowAttention,
                                             adaptive_avg_pool,
                                             use_spatial_attention,
                                             window_partition, window_reverse)

WINDOW = 7


class SwinMlp(nn.Module):
    """1×1-conv MLP with bias, flax's tanh-approximated GELU between."""

    def __init__(self, dim: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Conv(dim, 4 * dim, 1, 1, compute_dtype, bias=True)
        self.fc2 = Conv(4 * dim, dim, 1, 1, compute_dtype, bias=True)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SwinBlock(nn.Module):
    """W-MSA + BN residual, then conv-MLP + BN residual (fr_tpu's SwinBlock;
    its drop_path default 0 is what Swin builds)."""

    def __init__(self, dim: int, heads: int, drop_path: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.attn = WindowAttention(dim, (WINDOW, WINDOW), heads,
                                    compute_dtype)
        self.norm2 = BatchNorm2d(dim)
        self.mlp = SwinMlp(dim, compute_dtype)
        self.norm3 = BatchNorm2d(dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """x: NCHW (channels_last memory) → same."""
        H, W = x.shape[2], x.shape[3]
        xh = x.permute(0, 2, 3, 1)
        if use_spatial_attention(WINDOW, self.dim):
            out = self.attn(xh).permute(0, 3, 1, 2)
        else:
            attn = self.attn(window_partition(xh, WINDOW))
            out = window_reverse(attn, WINDOW, H, W).permute(0, 3, 1, 2)
        x = x + self.drop_path(self.norm2(out), generator)
        return x + self.drop_path(self.norm3(self.mlp(x)), generator)


class Swin(nn.Module):
    """Forward takes NHWC images. In training the head's dropout draws from
    the ``generator`` passed to forward (fr_tpu's "dropout" RNG stream)."""

    def __init__(self, num_blocks: Sequence[int], heads: Sequence[int],
                 emd_size: int = 512, head_drop: float = 0.5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = Conv(3, 64, 3, 1, compute_dtype)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for si, (planes, blocks, h, stride) in enumerate(
                zip((64, 128, 256, emd_size), num_blocks, heads,
                    (1, 2, 2, 2)), start=1):
            mods = []
            if stride > 1:
                mods.append(Conv(inplanes, planes, 2, 2, compute_dtype))
            mods += [SwinBlock(planes, h, compute_dtype=compute_dtype)
                     for _ in range(blocks)]
            setattr(self, f"layer{si}", nn.Sequential(*mods))
            inplanes = planes
        self.bn2 = BatchNorm2d(emd_size)
        self.head_drop = head_drop
        self.fc = Dense(emd_size * 49, emd_size)
        self.bn3 = BatchNorm1d(emd_size)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        for si in range(1, 5):
            for block in getattr(self, f"layer{si}"):
                x = (block(x, generator) if isinstance(block, SwinBlock)
                     else block(x))
        x = self.bn2(x)
        if self.training:
            x = dropout(x, self.head_drop, generator)
        x = adaptive_avg_pool(x.float().permute(0, 2, 3, 1), 7, 7)
        # NCHW flatten order, as fr_tpu transposes before its Dense
        x = x.permute(0, 3, 1, 2).flatten(1)
        return self.bn3(self.fc(x))


SWIN_PLANS = {
    # name: (num_blocks, heads)
    "Swin18": ((0, 1, 1, 1), (2, 4, 8, 16)),
    "Swin34": ((0, 0, 4, 6), (2, 4, 8, 16)),
    "Swin50": ((0, 0, 4, 10), (2, 4, 8, 16)),
    "Swin100": ((0, 0, 6, 14), (2, 4, 8, 16)),
    "Swin200": ((0, 0, 10, 40), (2, 4, 8, 16)),
}


def build_swin(conf) -> Swin:
    blocks, heads = SWIN_PLANS[conf.network]
    dtype = torch.bfloat16 if conf.get("mixed_precision", False) \
        else torch.float32
    return Swin(blocks, heads, emd_size=conf.emd_size, compute_dtype=dtype)
