"""AlterNet-SwinV2-FAN hybrid backbones (counterpart of
fr_tpu/models/alternet.py).

AlterNet: IR BasicBlocks interleaved with SwinV2 W-MSA/SW-MSA pairs:
stride-2 stem (hence 192 px input), windows 6,6,6,3 per stage, BatchNorm as
the Swin norm, head BN → ReLU → Dropout → AdaptiveAvgPool(6,6) →
Dense(emd·36 → emd) → BN1d. Module names follow the reference
(layer{s}.{k}.attn.qkv, .attn.cpb_mlp.0, .norm2, .attn_mask, fc, bn3, ...),
which fr_tpu/utils/torch_export.py:140-205 also writes.

AlterNetSep, the reference's "Seperate" ablation (fr_tpu alternet.py:184-259):
stride-1 stem (112 px), single unshifted window-7 Swin blocks placed by
``alt_sequence_sep`` with drop_path 0, head BN → Dropout(0.5) → GAP 7×7 →
Dense(emd·49 → emd) → BN1d, no ReLU. fr_tpu's torch export has no naming for
it; its modules are named as AlterNet's.

A Swin block whose (window, dim) is in swin_common.SPATIAL_KERNEL_CONFIGS
hands its map whole to the attention (fr_tpu alternet.py:70-74).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fr_tpu_torch.models.common import (BatchNorm1d, BatchNorm2d, Conv, Dense,
                                        dropout, max_pool_3x3_s2)
from fr_tpu_torch.models.resnet import BasicBlock
from fr_tpu_torch.models.swin_common import (DropPath, WindowAttention,
                                             adaptive_avg_pool,
                                             shifted_window_mask,
                                             use_spatial_attention,
                                             window_partition, window_reverse)


class AlterSwinBlock(nn.Module):
    """SwinV2 block, AlterNet variant: x + DropPath(BN(attn(x))).

    fr_tpu's pre-activated conv shortcut for dim ≠ dim_out is not built:
    no stage plan changes width inside a Swin block."""

    def __init__(self, dim: int, heads: int,
                 input_resolution: Optional[Tuple[int, int]], window: int = 7,
                 shift: int = 0, drop_path: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.window = window
        self.shift = shift
        self.attn = WindowAttention(dim, (window, window), heads,
                                    compute_dtype)
        self.norm2 = BatchNorm2d(dim)
        self.drop_path = DropPath(drop_path)
        mask = None
        if shift > 0:
            mask = torch.from_numpy(shifted_window_mask(
                input_resolution[0], input_resolution[1], window, shift))
        self.register_buffer("attn_mask", mask)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """x: NCHW (channels_last memory) → same; ``generator`` feeds
        DropPath in training."""
        H, W = x.shape[2], x.shape[3]
        s, ws = self.shift, self.window
        xh = x.permute(0, 2, 3, 1)
        if s > 0:
            xh = torch.roll(xh, (-s, -s), dims=(1, 2))
        if use_spatial_attention(ws, self.dim):
            xh = self.attn(xh, self.attn_mask)
        else:
            attn = self.attn(window_partition(xh, ws), self.attn_mask)
            xh = window_reverse(attn, ws, H, W)
        if s > 0:
            xh = torch.roll(xh, (s, s), dims=(1, 2))
        out = self.norm2(xh.permute(0, 3, 1, 2))
        return x + self.drop_path(out, generator)


def alt_sequence(blocks: int, blocks2: int) -> Sequence[bool]:
    """Transformer-slot placement after the first (strided) block:
    num_blocks slots, transformer pairs at every other slot from the end."""
    num_blocks = 2 * (blocks // 3) + (blocks % 3) - 1
    assert 2 * blocks2 + blocks2 <= blocks, \
        "The number of transformers must not exceed cnn !!!"
    seq = [False] * num_blocks
    for i in range(blocks2):
        seq[-2 * i - 1] = True
    return seq


class AlterNet(nn.Module):
    """Forward takes NHWC images; any stage plan, like the flax module.

    In training, head dropout and every block's DropPath draw from the
    ``generator`` passed to forward (fr_tpu's "dropout" RNG stream); a
    non-zero rate without one raises."""

    def __init__(self, num_blocks: Sequence[int], num_blocks2: Sequence[int],
                 heads: Sequence[int], img_size: int = 192,
                 emd_size: int = 512, drop_path_rate: float = 0.1,
                 head_drop: float = 0.5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = Conv(3, 64, 3, 2, compute_dtype)
        self.bn1 = BatchNorm2d(64)
        res = img_size // 4
        windows = (6, 6, 6, 3)
        inplanes = 64
        for si, (planes, blocks, blocks2, h, win, stride) in enumerate(
                zip((64, 128, 256, emd_size), num_blocks, num_blocks2, heads,
                    windows, (1, 2, 2, 2)), start=1):
            if si > 1:
                res //= 2
            mods = [BasicBlock(inplanes, planes, stride, compute_dtype)]
            for is_alt in alt_sequence(blocks, blocks2):
                if not is_alt:
                    mods.append(BasicBlock(planes, planes, 1, compute_dtype))
                else:
                    for shift in (0, win // 2):
                        mods.append(AlterSwinBlock(
                            planes, h, (res, res), window=win, shift=shift,
                            drop_path=drop_path_rate,
                            compute_dtype=compute_dtype))
            setattr(self, f"layer{si}", nn.Sequential(*mods))
            inplanes = planes
        self.bn2 = BatchNorm2d(emd_size)
        self.head_drop = head_drop
        self.fc = Dense(emd_size * 36, emd_size)
        self.bn3 = BatchNorm1d(emd_size)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        for si in range(1, 5):
            for block in getattr(self, f"layer{si}"):
                x = (block(x, generator) if isinstance(block, AlterSwinBlock)
                     else block(x))
        x = F.relu(self.bn2(x))
        if self.training:
            x = dropout(x, self.head_drop, generator)
        x = x.float()
        x = adaptive_avg_pool(x.permute(0, 2, 3, 1), 6, 6)
        # NCHW flatten order, as fr_tpu transposes before its Dense
        x = x.permute(0, 3, 1, 2).flatten(1)
        return self.bn3(self.fc(x))


ALTERNET_PLANS = {
    # name: (num_blocks, num_blocks2, heads)
    "AlterNet18": ((2, 2, 2, 2), (0, 1, 1, 1), (2, 4, 8, 16)),
    "AlterNet34": ((3, 4, 6, 3), (0, 1, 3, 2), (2, 4, 8, 16)),
    "AlterNet50": ((3, 4, 14, 4), (0, 1, 4, 1), (2, 4, 8, 16)),
    "AlterNet100": ((3, 13, 30, 4), (0, 1, 1, 2), (2, 4, 8, 16)),
    "AlterNet200": ((3, 43, 50, 3), (0, 1, 3, 2), (2, 4, 8, 16)),
}


def build_alternet(conf) -> AlterNet:
    blocks, blocks2, heads = ALTERNET_PLANS[conf.network]
    dtype = torch.bfloat16 if conf.get("mixed_precision", False) \
        else torch.float32
    return AlterNet(blocks, blocks2, heads, img_size=conf.img_size,
                    emd_size=conf.emd_size, compute_dtype=dtype)


def alt_sequence_sep(blocks: int, blocks2: int) -> Sequence[bool]:
    """The Seperate variant's placement: blocks − 1 slots after the strided
    block, single transformer blocks at every other slot from the end."""
    return [False] * (blocks - blocks2 * 2 - 1) + [False, True] * blocks2


class AlterNetSep(nn.Module):
    """Forward takes NHWC images (112 px). In training the head's dropout
    draws from the ``generator`` passed to forward."""

    def __init__(self, num_blocks: Sequence[int], num_blocks2: Sequence[int],
                 heads: Sequence[int], emd_size: int = 512,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = Conv(3, 64, 3, 1, compute_dtype)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for si, (planes, blocks, blocks2, h, stride) in enumerate(
                zip((64, 128, 256, emd_size), num_blocks, num_blocks2, heads,
                    (1, 2, 2, 2)), start=1):
            mods = [BasicBlock(inplanes, planes, stride, compute_dtype)]
            for is_alt in alt_sequence_sep(blocks, blocks2):
                mods.append(
                    AlterSwinBlock(planes, h, None, window=7, shift=0,
                                   drop_path=0.0, compute_dtype=compute_dtype)
                    if is_alt else
                    BasicBlock(planes, planes, 1, compute_dtype))
            setattr(self, f"layer{si}", nn.Sequential(*mods))
            inplanes = planes
        self.bn2 = BatchNorm2d(emd_size)
        self.fc = Dense(emd_size * 49, emd_size)
        self.bn3 = BatchNorm1d(emd_size)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        for si in range(1, 5):
            for block in getattr(self, f"layer{si}"):
                x = block(x)
        x = self.bn2(x)
        if self.training:
            x = dropout(x, 0.5, generator)
        x = adaptive_avg_pool(x.float().permute(0, 2, 3, 1), 7, 7)
        # NCHW flatten order, as fr_tpu transposes before its Dense
        return self.bn3(self.fc(x.permute(0, 3, 1, 2).flatten(1)))


ALTERNET_SEP_PLANS = {
    # name: (num_blocks, num_blocks2, heads); the 50 plan is not AlterNet50's
    "AlterNetSep18": ((2, 2, 2, 2), (0, 1, 1, 1), (2, 4, 8, 16)),
    "AlterNetSep34": ((3, 4, 6, 3), (0, 1, 3, 2), (2, 4, 8, 16)),
    "AlterNetSep50": ((3, 4, 14, 3), (0, 1, 7, 2), (2, 4, 8, 16)),
    "AlterNetSep100": ((3, 13, 30, 4), (0, 1, 1, 2), (2, 4, 8, 16)),
    "AlterNetSep200": ((3, 43, 50, 3), (0, 1, 3, 2), (2, 4, 8, 16)),
}


def build_alternet_sep(conf) -> AlterNetSep:
    blocks, blocks2, heads = ALTERNET_SEP_PLANS[conf.network]
    dtype = torch.bfloat16 if conf.get("mixed_precision", False) \
        else torch.float32
    return AlterNetSep(blocks, blocks2, heads, emd_size=conf.emd_size,
                       compute_dtype=dtype)
