"""EffiAlterNet: EfficientNetV2 trunk × SwinV2+FAN transformer blocks
(counterpart of fr_tpu/models/effialternet.py).

- MBConv with SE (1×1 expand → depthwise 3×3 → SE → 1×1 project) or fused
  (3×3 expand → 1×1 project), SiLU, BatchNorm, identity residual iff
  stride 1 and equal widths;
- stage tuples [t, c, n, s, SE, n_transformer, heads], channels rounded by
  ``_make_divisible``;
- FANSwinBlock: x += DropPath(BN(window attention(x))), then
  x += DropPath(BN(ChannelProcessing(x))), the FAN channel attention;
- fr_tpu's resolution bookkeeping, kept as it is because it fixes the
  architecture: it starts at img_size and halves after every stage whatever
  the stride, sets each stage's block count (res > 7: the alt_seq formula,
  else n − 1) and adds the shifted partner block only while res > 7;
- head: adaptive pool 7×7 → Dense(c·49 → emd) → BN1d;
- init: fr_tpu's truncated normal (σ 0.02) for the convs, SE, the CP
  projection and the head; the window attention keeps Xavier.

Module names follow the reference (features.{k}.conv.{i}, .conv.6.fc.{0,2},
.attn, .chnnel_processing.qv / .temperature, .norm2, .norm3, .attn_mask,
fc, bn), which fr_tpu/utils/torch_export.py:256-344 also writes.

conf.dw_taps swaps each SE MBConv's depthwise 3×3 conv for fr_tpu's
``DepthwiseTaps`` (effialternet.py:89-127): the same function as 9 shifted
multiply-adds in the compute dtype, under the same parameter name
(conv.3.weight), so weights cross unchanged. It is a measured negative on
the TPU and off by default there and here. A FANSwinBlock whose (window,
dim) is in swin_common.SPATIAL_KERNEL_CONFIGS hands its map whole to the
attention (fr_tpu effialternet.py:260).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from fr_tpu_torch.models.common import BatchNorm1d, BatchNorm2d, Conv
from fr_tpu_torch.models.swin_common import (DropPath, WindowAttention,
                                             adaptive_avg_pool,
                                             shifted_window_mask,
                                             use_spatial_attention,
                                             window_partition, window_reverse)

INIT_STD = 0.02
WINDOW = 7


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class EConv(Conv):
    """Bias-free conv with the family's truncated-normal init."""
    init_std = INIT_STD


class DepthwiseTaps(EConv):
    """fr_tpu's DepthwiseTaps: the depthwise 3×3 conv (padding 1, any
    stride) as 9 shifted multiply-adds, each product and each sum in the
    compute dtype, in fr_tpu's tap order. Its weight is the EConv's it
    replaces, (C, 1, 3, 3)."""

    def __init__(self, channels: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(channels, channels, 3, stride, compute_dtype,
                         groups=channels)

    def forward(self, x):
        cd = self.compute_dtype
        s = self.stride[0]
        H, W = x.shape[2:]
        oh, ow = (H - 1) // s + 1, (W - 1) // s + 1
        xp = F.pad(x.to(cd), (1, 1, 1, 1))
        k = self.weight.to(cd)
        acc = None
        for a in range(3):
            for b in range(3):
                term = (xp[:, :, a:a + (oh - 1) * s + 1:s,
                           b:b + (ow - 1) * s + 1:s]
                        * k[:, 0, a, b][None, :, None, None])
                acc = term if acc is None else acc + term
        return acc


class _TruncLinear(nn.Linear):
    """f32 dense layer with the family's truncated-normal init."""
    init_std = INIT_STD


class SELayer(nn.Module):
    """Squeeze-excitation in f32: mean over H, W → fc.0 (→ mid) → SiLU →
    fc.2 (→ channels) → sigmoid, multiplied onto x in x's dtype."""

    def __init__(self, inp: int, oup: int):
        super().__init__()
        mid = _make_divisible(inp // 4, 8)
        self.fc = nn.Sequential(_TruncLinear(oup, mid), nn.SiLU(),
                                _TruncLinear(mid, oup), nn.Sigmoid())

    def forward(self, x):
        y = self.fc(x.float().mean(dim=(2, 3)))
        return x * y[:, :, None, None].to(x.dtype)


class MBConv(nn.Module):
    """fr_tpu's MBConv; ``conv`` holds the layers at the reference's
    indices (the SiLUs at 2 and 5 hold no weights)."""

    def __init__(self, inp: int, oup: int, stride: int, expand_ratio: int,
                 use_se: bool, compute_dtype: torch.dtype = torch.float32,
                 dw_taps: bool = False):
        super().__init__()
        hidden = round(inp * expand_ratio)
        self.identity = stride == 1 and inp == oup
        cd = compute_dtype
        if use_se:
            self.conv = nn.Sequential(
                EConv(inp, hidden, 1, 1, cd), BatchNorm2d(hidden), nn.SiLU(),
                DepthwiseTaps(hidden, stride, cd) if dw_taps else
                EConv(hidden, hidden, 3, stride, cd, groups=hidden),
                BatchNorm2d(hidden), nn.SiLU(), SELayer(inp, hidden),
                EConv(hidden, oup, 1, 1, cd), BatchNorm2d(oup))
        else:
            self.conv = nn.Sequential(
                EConv(inp, hidden, 3, stride, cd), BatchNorm2d(hidden),
                nn.SiLU(), EConv(hidden, oup, 1, 1, cd), BatchNorm2d(oup))

    def forward(self, x):
        return x + self.conv(x) if self.identity else self.conv(x)


class ChannelProcessing(nn.Module):
    """FAN channel attention on NHWC x: qv = Dense(x) interleaved as
    (C, 2); q softmaxed over tokens, k = x softmaxed over tokens then
    averaged over each head's channels; attn = sigmoid(qᵀk)·temperature
    scales vᵀ. Everything after the projection is f32; the qᵀk product is
    an exact f32 sum (fr_tpu takes it at Precision.HIGHEST), not a matmul,
    so TF32 never enters."""

    def __init__(self, dim: int, num_heads: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.qv = _TruncLinear(dim, 2 * dim)
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))

    def forward(self, x):
        B, H, W, C = x.shape
        N, h = H * W, self.num_heads
        cd = self.compute_dtype
        t = x.reshape(B, N, C)
        qv = (F.linear(t.to(cd), self.qv.weight.to(cd)) + self.qv.bias.to(cd)
              ).reshape(B, N, C, 2)
        q = qv[..., 0].reshape(B, N, h, C // h).permute(0, 2, 1, 3)
        v = qv[..., 1].reshape(B, N, h, C // h).permute(0, 2, 1, 3)
        k = t.reshape(B, N, h, C // h).permute(0, 2, 1, 3)
        qs = torch.softmax(q.float(), dim=-2)                  # (B, h, N, hd)
        ks = torch.softmax(k.float(), dim=-2).mean(dim=-1)     # (B, h, N)
        attn = torch.sigmoid(torch.sum(qs * ks[..., None], dim=-2))
        out = (attn * self.temperature.reshape(1, h, 1))[..., None] \
            * v.float().transpose(-1, -2)                      # (B, h, hd, N)
        return out.permute(0, 3, 1, 2).reshape(B, H, W, C).to(x.dtype)


class FANSwinBlock(nn.Module):
    """SwinV2 attention + FAN ChannelProcessing residuals."""

    def __init__(self, dim: int, heads: int, input_resolution: int,
                 shift: int = 0, drop_path: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.shift = shift
        self.attn = WindowAttention(dim, (WINDOW, WINDOW), heads,
                                    compute_dtype)
        self.norm2 = BatchNorm2d(dim)
        self.chnnel_processing = ChannelProcessing(dim, heads, compute_dtype)
        self.norm3 = BatchNorm2d(dim)
        self.drop_path = DropPath(drop_path)
        mask = None
        if shift > 0:
            mask = torch.from_numpy(shifted_window_mask(
                input_resolution, input_resolution, WINDOW, shift))
        self.register_buffer("attn_mask", mask)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """x: NCHW (channels_last memory) → same; ``generator`` feeds
        DropPath in training."""
        H, W = x.shape[2], x.shape[3]
        s = self.shift
        xh = x.permute(0, 2, 3, 1)
        if s > 0:
            xh = torch.roll(xh, (-s, -s), dims=(1, 2))
        mask = self.attn_mask
        if mask is not None and mask.shape[0] != (H // WINDOW) * (W // WINDOW):
            # fr_tpu builds the mask from the tensor's own size; the buffer
            # (the reference's name and shape) follows the bookkeeping
            # resolution, which differs from it at some image sizes
            mask = torch.from_numpy(shifted_window_mask(H, W, WINDOW, s)).to(
                x.device)
        if use_spatial_attention(WINDOW, self.dim):
            xh = self.attn(xh, mask)
        else:
            attn = self.attn(window_partition(xh, WINDOW), mask)
            xh = window_reverse(attn, WINDOW, H, W)
        if s > 0:
            xh = torch.roll(xh, (s, s), dims=(1, 2))
        x = x + self.drop_path(self.norm2(xh.permute(0, 3, 1, 2)), generator)
        cp = self.chnnel_processing(x.permute(0, 2, 3, 1))
        return x + self.drop_path(self.norm3(cp.permute(0, 3, 1, 2)),
                                  generator)


def stage_plan(cfgs, img_size: int):
    """fr_tpu's bookkeeping: per stage, (cfg, bookkeeping res, the slots
    after the first block: True for a transformer slot)."""
    res = img_size
    plan = []
    for cfg in cfgs:
        n, n_tr = cfg[2], cfg[5]
        if res > WINDOW:
            num_blocks = 2 * (n // 3) + (n % 3) - 1
            assert 3 * n_tr <= n, \
                "The number of transformers must not exceed cnn !!!"
        else:
            num_blocks = n - 1
            assert 2 * n_tr <= n, \
                "The number of transformers must not exceed cnn !!!"
        seq = [False] * num_blocks
        for i in range(n_tr):
            seq[-2 * i - 1] = True
        plan.append((cfg, res, seq))
        res //= 2
    return plan


class EffNetV2(nn.Module):
    """Forward takes NHWC images; every FANSwinBlock's DropPath draws from
    the ``generator`` passed to forward in training."""

    def __init__(self, cfgs: Sequence[Sequence[int]], img_size: int = 112,
                 emd_size: int = 512,
                 compute_dtype: torch.dtype = torch.float32,
                 dw_taps: bool = False):
        super().__init__()
        cd = self.compute_dtype = compute_dtype
        in_ch = _make_divisible(24, 8)
        feats = [nn.Sequential(EConv(3, in_ch, 3, 1, cd), BatchNorm2d(in_ch),
                               nn.SiLU())]
        for (t, c, _, s, use_se, _, heads), res, seq in stage_plan(
                cfgs, img_size):
            out_ch = _make_divisible(c, 8)
            feats.append(MBConv(in_ch, out_ch, s, t, bool(use_se), cd,
                                dw_taps))
            for is_alt in seq:
                if not is_alt:
                    feats.append(MBConv(out_ch, out_ch, 1, t, bool(use_se),
                                        cd, dw_taps))
                    continue
                feats.append(FANSwinBlock(out_ch, heads, res,
                                          compute_dtype=cd))
                if res > WINDOW:
                    feats.append(FANSwinBlock(out_ch, heads, res,
                                              shift=WINDOW // 2,
                                              compute_dtype=cd))
            in_ch = out_ch
        self.features = nn.ModuleList(feats)
        self.fc = _TruncLinear(in_ch * 49, emd_size)
        self.bn = BatchNorm1d(emd_size)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        for block in self.features:
            x = (block(x, generator) if isinstance(block, FANSwinBlock)
                 else block(x))
        x = adaptive_avg_pool(x.float().permute(0, 2, 3, 1), 7, 7)
        # NCHW flatten order, as fr_tpu transposes before its Dense
        return self.bn(self.fc(x.permute(0, 3, 1, 2).flatten(1)))


EFFIALTER_CFGS = {
    # [t, c, n, s, SE, n_transformer, heads]
    "EffiAlter_s": [
        [1, 24, 1, 1, 0, 0, 2], [2, 48, 3, 2, 0, 0, 2],
        [2, 64, 4, 2, 0, 0, 2], [2, 128, 5, 2, 1, 0, 4],
        [3, 160, 9, 1, 1, 0, 8], [3, 256, 4, 2, 1, 0, 8],
    ],
    "EffiAlter_m": [
        [1, 24, 3, 1, 0, 0, 2], [4, 48, 5, 2, 0, 0, 2],
        [4, 80, 5, 2, 0, 0, 2], [4, 160, 7, 2, 1, 0, 4],
        [6, 176, 14, 1, 1, 0, 8], [6, 304, 18, 2, 1, 2, 8],
        [6, 512, 5, 1, 1, 2, 16],
    ],
    "EffiAlter_l": [
        [1, 32, 4, 1, 0, 0, 2], [4, 64, 7, 2, 0, 0, 2],
        [4, 96, 7, 2, 0, 0, 2], [4, 192, 10, 2, 1, 0, 4],
        [6, 224, 19, 1, 1, 2, 8], [6, 384, 25, 2, 1, 2, 16],
        [6, 640, 7, 1, 1, 2, 32],
    ],
    "EffiAlter_xl": [
        [1, 32, 4, 1, 0, 0, 2], [4, 64, 8, 2, 0, 0, 2],
        [4, 96, 8, 2, 0, 0, 2], [4, 192, 16, 2, 1, 0, 4],
        [6, 256, 24, 1, 1, 2, 8], [6, 512, 32, 2, 1, 2, 16],
        [6, 640, 8, 1, 1, 2, 32],
    ],
}


def build_effialternet(conf) -> EffNetV2:
    dtype = torch.bfloat16 if conf.get("mixed_precision", False) \
        else torch.float32
    return EffNetV2(EFFIALTER_CFGS[conf.network], img_size=conf.img_size,
                    emd_size=conf.emd_size, compute_dtype=dtype,
                    dw_taps=bool(conf.get("dw_taps", False)))
