"""SwinV2 window-attention machinery (counterpart of
fr_tpu/models/swin_common.py).

Window partition/reverse are reshapes and permutes on NHWC; the SW-MSA mask
and the continuous-position-bias tables are numpy constants computed with
the same math as fr_tpu; attention is cosine attention with a per-head
clamped logit scale and the 2→512→heads CPB MLP with 16·sigmoid bias.

Everything between the qkv and output projections runs in one op, routed
as fr_tpu's ``_fused_call`` routes it: ``ops.fused_window_attention_packed``
when heads·N ≤ 288 (the AlterNet shapes), ``ops.fused_window_attention``
(the per-head entry) otherwise (the Swin and EffiAlterNet N=49 shapes).
Under autograd each takes the recompute arm, or the stored-stats arm when
``attention_stats_inmodel()`` (FR_ATTN_STORED_STATS=1).

fr_tpu's two opt-in variants (ops/fused_window_attn_variants.py), routed as
fr_tpu's ``WindowAttention.__call__`` routes them:
- rank-4 (B, H, W, C) input: the spatial kernel when (window, dim) is in
  ``SPATIAL_KERNEL_CONFIGS`` (empty by default, as in fr_tpu; the blocks
  ask ``use_spatial_attention`` and then pass their map whole), else the
  window partition, the windows API and the reverse around it;
- ``entry_fused = True`` on a module (a class attribute, False by
  default): the entry-fused kernel, on packed shapes with rank-3 input.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fr_tpu_torch.ops.fused_window_attn import (
    fused_window_attention, fused_window_attention_packed)
from fr_tpu_torch.ops.fused_window_attn_variants import (
    fused_window_attention_packed_qkv, fused_window_attention_spatial)

# (window, dim) pairs routed to the spatial kernel; empty, as in fr_tpu
# (swin_common.py:38). Read at every call, so a caller may set it.
SPATIAL_KERNEL_CONFIGS = frozenset()


def use_spatial_attention(window: int, dim: int) -> bool:
    """Whether a block hands its (B, H, W, C) map whole to WindowAttention
    (fr_tpu's ``use_spatial_attention``; the port's attention is always
    the fused one)."""
    return (window, dim) in SPATIAL_KERNEL_CONFIGS

# fr_tpu's routing rule between its two attention entries: heads·N ≤ 288
# goes to the packed entry (every AlterNet shape), wider to the per-head
# entry (the Swin/EffiAlter N=49 shapes).
PACKED_LANE_CAP = 288


def pick_head_group(num_heads: int, n_tokens: int) -> int:
    """Head-group size for fused_window_attention_packed, or 0 for the
    per-head entry (fr_tpu/models/swin_common.py:55-77)."""
    if num_heads * n_tokens <= PACKED_LANE_CAP:
        return num_heads
    return 0


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, ws·ws, C), windows image-major."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int, W: int
                   ) -> torch.Tensor:
    """(B·nW, ws·ws, C) → (B, H, W, C)."""
    C = windows.shape[-1]
    B = windows.shape[0] // ((H // ws) * (W // ws))
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def relative_coords_table(window: Tuple[int, int],
                          pretrained: Tuple[int, int] = (0, 0)) -> np.ndarray:
    """Log-spaced continuous relative coordinates, (1, 2Wh-1, 2Ww-1, 2)."""
    wh, ww = window
    h = np.arange(-(wh - 1), wh, dtype=np.float32)
    w = np.arange(-(ww - 1), ww, dtype=np.float32)
    table = np.stack(np.meshgrid(h, w, indexing="ij"), axis=-1)[None]
    div_h = (pretrained[0] - 1) if pretrained[0] > 0 else (wh - 1)
    div_w = (pretrained[1] - 1) if pretrained[1] > 0 else (ww - 1)
    table[..., 0] /= max(div_h, 1)
    table[..., 1] /= max(div_w, 1)
    table *= 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.astype(np.float32)


def relative_position_index(window: Tuple[int, int]) -> np.ndarray:
    """(Wh·Ww, Wh·Ww) index into the flattened CPB table."""
    wh, ww = window
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int32)


def shifted_window_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive SW-MSA mask, 0 within a region and -100 across."""
    img = np.zeros((H, W), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """SwinV2 cosine window attention over pre-partitioned windows
    (B·nW, N, C), or over a (B, H, W, C) map (rolled for SW-MSA by the
    caller). Parameter and buffer names are the reference's.
    ``entry_fused`` (False) puts the qkv projection inside the attention
    kernel on packed shapes."""

    entry_fused = False

    def __init__(self, dim: int, window: Tuple[int, int], num_heads: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        assert dim % num_heads == 0
        self.num_heads = num_heads
        self.window = tuple(window)
        self.compute_dtype = compute_dtype
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.logit_scale = nn.Parameter(
            torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, 512, bias=True),
                                     nn.ReLU(inplace=True),
                                     nn.Linear(512, num_heads, bias=False))
        self.register_buffer("relative_coords_table", torch.from_numpy(
            relative_coords_table(window)))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window).astype(np.int64)))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        h = self.num_heads
        cd = self.compute_dtype
        C = x.shape[-1]
        ws = self.window[0]
        N = ws * ws
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias])
        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        scale = scale.reshape(h)
        table = self.cpb_mlp(self.relative_coords_table).reshape(-1, h)
        rel = table[self.relative_position_index.reshape(-1)]
        bias16 = 16.0 * torch.sigmoid(rel.reshape(N, N, h).permute(2, 0, 1))
        bias16 = bias16.contiguous()

        hg = pick_head_group(h, N)
        if x.dim() == 3 and self.entry_fused and hg:
            out = fused_window_attention_packed_qkv(
                x.to(cd), self.qkv.weight, bias, scale, bias16, h,
                mask.shape[0] if mask is not None else 1, mask, out_dtype=cd,
                head_group=hg)
        else:
            qkv = F.linear(x.to(cd), self.qkv.weight.to(cd)) + bias.to(cd)
            if x.dim() == 4 and (ws, C) in SPATIAL_KERNEL_CONFIGS:
                out = fused_window_attention_spatial(qkv, scale, bias16, h,
                                                     ws, mask).to(cd)
            elif x.dim() == 4:
                # an unlisted (window, dim): windows outside, the windows
                # API inside
                H, W = x.shape[1], x.shape[2]
                out = window_reverse(self._fused_call(
                    window_partition(qkv, ws), scale, bias16, mask), ws, H, W)
            else:
                out = self._fused_call(qkv, scale, bias16, mask)
        return F.linear(out, self.proj.weight.to(cd)) + self.proj.bias.to(cd)

    def _fused_call(self, qkv, scale, bias16, mask):
        """The packed or the per-head entry on windows (B·nW, N, 3C)."""
        h, N = self.num_heads, qkv.shape[1]
        nW = mask.shape[0] if mask is not None else 1
        entry = (fused_window_attention_packed if pick_head_group(h, N)
                 else fused_window_attention)
        return entry(qkv, scale, bias16, h, nW, mask,
                     out_dtype=self.compute_dtype,
                     stored_stats=attention_stats_inmodel())


def attention_stats_inmodel() -> bool:
    """Whether the model asks the attention entries for the stored-stats
    arm: FR_ATTN_STORED_STATS=1, fr_tpu's one in-model stats switch
    (fr_tpu/models/swin_common.py:324-352; off by default there from TPU
    measurements)."""
    return os.environ.get("FR_ATTN_STORED_STATS") == "1"


class DropPath(nn.Module):
    """Per-sample stochastic depth (fr_tpu/models/swin_common.py:394-405):
    in training each sample's branch is kept with probability 1 − rate and
    scaled by 1/(1 − rate), drawn from the explicit generator; identity in
    eval."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.rate == 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError("DropPath in training needs an explicit "
                             "torch.Generator (the port uses no global RNG)")
        keep = 1.0 - self.rate
        draw = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1),
                          generator=generator, device=x.device)
        return torch.where(draw < keep, x / keep, torch.zeros_like(x))


def adaptive_avg_pool(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """torch AdaptiveAvgPool2d on NHWC: bin i covers
    [floor(i·H/oh), ceil((i+1)·H/oh))."""
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), (oh, ow)
                                 ).permute(0, 2, 3, 1)
