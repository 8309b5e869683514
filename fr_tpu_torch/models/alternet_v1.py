"""The original AlterNet, local-attention generation (counterpart of
fr_tpu/models/alternet_v1.py; not reachable from the reference's dispatch,
kept because fr_tpu builds it).

- LocalAttention: Attention2d (1×1-conv q and kv, scaled dot product over
  dim_head 64, 1×1-conv output with bias) in p×p windows with a learned
  2-D relative position bias; p is 7, or 2 where the map is 4×4 (fr_tpu
  decides at call time from the tensor; the port's module is built for its
  stage's resolution, which fixes the bias table's shape);
- AttentionBasicBlockB: pre-activation BN → GELU → 1×1 conv → BN →
  local attention, plus the identity skip. fr_tpu's strided 1×1-conv skip
  for a change of width or stride is not built: no stage plan asks for
  it;
- stages: the strided BasicBlock, then [False]·(blocks − 2·blocks2 − 1) +
  [False, True]·blocks2 slots, one attention block per True; stem conv 3×3
  s1 (112 px), head BN → Dropout(0.5) → GAP 7×7 → Dense(emd·49 → emd) →
  BN1d; heads (3, 6, 12, 24).

The products are XLA einsums in fr_tpu (no Pallas kernel) and torch.matmul
here, on the compute-dtype operands with f32 accumulation. fr_tpu's torch
export has no naming for this network; the port's names follow the
reference's modules (norm1, conv, norm2, attn.pos_embedding,
attn.attn.to_q / to_kv / to_out.0) and AlterNet's for the rest.
At 192 px, the size fr_tpu's default_img_size gives AlterNetV1, stage 2's
48×48 map is not whole 7×7 windows and fr_tpu fails to build (ROADMAP §3);
the port raises likewise. Run it at 112 px.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fr_tpu_torch.models.alternet import alt_sequence_sep
from fr_tpu_torch.models.common import (BatchNorm1d, BatchNorm2d, Conv, Dense,
                                        dropout, max_pool_3x3_s2)
from fr_tpu_torch.models.resnet import BasicBlock
from fr_tpu_torch.models.swin_common import adaptive_avg_pool


def _rel_index(p: int) -> np.ndarray:
    """(p², p², 2) pairwise offsets shifted to [0, 2p − 2]."""
    coords = np.array([[x, y] for x in range(p) for y in range(p)])
    d = coords[None, :, :] - coords[:, None, :]
    return (d + p - 1).astype(np.int64)


class Attention2d(nn.Module):
    """Scaled dot-product attention over a window batch (B', C, p, p) NCHW;
    ``bias`` (p², p²) f32 is added to the scores. fr_tpu's kv stride k is
    1 wherever it builds the block, so kv is a 1×1 conv too."""

    def __init__(self, dim_in: int, dim_out: int, heads: int,
                 dim_head: int = 64,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.compute_dtype = compute_dtype
        self.to_q = Conv(dim_in, inner, 1, 1, compute_dtype)
        self.to_kv = Conv(dim_in, 2 * inner, 1, 1, compute_dtype)
        self.to_out = nn.Sequential(Conv(inner, dim_out, 1, 1, compute_dtype,
                                         bias=True))

    def forward(self, x, bias):
        cd = self.compute_dtype
        B, _, H, W = x.shape
        q = self.to_q(x)
        kv = self.to_kv(x)
        inner = self.heads * self.dim_head

        def heads(t):   # (B, c, h, w) → (B, heads, h·w, dim_head) in f32
            b, _, h, w = t.shape
            return t.reshape(b, self.heads, self.dim_head, h * w).transpose(
                -1, -2).float()

        k, v = heads(kv[:, :inner]), heads(kv[:, inner:])
        dots = torch.matmul(heads(q), k.transpose(-1, -2))
        dots = dots * self.dim_head ** -0.5 + bias
        attn = torch.softmax(dots, dim=-1).to(cd).float()
        out = torch.matmul(attn, v)                    # (B, heads, HW, dh)
        out = out.transpose(-1, -2).reshape(B, inner, H, W).to(cd)
        return self.to_out(out)


class LocalAttention(nn.Module):
    """Attention2d in p×p windows of a NCHW map, with the relative position
    bias pos_embedding[(Δy, Δx)]; ``res`` is the map's resolution, p = 2
    where it is 4, else ``window``."""

    def __init__(self, dim_in: int, dim_out: int, heads: int, res: int,
                 dim_head: int = 64, window: int = 7,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.p = 2 if res == 4 else window
        p = self.p
        self.attn = Attention2d(dim_in, dim_out, heads, dim_head,
                                compute_dtype=compute_dtype)
        self.pos_embedding = nn.Parameter(torch.zeros(2 * p - 1, 2 * p - 1))
        nn.init.normal_(self.pos_embedding, 0.0, 0.02)
        self.register_buffer("rel_index", torch.from_numpy(_rel_index(p)),
                             persistent=False)

    def forward(self, x):
        B, C, H, W = x.shape
        p = self.p
        if H % p or W % p:
            raise ValueError(f"a {H}×{W} map is not whole windows of {p} "
                             f"(AlterNetV1 needs a 112 px input)")
        n1, n2 = H // p, W // p
        bias = self.pos_embedding[self.rel_index[..., 0],
                                  self.rel_index[..., 1]]
        xw = x.reshape(B, C, n1, p, n2, p).permute(0, 2, 4, 1, 3, 5)
        out = self.attn(xw.reshape(B * n1 * n2, C, p, p), bias)
        c = out.shape[1]
        out = out.reshape(B, n1, n2, c, p, p).permute(0, 3, 1, 4, 2, 5)
        return out.reshape(B, c, H, W).contiguous(
            memory_format=torch.channels_last)


class AttentionBasicBlockB(nn.Module):
    """Pre-activation local-attention block, expansion 1, width kept:
    x + attn(norm2(conv(GELU(norm1(x)))))."""

    def __init__(self, dim: int, heads: int, res: int, dim_head: int = 64,
                 window: int = 7, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = BatchNorm2d(dim)
        self.conv = Conv(dim, dim, 1, 1, compute_dtype)
        self.norm2 = BatchNorm2d(dim)
        self.attn = LocalAttention(dim, dim, heads, res, dim_head, window,
                                   compute_dtype)

    def forward(self, x):
        h = self.conv(F.gelu(self.norm1(x), approximate="tanh"))
        return self.attn(self.norm2(h)) + x


class AlterNetV1(nn.Module):
    """Forward takes NHWC images of ``img_size`` (112). In training the
    head's dropout draws from the ``generator`` passed to forward."""

    def __init__(self, num_blocks: Sequence[int], num_blocks2: Sequence[int],
                 heads: Sequence[int] = (3, 6, 12, 24), img_size: int = 112,
                 emd_size: int = 512,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = Conv(3, 64, 3, 1, compute_dtype)
        self.bn1 = BatchNorm2d(64)
        res = (img_size + 1) // 2          # the stride-2 max-pool
        inplanes = 64
        for si, (planes, blocks, blocks2, h, stride) in enumerate(
                zip((64, 128, 256, emd_size), num_blocks, num_blocks2, heads,
                    (1, 2, 2, 2)), start=1):
            res = (res - 1) // stride + 1
            mods = [BasicBlock(inplanes, planes, stride, compute_dtype)]
            # one attention block per True slot, AlterNetSep's placement
            for is_alt in alt_sequence_sep(blocks, blocks2):
                mods.append(
                    AttentionBasicBlockB(planes, h, res,
                                         compute_dtype=compute_dtype)
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
            x = getattr(self, f"layer{si}")(x)
        x = self.bn2(x)
        if self.training:
            x = dropout(x, 0.5, generator)
        x = adaptive_avg_pool(x.float().permute(0, 2, 3, 1), 7, 7)
        # NCHW flatten order, as fr_tpu transposes before its Dense
        return self.bn3(self.fc(x.permute(0, 3, 1, 2).flatten(1)))


ALTERNET_V1_PLANS = {
    # name: (num_blocks, num_blocks2); heads (3, 6, 12, 24) for all
    "AlterNetV1_18": ((2, 2, 2, 2), (0, 1, 1, 2)),
    "AlterNetV1_34": ((3, 4, 6, 3), (0, 1, 1, 2)),
    "AlterNetV1_50": ((3, 4, 14, 3), (0, 1, 1, 2)),
    "AlterNetV1_100": ((3, 13, 30, 3), (0, 1, 1, 2)),
    "AlterNetV1_200": ((3, 43, 50, 3), (0, 1, 1, 2)),
}


def build_alternet_v1(conf) -> AlterNetV1:
    blocks, blocks2 = ALTERNET_V1_PLANS[conf.network]
    dtype = torch.bfloat16 if conf.get("mixed_precision", False) \
        else torch.float32
    return AlterNetV1(blocks, blocks2, img_size=conf.img_size,
                      emd_size=conf.emd_size, compute_dtype=dtype)
