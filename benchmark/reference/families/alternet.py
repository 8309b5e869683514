"""AlterNet (Park & Kim, arXiv:2202.06709) in its face variant: a stride-2
stem, BasicBlocks interleaved with pairs of SwinV2 window-attention blocks
(W-MSA, then SW-MSA shifted by half a window); a Swin block is
x + DropPath(BN(attention(x))); the attention is SwinV2's cosine attention
with a clamped per-head logit scale and the continuous position bias (a
2 → 512 → heads MLP, 16·sigmoid). Head: BN → ReLU → Dropout → adaptive
average pool → Linear → BN1d.

``model``: ``blocks``, ``widths``, ``heads``, ``windows`` and
``swin_pairs`` per stage, ``emd_size``, ``img_size``, ``stem_stride``,
``pool``, ``drop_path`` and ``head_dropout``."""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.encoders import (Quant, basic_block, basic_spec,
                                          batch_norm, bn_spec, conv,
                                          keep_or_drop, linear, unit)


def _swin_spec(spec, prefix: str, dim: int, heads: int) -> None:
    a = f"{prefix}.attn"
    spec += [(f"{a}.qkv.weight", (3 * dim, dim), "weight"),
             (f"{a}.q_bias", (dim,), "bias"),
             (f"{a}.v_bias", (dim,), "bias"),
             (f"{a}.logit_scale", (heads, 1, 1), "logit_scale"),
             (f"{a}.cpb_mlp.0.weight", (512, 2), "weight"),
             (f"{a}.cpb_mlp.0.bias", (512,), "bias"),
             (f"{a}.cpb_mlp.2.weight", (heads, 512), "weight"),
             (f"{a}.proj.weight", (dim, dim), "weight"),
             (f"{a}.proj.bias", (dim,), "bias")]
    bn_spec(spec, f"{prefix}.norm2", dim)


def alt_sequence(blocks: int, pairs: int) -> List[bool]:
    """AlterNet's slots after a stage's first (strided) block: True where a
    pair of Swin blocks stands, at every other slot from the end."""
    seq = [False] * (2 * (blocks // 3) + (blocks % 3) - 1)
    for i in range(pairs):
        seq[-2 * i - 1] = True
    return seq


def stage_plan(model: dict) -> List[List[Tuple]]:
    """Per stage, its blocks: ("basic", cin, cout, stride) or
    ("swin", dim, heads, window, shift, resolution)."""
    widths, blocks = model["widths"], model["blocks"]
    plan, cin = [], widths[0]
    res = model["img_size"] // (2 * model["stem_stride"])
    for s, (w, n) in enumerate(zip(widths, blocks)):
        stride = 1 if s == 0 else 2
        if s > 0:
            res //= 2
        stage = [("basic", cin, w, stride)]
        win = model["windows"][s]
        for is_pair in alt_sequence(n, model["swin_pairs"][s]):
            if is_pair:
                stage += [("swin", w, model["heads"][s], win, 0, res),
                          ("swin", w, model["heads"][s], win, win // 2, res)]
            else:
                stage.append(("basic", w, w, 1))
        plan.append(stage)
        cin = w
    return plan


def param_spec(model: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    spec: list = [("conv1.weight", (model["widths"][0], 3, 3, 3), "weight")]
    bn_spec(spec, "bn1", model["widths"][0])
    for s, stage in enumerate(stage_plan(model), start=1):
        for i, blk in enumerate(stage):
            if blk[0] == "basic":
                basic_spec(spec, f"layer{s}.{i}", *blk[1:])
            else:
                _swin_spec(spec, f"layer{s}.{i}", blk[1], blk[2])
    emd = model["emd_size"]
    bn_spec(spec, "bn2", emd)
    spec += [("fc.weight", (emd, emd * model["pool"] ** 2), "weight"),
             ("fc.bias", (emd,), "bias")]
    bn_spec(spec, "bn3", emd)
    return spec


# ---------------------------------------------------------------------------
# Window attention
# ---------------------------------------------------------------------------

def relative_coords_table(ws: int) -> np.ndarray:
    """SwinV2's log-spaced relative coordinates, (2ws−1)² × 2."""
    r = np.arange(-(ws - 1), ws, dtype=np.float32)
    t = np.stack(np.meshgrid(r, r, indexing="ij"), axis=-1) / max(ws - 1, 1)
    t = t * 8.0
    t = np.sign(t) * np.log2(np.abs(t) + 1.0) / np.log2(8.0)
    return t.reshape(-1, 2).astype(np.float32)


def relative_position_index(ws: int) -> np.ndarray:
    """(N, N) index of token j's offset from token i in the table."""
    yy, xx = np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")
    y, x = yy.reshape(-1), xx.reshape(-1)
    dy = y[:, None] - y[None, :] + ws - 1
    dx = x[:, None] - x[None, :] + ws - 1
    return (dy * (2 * ws - 1) + dx).astype(np.int64)


def shift_mask(res: int, ws: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive mask of the shifted windows: −100 between tokens
    that came from different regions of the rolled map."""
    region = np.zeros((res, res), np.float32)
    cuts = (slice(0, res - ws), slice(res - ws, res - shift),
            slice(res - shift, res))
    for i, a in enumerate(cuts):
        for j, b in enumerate(cuts):
            region[a, b] = 3 * i + j
    win = region.reshape(res // ws, ws, res // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    return np.where(win[:, :, None] != win[:, None, :], -100.0,
                    0.0).astype(np.float32)


def to_windows(x, ws: int):
    """(B, H, W, C) → (B·nW, ws², C), windows of one image together."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def from_windows(w, ws: int, H: int, W: int):
    C = w.shape[-1]
    B = w.shape[0] // ((H // ws) * (W // ws))
    x = w.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def window_attention(win, p, a: str, heads: int, ws: int, mask, q: Quant):
    """SwinV2 cosine attention over windows (B·nW, N, C)."""
    Wn, N, C = win.shape
    hd = C // heads
    bias = torch.cat([p[f"{a}.q_bias"], torch.zeros_like(p[f"{a}.q_bias"]),
                      p[f"{a}.v_bias"]])
    qkv = linear(win, p[f"{a}.qkv.weight"], bias, q)
    qkv = qkv.reshape(Wn, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    qh, kh, vh = unit(qkv[0]), unit(qkv[1]), qkv[2]
    scale = torch.exp(torch.clamp(p[f"{a}.logit_scale"],
                                  max=math.log(100.0))).reshape(1, heads, 1, 1)
    coords = torch.from_numpy(relative_coords_table(ws)).to(win.device)
    hidden = F.relu(coords @ p[f"{a}.cpb_mlp.0.weight"].t()
                    + p[f"{a}.cpb_mlp.0.bias"])
    table = hidden @ p[f"{a}.cpb_mlp.2.weight"].t()            # (T, heads)
    idx = torch.from_numpy(relative_position_index(ws)).to(win.device)
    pos = 16.0 * torch.sigmoid(table[idx].permute(2, 0, 1))     # (h, N, N)
    qa = getattr(q, "attention", q)   # the attention's own rounding, if any
    s = (qa(qh) @ qa(kh).transpose(-1, -2)) * scale + pos[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(Wn // nW, nW, heads, N, N)
             + mask[None, :, None]).reshape(Wn, heads, N, N)
    out = qa(torch.softmax(s, dim=-1)) @ qa(vh)                 # (W, h, N, hd)
    out = out.permute(0, 2, 1, 3).reshape(Wn, N, C)
    return linear(out, p[f"{a}.proj.weight"], p[f"{a}.proj.bias"], q)


def swin_block(x, p, prefix, dim, heads, ws, shift, res, train, gen, q,
               drop_path: float):
    B, C, H, W = x.shape
    xh = x.permute(0, 2, 3, 1)
    if shift:
        xh = torch.roll(xh, (-shift, -shift), dims=(1, 2))
    mask = None
    if shift:
        mask = torch.from_numpy(shift_mask(res, ws, shift)).to(x.device)
    out = window_attention(to_windows(xh, ws), p, f"{prefix}.attn", heads, ws,
                           mask, q)
    out = from_windows(out, ws, H, W)
    if shift:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    out = batch_norm(out.permute(0, 3, 1, 2), p, f"{prefix}.norm2", train)
    if train and drop_path > 0:
        out = keep_or_drop(out, drop_path, (B, 1, 1, 1), gen)
    return x + out


def forward(model: dict, p, images, train: bool, gen, q):
    x = images.float().permute(0, 3, 1, 2)
    x = conv(x, p["conv1.weight"], model["stem_stride"], q)
    x = F.max_pool2d(F.relu(batch_norm(x, p, "bn1", train)), 3, 2, 1)
    for s, stage in enumerate(stage_plan(model), start=1):
        for i, blk in enumerate(stage):
            prefix = f"layer{s}.{i}"
            if blk[0] == "basic":
                x = basic_block(x, p, prefix, blk[3], train, q)
            else:
                x = swin_block(x, p, prefix, *blk[1:], train, gen, q,
                               model["drop_path"])
    x = F.relu(batch_norm(x, p, "bn2", train))
    if train and model["head_dropout"] > 0:
        x = keep_or_drop(x, model["head_dropout"], x.shape, gen)
    x = F.adaptive_avg_pool2d(x, model["pool"])
    x = linear(x.flatten(1), p["fc.weight"], p["fc.bias"], q)
    return batch_norm(x, p, "bn3", train)
