"""Vision Transformer face encoder: insightface arcface_torch's
``backbones/vit.py`` as ``backbones/__init__.py`` builds it for WebFace42M
(``vit_l_dp005_mask_005``: ViT-L, the preset ``ViT_L`` below). fr_tpu has
no ViT; this family is the port's own.

The forward, on NHWC images:
- patch embedding: a ``patch``×``patch`` convolution of stride ``patch``
  with bias (3 → D channels, no padding; the pixels past the last whole
  patch are never read), the tokens in row-major order, plus a learned
  position embedding (1, N, D);
- token masking, in training with ``mask_ratio`` > 0: per image, noise of
  shape (B, N) is argsorted and the first int(N·(1 − mask_ratio)) tokens
  of that order are kept and gathered (MAE's random masking; a stable sort,
  so ties keep their index order). ``mask_ratio`` sets how many are kept:
  136 of 144 at ViT-L's 0.05, where insightface's ``forward_features``
  calls ``random_masking`` at that function's default of 0.1 (129 kept)
  and uses ``mask_ratio`` only to switch the masking on;
- ``depth`` pre-LayerNorm blocks, x ← x + DropPath(Proj(Attn(LN₁(x)))),
  then x ← x + DropPath(FC₂(ReLU6(FC₁(LN₂(x))))): global attention of
  ``heads`` heads at scale d_h^-½ (ops/global_attn.py), a qkv projection
  without bias, an output projection and both MLP layers with bias, the
  MLP ``mlp_ratio``·D wide with ReLU6 between (insightface's ``Mlp`` and
  ``Block`` default ``act_layer`` to ``nn.ReLU6``, and its
  ``VisionTransformer`` passes none); drop-path rates linspace(0,
  ``drop_path``, ``depth``), no draw where a rate is 0;
- a final LayerNorm; in training the mask token (1, 1, D) fills the
  dropped places and the tokens go back to their order (the inverse
  permutation);
- the feature head: flatten (N·D) → Linear(N·D → D, no bias) →
  BN1d(eps 2e-5) → Linear(D → emd, no bias) → BN1d(eps 2e-5).

Precision follows the port's cast-per-call convention (models/common.py):
every product runs in the compute dtype (bf16 under mixed precision), the
attention's two products included, while the residual stream, the
LayerNorms and the masking stay in float32. The BatchNorms are the port's
(ops/batch_norm.py).

Randomness in training draws from the generator passed to forward (the
step's "dropout" stream), in this order: the masking noise (B, N), then
for each block with a non-zero rate the attention branch's keep draw and
then the MLP branch's, (B, 1, 1) each (models/swin_common.py's DropPath).

Initialisation is insightface's ``_init_weights``: linear weights from a
normal of std 0.02 cut at ±2 (timm's ``trunc_normal_``, so in effect
uncut), zero linear biases, LayerNorm 1 and 0, the position embedding as
the linear weights, the mask token N(0, 0.02²), and the patch projection
as PyTorch's Conv2d default (uniform of bound 1/√fan_in).

Parameter names are insightface's: ``patch_embed.proj``, ``pos_embed``,
``mask_token``, ``blocks.{i}.norm1``, ``.attn.qkv``, ``.attn.proj``,
``.norm2``, ``.mlp.fc1``, ``.mlp.fc2``, ``norm``, ``feature.0``–``3``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fr_tpu_torch.models.common import BatchNorm1d, Dense
from fr_tpu_torch.models.swin_common import DropPath
from fr_tpu_torch.ops.global_attn import global_attention
from fr_tpu_torch.utils import profiling as spans
from fr_tpu_torch.utils.profiling import span

VIT_PRESETS = {
    # insightface's vit_l_dp005_mask_005 (WebFace42M)
    "ViT_L": dict(patch=9, depth=24, embed_dim=768, heads=8, mlp_ratio=4,
                  drop_path=0.05, mask_ratio=0.05),
    # a tiny preset of the same family, for tests
    "ViT_T": dict(patch=9, depth=3, embed_dim=64, heads=4, mlp_ratio=4,
                  drop_path=0.05, mask_ratio=0.25),
}
LN_EPS = 1e-5
FEATURE_BN_EPS = 2e-5


def kept_tokens(num_patches: int, mask_ratio: float) -> int:
    """Tokens the blocks see in training: int(N·(1 − mask_ratio))."""
    return int(num_patches * (1 - mask_ratio))


def drop_path_rates(drop_path: float, depth: int):
    """Each block's drop-path rate, as insightface draws them up:
    float32 linspace(0, drop_path, depth)."""
    return torch.linspace(0, drop_path, depth, device="cpu").tolist()


class PatchEmbed(nn.Module):
    """NHWC images → (B, N, D) tokens in the compute dtype."""

    def __init__(self, patch: int, dim: int, compute_dtype: torch.dtype):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        cd = self.compute_dtype
        y = F.conv2d(x.to(cd).permute(0, 3, 1, 2), self.proj.weight.to(cd),
                     self.proj.bias.to(cd), self.proj.stride)
        # channels_last (B, D, h, w) → (B, h·w, D), a view
        return y.flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, compute_dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = Dense(dim, 3 * dim, bias=False, compute_dtype=compute_dtype)
        self.proj = Dense(dim, dim, compute_dtype=compute_dtype)

    def forward(self, x):
        B, L, D = x.shape
        qkv = self.qkv(x).reshape(B, L, 3, self.heads, D // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        out = global_attention(q, k, v, self.scale)
        return self.proj(out.transpose(1, 2).reshape(B, L, D))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, compute_dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(dim, hidden, compute_dtype=compute_dtype)
        self.fc2 = Dense(hidden, dim, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.fc2(F.relu6(self.fc1(x)))


class Block(nn.Module):
    """Pre-LayerNorm transformer block; the residual stream in f32."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int,
                 drop_path: float, compute_dtype: torch.dtype):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads, compute_dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, dim * mlp_ratio, compute_dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = x + self.drop_path(self.attn(self.norm1(x)), generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)


class VisionTransformer(nn.Module):
    """Forward takes NHWC images and, in training, the generator that the
    masking and DropPath draw from."""

    def __init__(self, img_size: int = 112, patch: int = 9, depth: int = 24,
                 embed_dim: int = 768, heads: int = 8, mlp_ratio: int = 4,
                 drop_path: float = 0.05, mask_ratio: float = 0.05,
                 emd_size: int = 512,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.num_patches = (img_size // patch) ** 2
        self.mask_ratio = mask_ratio
        self.n_keep = kept_tokens(self.num_patches, mask_ratio)
        self.patch_embed = PatchEmbed(patch, embed_dim, compute_dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.num_patches,
                                                  embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, heads, mlp_ratio, rate, compute_dtype)
            for rate in drop_path_rates(drop_path, depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.feature = nn.Sequential(
            Dense(embed_dim * self.num_patches, embed_dim, bias=False,
                  compute_dtype=compute_dtype),
            BatchNorm1d(embed_dim, eps=FEATURE_BN_EPS),
            Dense(embed_dim, emd_size, bias=False,
                  compute_dtype=compute_dtype),
            BatchNorm1d(emd_size, eps=FEATURE_BN_EPS))
        self.mask_token = nn.Parameter(torch.zeros(1, 1, embed_dim))

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """insightface's initialisation of every parameter
        (``init_weights`` hands its generator here in place of its own
        pass)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, 0.0, 0.02, -2.0, 2.0,
                                      generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        nn.init.trunc_normal_(self.pos_embed, 0.0, 0.02, -2.0, 2.0,
                              generator=gen)
        self.mask_token.normal_(0.0, 0.02, generator=gen)
        proj = self.patch_embed.proj
        bound = 1.0 / math.sqrt(math.prod(proj.weight.shape[1:]))
        proj.weight.uniform_(-bound, bound, generator=gen)
        proj.bias.uniform_(-bound, bound, generator=gen)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        B, N = x.shape[0], self.num_patches
        x = self.patch_embed(x) + self.pos_embed        # f32 from here
        D = x.shape[-1]
        masked = self.training and self.mask_ratio > 0
        if masked:
            if generator is None:
                raise ValueError("token masking in training needs an "
                                 "explicit torch.Generator (the port uses "
                                 "no global RNG)")
            with span(spans.ENCODER_VIT_MASK):
                noise = torch.rand((B, N), generator=generator,
                                   device=x.device)
                shuffle = torch.argsort(noise, dim=1, stable=True)
                restore = torch.argsort(shuffle, dim=1, stable=True)
                keep = shuffle[:, :self.n_keep, None].expand(-1, -1, D)
                x = torch.gather(x, 1, keep)
        for block in self.blocks:
            x = block(x, generator)
        x = self.norm(x)
        if masked:
            with span(spans.ENCODER_VIT_MASK):
                fill = self.mask_token.expand(B, N - self.n_keep, D)
                x = torch.gather(torch.cat([x, fill], 1), 1,
                                 restore[:, :, None].expand(-1, -1, D))
        return self.feature(x.reshape(B, N * D))


def build_vit(conf) -> VisionTransformer:
    dtype = torch.bfloat16 if conf.get("mixed_precision", False) \
        else torch.float32
    return VisionTransformer(img_size=conf.img_size, emd_size=conf.emd_size,
                             compute_dtype=dtype,
                             **VIT_PRESETS[conf.network])
