"""The Vision Transformer face encoder of insightface's arcface_torch
(``backbones/vit.py``; ViT-L for WebFace42M is ``vit_l_dp005_mask_005`` in
``backbones/__init__.py``), in plain float32:

- patch embedding: conv ``patch``×``patch``, stride ``patch``, with bias,
  3 → D, no padding (at 112 px and patch 9, 12×12 = 144 tokens in
  row-major order; the last 4 pixel rows and columns are never read),
  plus the position embedding (1, N, D);
- in training, MAE's random masking: noise (B, N) from the generator,
  argsorted per image; the first int(N·(1 − mask_ratio)) tokens of that
  order are kept (at mask_ratio 0.05, 136 of 144);
- ``depth`` blocks, x ← x + DropPath(proj(attn(LN₁(x)))), then
  x ← x + DropPath(fc₂(ReLU6(fc₁(LN₂(x))))): ``heads`` heads of
  D/heads, scale (D/heads)^-½, qkv without bias, proj, fc₁ and fc₂ with
  bias, fc₁ ``mlp_ratio``·D wide, LayerNorm eps 1e-5; drop-path rates
  float32 linspace(0, ``drop_path``, ``depth``), a rate of 0 drawing
  nothing;
- the final LayerNorm; in training the mask token (1, 1, D) in the
  dropped places and the tokens put back in their order;
- flatten (N·D) → Linear(N·D → D, no bias) → BN1d(eps 2e-5) →
  Linear(D → emd_size, no bias) → BN1d(eps 2e-5).

The draws from the generator handed in, in the program's order: the
masking noise (B, N), then per block with a non-zero rate the attention
branch's (B, 1, 1) draw and the MLP branch's; a branch is kept where its
draw is below 1 − rate and then scaled by 1/(1 − rate)
(``encoders.keep_or_drop``'s rule).

Departures from insightface's ``vit.py``, each the port's too:
- the argsorts are stable, so that tied noise keeps the tokens' index
  order on both sides (insightface's sort is not stable);
- the masking keeps int(N·(1 − ``mask_ratio``)) tokens, 136 at the
  configuration's 0.05; insightface's ``forward_features`` calls
  ``random_masking(x)`` without a ratio, so that function's default of
  0.1 applies there (129 tokens kept) and ``mask_ratio`` only switches the
  masking on;
- every product is float32 here; the recipe runs qkv, proj and the MLP in
  float16 under autocast, the attention's core in float32, and the patch
  embedding and the feature head in float32 (outside autocast); the
  program runs every product in bfloat16 (the configuration's
  ``precision``).

With ``model["reference_chunk"]`` below the batch, training runs the
blocks over chunks of that many images, each under recomputation
(``torch.utils.checkpoint``), so that the float32 backward of a large
batch fits on the card: every draw is made for the whole batch before the
blocks, the blocks treat images independently, and the feature head's
BatchNorm still takes the whole batch's statistics, so the arithmetic is
that of one pass (an operand's rounding by a control's ``q`` that scales by
its own largest magnitude takes the chunk's).

``model``: ``img_size``, ``patch``, ``depth``, ``embed_dim``, ``heads``,
``mlp_ratio``, ``drop_path``, ``mask_ratio``, ``emd_size`` and optionally
``reference_chunk``."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.encoders import bn_spec, linear

EPS_LN = 1e-5
EPS_FEATURE_BN = 2e-5

# the draws of the parameter kinds this family adds (LayerNorm scales
# about 1 and shifts about 0, as ``inputs.py`` draws BatchNorm's)
INIT = {"ln_weight": lambda z, shape: 1.0 + 0.1 * z,
        "ln_bias": lambda z, shape: 0.1 * z,
        "pos_embed": lambda z, shape: 0.02 * z,
        "mask_token": lambda z, shape: 0.02 * z}


def num_patches(model: dict) -> int:
    return (model["img_size"] // model["patch"]) ** 2


def kept_tokens(model: dict) -> int:
    """The tokens the blocks see in training: int(N·(1 − mask_ratio))."""
    return int(num_patches(model) * (1 - model["mask_ratio"]))


def drop_rates(model: dict) -> List[float]:
    return torch.linspace(0, model["drop_path"], model["depth"]).tolist()


def param_spec(model: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """In the program's order: the encoder's own parameters, then its
    modules'."""
    D, P, N = model["embed_dim"], model["patch"], num_patches(model)
    H = D * model["mlp_ratio"]
    spec: list = [("pos_embed", (1, N, D), "pos_embed"),
                  ("mask_token", (1, 1, D), "mask_token"),
                  ("patch_embed.proj.weight", (D, 3, P, P), "weight"),
                  ("patch_embed.proj.bias", (D,), "bias")]
    for i in range(model["depth"]):
        b = f"blocks.{i}"
        spec += [(f"{b}.norm1.weight", (D,), "ln_weight"),
                 (f"{b}.norm1.bias", (D,), "ln_bias"),
                 (f"{b}.attn.qkv.weight", (3 * D, D), "weight"),
                 (f"{b}.attn.proj.weight", (D, D), "weight"),
                 (f"{b}.attn.proj.bias", (D,), "bias"),
                 (f"{b}.norm2.weight", (D,), "ln_weight"),
                 (f"{b}.norm2.bias", (D,), "ln_bias"),
                 (f"{b}.mlp.fc1.weight", (H, D), "weight"),
                 (f"{b}.mlp.fc1.bias", (H,), "bias"),
                 (f"{b}.mlp.fc2.weight", (D, H), "weight"),
                 (f"{b}.mlp.fc2.bias", (D,), "bias")]
    spec += [("norm.weight", (D,), "ln_weight"),
             ("norm.bias", (D,), "ln_bias"),
             ("feature.0.weight", (D, N * D), "weight")]
    bn_spec(spec, "feature.1", D)
    spec.append(("feature.2.weight", (model["emd_size"], D), "weight"))
    bn_spec(spec, "feature.3", model["emd_size"])
    return spec


def layer_norm(x, p, prefix: str):
    return F.layer_norm(x, x.shape[-1:], p[f"{prefix}.weight"],
                        p[f"{prefix}.bias"], EPS_LN)


def feature_bn(x, p, prefix: str, train: bool):
    if train:
        return F.batch_norm(x, None, None, p[f"{prefix}.weight"],
                            p[f"{prefix}.bias"], True, 0.0, EPS_FEATURE_BN)
    return F.batch_norm(x, p[f"{prefix}.running_mean"],
                        p[f"{prefix}.running_var"], p[f"{prefix}.weight"],
                        p[f"{prefix}.bias"], False, 0.0, EPS_FEATURE_BN)


def attention(x, p, a: str, heads: int, q):
    B, L, D = x.shape
    qkv = linear(x, p[f"{a}.qkv.weight"], None, q)
    qkv = qkv.reshape(B, L, 3, heads, D // heads).permute(2, 0, 3, 1, 4)
    qa = getattr(q, "attention", q)   # the attention's own rounding, if any
    s = (qa(qkv[0]) @ qa(qkv[1]).transpose(-1, -2)) * (D // heads) ** -0.5
    out = qa(torch.softmax(s, dim=-1)) @ qa(qkv[2])
    out = out.transpose(1, 2).reshape(B, L, D)
    return linear(out, p[f"{a}.proj.weight"], p[f"{a}.proj.bias"], q)


def blocks(model: dict, p, x, draws: Optional[torch.Tensor], q):
    """x (b, L, D) through every block. ``draws`` (sites, b, 1, 1): each
    branch's keep draw, block by block, attention's before the MLP's, for
    the blocks whose rate is not 0; None in evaluation."""
    site = 0
    for i, rate in enumerate(drop_rates(model)):
        b = f"blocks.{i}"
        for branch in ("attn", "mlp"):
            if branch == "attn":
                y = attention(layer_norm(x, p, f"{b}.norm1"), p, f"{b}.attn",
                              model["heads"], q)
            else:
                h = linear(layer_norm(x, p, f"{b}.norm2"),
                           p[f"{b}.mlp.fc1.weight"], p[f"{b}.mlp.fc1.bias"],
                           q)
                y = linear(F.relu6(h), p[f"{b}.mlp.fc2.weight"],
                           p[f"{b}.mlp.fc2.bias"], q)
            if draws is not None and rate > 0:
                keep = 1.0 - rate
                y = torch.where(draws[site] < keep, y / keep,
                                torch.zeros_like(y))
                site += 1
            x = x + y
    return x


def forward(model: dict, p, images, train: bool, gen, q):
    x = images.float().permute(0, 3, 1, 2)
    x = F.conv2d(q(x), q(p["patch_embed.proj.weight"]),
                 p["patch_embed.proj.bias"], model["patch"])
    x = x.flatten(2).transpose(1, 2) + p["pos_embed"]
    B, N, D = x.shape
    draws = None
    masked = train and model["mask_ratio"] > 0
    if masked:
        dev = x.device
        noise = torch.rand((B, N), generator=gen, device=dev)
        shuffle = torch.argsort(noise, dim=1, stable=True)
        restore = torch.argsort(shuffle, dim=1, stable=True)
        x = torch.gather(x, 1, shuffle[:, :kept_tokens(model), None]
                         .expand(-1, -1, D))
    sites = 2 * sum(r > 0 for r in drop_rates(model))
    if train and sites:
        draws = torch.stack([torch.rand((B, 1, 1), generator=gen,
                                        device=x.device)
                             for _ in range(sites)])
    chunk = model.get("reference_chunk", B)
    if train and chunk < B and torch.is_grad_enabled():
        x = torch.cat([
            checkpoint(blocks, model, p, x[a:a + chunk],
                       None if draws is None else draws[:, a:a + chunk], q,
                       use_reentrant=False, preserve_rng_state=False)
            for a in range(0, B, chunk)])
    else:
        x = blocks(model, p, x, draws, q)
    x = layer_norm(x, p, "norm")
    if masked:
        fill = p["mask_token"].expand(B, N - x.shape[1], D)
        x = torch.gather(torch.cat([x, fill], 1), 1,
                         restore[:, :, None].expand(-1, -1, D))
    x = linear(x.reshape(B, N * D), p["feature.0.weight"], None, q)
    x = feature_bn(x, p, "feature.1", train)
    x = linear(x, p["feature.2.weight"], None, q)
    return feature_bn(x, p, "feature.3", train)
