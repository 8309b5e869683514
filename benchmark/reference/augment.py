"""The train-time augmentation in plain float32 PyTorch, a frozen copy of
the program's on-device augmentation as it stands when the benchmark was
defined:

    RandomGamma(80-120, p=.5) → MotionBlur(p=.5) → ISONoise(p=.5) →
    HorizontalFlip(p=.5) → Normalize(mean .5, std .5) →
    CoarseDropout(1 hole of exactly 20×20, p=.5)

``draw_augment`` takes every random number of one batch from a generator
in a fixed order; ``apply_augment`` is a pure function of the images and
the draws. ``cfg`` is the tuple (gamma_lo, gamma_hi, gamma_p, blur_p,
c_shift_lo, c_shift_hi, int_lo, int_hi, iso_p, flip_p, erase_p,
erase_max_h, erase_max_w) that ``cfg_from_config`` builds from a
configuration file's ``augmentation``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

BLUR_SIZES = (3, 5, 7)
Draws = Dict[str, torch.Tensor]


def draw_augment(cfg: Tuple, shape, generator: torch.Generator,
                 device) -> Draws:
    """Every random number one batch of shape (B, H, W, 3) needs, in the
    shapes apply_augment takes them."""
    (g_lo, g_hi, _, _, cs_lo, cs_hi, in_lo, in_hi, _, _, _, emax_h,
     emax_w) = cfg
    B, H, W = shape[0], shape[1], shape[2]

    def uniform(*size, lo=0.0, hi=1.0):
        u = torch.rand(size, generator=generator, device=device)
        return lo + (hi - lo) * u

    def randint(hi, *size):
        return torch.randint(0, hi, size, generator=generator, device=device)

    return {
        "gamma": uniform(B, lo=g_lo, hi=g_hi) / 100.0,
        "gamma_u": uniform(B),
        "blur_u": uniform(B),
        "blur_angle": uniform(B, lo=0.0, hi=math.pi),
        "blur_size": randint(len(BLUR_SIZES), B),
        "color_shift": uniform(B, lo=cs_lo, hi=cs_hi),
        "intensity": uniform(B, lo=in_lo, hi=in_hi),
        "lum_noise": torch.randn((B, H, W), generator=generator,
                                 device=device),
        "hue_noise": torch.randn((B, H, W), generator=generator,
                                 device=device),
        "iso_u": uniform(B),
        "flip_u": uniform(B),
        "erase_y0": randint(max(H - emax_h, 1), B),
        "erase_x0": randint(max(W - emax_w, 1), B),
        "erase_u": uniform(B),
    }


def _rgb_to_hls(rgb):
    """RGB → HLS (cv2 convention: H in [0, 360), L and S in [0, 1])."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    l = (maxc + minc) / 2.0
    c = maxc - minc
    safe_c = torch.where(c > 0, c, 1.0)
    rc = (maxc - r) / safe_c
    gc = (maxc - g) / safe_c
    bc = (maxc - b) / safe_c
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(c > 0, torch.remainder(h / 6.0, 1.0), 0.0) * 360.0
    denom = 1.0 - torch.abs(2.0 * l - 1.0)
    s = torch.where(c > 0, c / torch.where(denom > 0, denom, 1.0), 0.0)
    return h, l, s


def _select(conds, choices, default):
    """jnp.select: the choice of the first true condition, else default."""
    out = default
    for cond, choice in zip(reversed(conds), reversed(choices)):
        out = torch.where(cond, choice, out)
    return out


def _hls_to_rgb(h, l, s):
    h = torch.remainder(h, 360.0) / 360.0
    c = (1.0 - torch.abs(2.0 * l - 1.0)) * s
    hp = h * 6.0
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    z = torch.zeros_like(c)
    conds = [hp < 1, hp < 2, hp < 3, hp < 4, hp < 5]
    r1 = _select(conds, [c, x, z, z, x], c)
    g1 = _select(conds, [x, c, c, x, z], z)
    b1 = _select(conds, [z, z, x, c, c], x)
    m = l - c / 2.0
    return torch.stack([r1 + m, g1 + m, b1 + m], dim=-1)


def _motion_blur(x, angle, size_idx):
    """Per-sample random-angle line blur: one depthwise 7×7 convolution for
    the whole batch, each kernel masked to its k×k centre, k in 3, 5, 7."""
    B, H, W, C = x.shape
    kmax = BLUR_SIZES[-1]
    r = (kmax - 1) / 2.0
    ar = torch.arange(kmax, dtype=torch.float32, device=x.device) - r
    yy, xx = ar[None, :, None], ar[None, None, :]
    angle = angle[:, None, None]
    d = torch.abs(-torch.sin(angle) * xx + torch.cos(angle) * yy)
    ks = torch.tensor(BLUR_SIZES, device=x.device)[size_idx]
    half = torch.div(ks - 1, 2, rounding_mode="floor").float()[:, None, None]
    inside = (torch.abs(yy) <= half) & (torch.abs(xx) <= half)
    kern = ((d <= 0.5) & inside).float()
    kern = kern / torch.clamp_min(kern.sum(dim=(1, 2), keepdim=True), 1.0)
    filt = kern.repeat_interleave(C, dim=0)[:, None]          # (B·C, 1, 7, 7)
    xt = x.permute(0, 3, 1, 2).reshape(1, B * C, H, W)
    out = F.conv2d(xt, filt, padding=kmax // 2, groups=B * C)
    return out.reshape(B, C, H, W).permute(0, 2, 3, 1)


def _iso_noise(img01, color_shift, intensity, lum_noise, hue_noise):
    h, l, s = _rgb_to_hls(img01)
    stddev = torch.std(l, dim=(1, 2), keepdim=True, unbiased=False)
    lam = torch.clamp_min(stddev * intensity[:, None, None] * 255.0, 1e-6)
    lum = torch.clamp_min(lam + torch.sqrt(lam) * lum_noise, 0.0)
    h = h + hue_noise * (color_shift * 360.0 * intensity)[:, None, None]
    l = l + (lum / 255.0) * (1.0 - l)
    out = _hls_to_rgb(h, torch.clamp(l, 0.0, 1.0), s)
    return torch.clamp(out, 0.0, 1.0)


def apply_augment(images_u8: torch.Tensor, draws: Draws,
                  cfg: Tuple) -> torch.Tensor:
    """uint8 (B, H, W, 3) → normalised f32 (B, H, W, 3) under the draws."""
    (_, _, g_p, blur_p, _, _, _, _, iso_p, flip_p, erase_p, emax_h,
     emax_w) = cfg
    B, H, W, _ = images_u8.shape
    per_img = lambda u, p: (u < p)[:, None, None, None]   # noqa: E731
    x = images_u8.float() / 255.0
    gamma = draws["gamma"][:, None, None, None]
    x = torch.where(per_img(draws["gamma_u"], g_p),
                    torch.pow(torch.clamp_min(x, 1e-8), gamma), x)
    x = torch.where(per_img(draws["blur_u"], blur_p),
                    _motion_blur(x, draws["blur_angle"], draws["blur_size"]),
                    x)
    noised = _iso_noise(x, draws["color_shift"], draws["intensity"],
                        draws["lum_noise"], draws["hue_noise"])
    x = torch.where(per_img(draws["iso_u"], iso_p), noised, x)
    x = torch.where(per_img(draws["flip_u"], flip_p), torch.flip(x, [2]), x)
    x = (x - 0.5) / 0.5
    yy = torch.arange(H, device=x.device)[None, :, None]
    xx = torch.arange(W, device=x.device)[None, None, :]
    y0 = draws["erase_y0"][:, None, None]
    x0 = draws["erase_x0"][:, None, None]
    hole = ((yy >= y0) & (yy < y0 + emax_h) & (xx >= x0) & (xx < x0 + emax_w)
            & (draws["erase_u"] < erase_p)[:, None, None])
    return torch.where(hole[..., None], 0.0, x)


def cfg_from_config(aug: dict) -> Tuple:
    """The cfg tuple from a configuration file's ``augmentation``."""
    return (float(aug["gamma"][0]), float(aug["gamma"][1]),
            float(aug["gamma_p"]), float(aug["blur_p"]),
            float(aug["color_shift"][0]), float(aug["color_shift"][1]),
            float(aug["intensity"][0]), float(aug["intensity"][1]),
            float(aug["iso_p"]), float(aug["flip_p"]), float(aug["erase_p"]),
            int(aug["erase_h"]), int(aug["erase_w"]))
