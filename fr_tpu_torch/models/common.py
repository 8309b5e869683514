"""Shared layers and initialisers (counterpart of fr_tpu/models/common.py).

Layout: the layers take NCHW tensors. The encoders' public forward takes
NHWC images like fr_tpu and permutes them (``permute(0, 3, 1, 2)``) into NCHW
views with channels_last memory, so no copy is made and cuDNN runs its NHWC
kernels.

Mixed precision follows each fr_tpu layer's own ``dtype`` rather than
``torch.autocast``: a layer casts its input and its f32 weights to its
compute dtype on every call. BatchNorm's statistics and affine arithmetic
are f32 and its output is rounded to its input's dtype
(fr_tpu/models/common.py:61-81); on the card the f32 values live only in
the kernel's registers (ops/batch_norm.py).

Initialisation matches fr_tpu: Xavier-normal (untruncated) conv and dense
weights, zero biases, BN gamma 1 and beta 0; a module with an ``init_std``
attribute (EffiAlterNet's convs and dense layers) draws its weight from
fr_tpu's truncated normal of that standard deviation instead.

Randomness in training (dropout, stochastic depth) draws from an explicit
``torch.Generator`` that the caller passes down; nothing here touches the
global RNG.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fr_tpu_torch.ops.batch_norm import batch_norm


class Conv(nn.Conv2d):
    """Conv with torch padding (k-1)//2, bias-free unless asked; ``groups``
    as torch's (the depthwise convs of EffiAlterNet). A bias is added after
    the product is rounded to the compute dtype, as flax's Conv does."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, compute_dtype: torch.dtype = torch.float32,
                 bias: bool = False, groups: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=(kernel - 1) // 2, bias=bias, groups=groups)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        cd = self.compute_dtype
        y = F.conv2d(x.to(cd), self.weight.to(cd), None, self.stride,
                     self.padding, 1, self.groups)
        return y if self.bias is None else y + self.bias.to(cd)[:, None, None]


class _FlaxBatchNorm:
    """flax BatchNorm semantics (fr_tpu/models/common.py:61-81): eps 1e-5,
    running statistics updated as 0.9·old + 0.1·batch with the biased batch
    variance, statistics and affine math in f32 whatever the input dtype,
    output in the input's dtype. ops/batch_norm.py computes it: the plain
    version on the CPU, the kernels on the card."""

    def forward(self, x):
        return batch_norm(x, self.running_mean, self.running_var,
                          self.weight, self.bias, self.num_batches_tracked,
                          self.training, self.momentum, self.eps)


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """torch layout and defaults (eps 1e-5, momentum 0.1 = flax 0.9)."""


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    """The embedding head's BN1d."""


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: keep each element with probability
    1 − rate and scale the kept ones by 1/(1 − rate)."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs an explicit "
                         "torch.Generator (the port uses no global RNG)")
    keep = 1.0 - rate
    draw = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(draw < keep, x / keep, torch.zeros_like(x))


class Dense(nn.Linear):
    """Linear layer in its compute dtype: the product is rounded to that
    dtype before the bias is added, as flax's Dense does."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        cd = self.compute_dtype
        y = F.linear(x.to(cd), self.weight.to(cd))
        return y if self.bias is None else y + self.bias.to(cd)


def max_pool_3x3_s2(x):
    """torch MaxPool2d(3, stride 2, padding 1); padding never wins."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    """x·rsqrt(max(Σx², eps²)): F.normalize's values with a finite gradient
    at x = 0 (fr_tpu/models/common.py:116-124)."""
    sum_sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp_min(sum_sq, eps * eps))


def xavier_std(shape) -> float:
    """sqrt(2 / (fan_in + fan_out)) of a torch-layout (out, in, *kernel)
    weight: torch's xavier_normal_ and flax's fan_avg variance scaling."""
    receptive = math.prod(shape[2:])
    return math.sqrt(2.0 / ((shape[0] + shape[1]) * receptive))


# jax.nn.initializers.truncated_normal draws from N(0, 1) cut at ±2 and
# divides by this, the standard deviation of that cut normal, so that the
# result has the standard deviation asked for
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_weights(module: nn.Module, seed: int = 0) -> nn.Module:
    """fr_tpu's initialisation from a seeded CPU generator: Xavier-normal
    conv and linear weights, or fr_tpu's truncated normal (cut at ±2σ)
    where the module has an ``init_std``; zero conv and linear biases.
    BatchNorm and the attention parameters keep the values their
    constructors set (gamma 1, beta 0, q/v bias 0, logit_scale ln 10,
    temperature 1). A module with an ``init_params(generator)`` method
    draws every parameter under it itself, from the same generator, in
    place of this pass (the ViT: insightface's initialisation). Call
    before moving to a device."""
    gen = torch.Generator().manual_seed(seed)
    owners = [m for m in module.modules() if hasattr(m, "init_params")]
    owned = {id(sub) for m in owners for sub in m.modules()}
    for m in module.modules():
        if id(m) in owned:
            continue
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = getattr(m, "init_std", None)
            if std is None:
                m.weight.normal_(0.0, xavier_std(m.weight.shape),
                                 generator=gen)
            else:
                nn.init.trunc_normal_(m.weight, 0.0, 1.0, -2.0, 2.0,
                                      generator=gen)
                m.weight.mul_(std / _TRUNC_STD)
            if m.bias is not None:
                m.bias.zero_()
    for m in owners:
        m.init_params(gen)
    return module
