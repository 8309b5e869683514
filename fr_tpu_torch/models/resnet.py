"""IR-style face-recognition ResNet (counterpart of fr_tpu/models/resnet.py).

Module names follow the reference state-dict naming that
fr_tpu/utils/torch_export.py writes (conv1, bn1, layer{s}.{i}.conv1/bn1/
conv2/bn2/downsample.{0,1}, bn2, fc, bn3), so a converted fr_tpu encoder
loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from fr_tpu_torch.models.common import (BatchNorm1d, BatchNorm2d, Conv, Dense,
                                        max_pool_3x3_s2)


class BasicBlock(nn.Module):
    """IR BasicBlock: conv3x3(in→in) → BN → ReLU → conv3x3(in→out, stride)
    → BN, plus identity or conv1x1(stride)+BN shortcut, no output ReLU."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(inplanes, inplanes, 3, 1, compute_dtype)
        self.bn1 = BatchNorm2d(inplanes)
        self.conv2 = Conv(inplanes, planes, 3, stride, compute_dtype)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                Conv(inplanes, planes, 1, stride, compute_dtype),
                BatchNorm2d(planes))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return out + residual


class ResNet(nn.Module):
    """Face-embedding ResNet; forward takes NHWC images. It draws no random
    numbers; ``generator`` is accepted for the encoders' common call."""

    def __init__(self, layers: Sequence[int], emd_size: int = 512,
                 img_size: int = 112,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = Conv(3, 64, 3, 1, compute_dtype)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for si, (planes, blocks, stride) in enumerate(
                zip((64, 128, 256, emd_size), layers, (1, 2, 2, 2)), start=1):
            mods = [BasicBlock(inplanes, planes, stride, compute_dtype)]
            mods += [BasicBlock(planes, planes, 1, compute_dtype)
                     for _ in range(1, blocks)]
            setattr(self, f"layer{si}", nn.Sequential(*mods))
            inplanes = planes
        self.bn2 = BatchNorm2d(emd_size)
        side = img_size // 16   # maxpool /2, then strides 1,2,2,2
        self.fc = Dense(emd_size * side * side, emd_size)
        self.bn3 = BatchNorm1d(emd_size)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        for si in range(1, 5):
            x = getattr(self, f"layer{si}")(x)
        x = self.bn2(x).float()
        # NCHW flatten order, as fr_tpu transposes before its Dense
        return self.bn3(self.fc(x.flatten(1)))


RESNET_LAYERS = {
    "ResNet18": (2, 2, 2, 2),
    "ResNet34": (3, 4, 6, 4),
    "ResNet50": (3, 4, 14, 4),
    "ResNet100": (3, 13, 30, 4),
    "ResNet200": (3, 43, 50, 4),
}


def build_resnet(conf) -> ResNet:
    dtype = torch.bfloat16 if conf.get("mixed_precision", False) \
        else torch.float32
    return ResNet(RESNET_LAYERS[conf.network], emd_size=conf.emd_size,
                  img_size=conf.img_size, compute_dtype=dtype)
