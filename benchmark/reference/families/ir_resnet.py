"""The IR ResNet of face recognition (insightface's iresnet at 112 px): stem
conv3x3 → BN → ReLU → max-pool 3/2, four stages of BasicBlocks (conv3x3 →
BN → ReLU → conv3x3(stride) → BN, plus an identity or conv1x1(stride) + BN
shortcut, no output ReLU), then BN → flatten (NCHW order) → Linear → BN1d.

``model``: ``blocks`` and ``widths`` per stage, ``emd_size``, ``img_size``,
``stem_stride`` and ``pool`` (the last map's side)."""

from __future__ import annotations

from typing import List, Tuple

import torch.nn.functional as F

from benchmark.reference.encoders import (basic_block, basic_spec,
                                          batch_norm, bn_spec, conv, linear)


def stage_plan(model: dict) -> List[List[Tuple[int, int, int]]]:
    """Per stage, its BasicBlocks' (cin, cout, stride)."""
    plan, cin = [], model["widths"][0]
    for s, (w, n) in enumerate(zip(model["widths"], model["blocks"])):
        plan.append([(cin, w, 1 if s == 0 else 2)] + [(w, w, 1)] * (n - 1))
        cin = w
    return plan


def param_spec(model: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    spec: list = [("conv1.weight", (model["widths"][0], 3, 3, 3), "weight")]
    bn_spec(spec, "bn1", model["widths"][0])
    for s, stage in enumerate(stage_plan(model), start=1):
        for i, blk in enumerate(stage):
            basic_spec(spec, f"layer{s}.{i}", *blk)
    emd = model["emd_size"]
    bn_spec(spec, "bn2", emd)
    spec += [("fc.weight", (emd, emd * model["pool"] ** 2), "weight"),
             ("fc.bias", (emd,), "bias")]
    bn_spec(spec, "bn3", emd)
    return spec


def forward(model: dict, p, images, train: bool, gen, q):
    x = images.float().permute(0, 3, 1, 2)
    x = conv(x, p["conv1.weight"], model["stem_stride"], q)
    x = F.max_pool2d(F.relu(batch_norm(x, p, "bn1", train)), 3, 2, 1)
    for s, stage in enumerate(stage_plan(model), start=1):
        for i, (_, _, stride) in enumerate(stage):
            x = basic_block(x, p, f"layer{s}.{i}", stride, train, q)
    x = batch_norm(x, p, "bn2", train)
    x = linear(x.flatten(1), p["fc.weight"], p["fc.bias"], q)
    return batch_norm(x, p, "bn3", train)
