"""The inputs of a run, all made from ``--seed``: the encoder's weights and
BatchNorm statistics, the class table, the training corpus and its labels,
the embedding cell's images. The program and the reference are handed the
same ones.

Weights are drawn on the device from one ``torch.Generator`` in one large
N(0, 1) call and shaped per parameter, in the order of the family's
``param_spec`` (``reference/encoders.py``), each drawn by its kind: conv
and linear weights Xavier-normal as the program initialises them, biases
N(0, 0.02²), BN scales 1 + N(0, 0.1²) and shifts N(0, 0.1²), SwinV2's
logit scales ln 10 + N(0, 0.1²), and any kind a family adds by its own
``INIT``. The running means of every BatchNorm follow, N(0, 0.1²), and its
variances exp(N(0, 0.2²)). The class table is N(0, 0.01²), as the
program's own. The corpus is uniform uint8 noise from numpy's PCG64 and
its labels uniform over the classes.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from benchmark.harness import BenchError
from benchmark.reference.encoders import bn_stat_names, family, param_spec

# sub-streams of one seed
STREAMS = {"encoder": 1, "head": 2, "corpus": 3, "embed": 4, "sample": 5}


def sub_seed(seed: int, stream: str) -> int:
    return (int(seed) * 16 + STREAMS[stream]) % (1 << 63)


def xavier_std(shape) -> float:
    return math.sqrt(2.0 / ((shape[0] + shape[1]) * math.prod(shape[2:])))


# the draw of each parameter kind from its share z of the N(0, 1) call
KINDS = {"weight": lambda z, shape: z * xavier_std(shape),
         "bias": lambda z, shape: z * 0.02,
         "bn_weight": lambda z, shape: 1.0 + 0.1 * z,
         "bn_bias": lambda z, shape: 0.1 * z,
         "logit_scale": lambda z, shape: math.log(10.0) + 0.1 * z}


def kinds(model: dict) -> dict:
    """KINDS and those the model's family adds by its ``INIT``; a family
    may not draw a known kind otherwise."""
    own = getattr(family(model), "INIT", {})
    clash = sorted(set(own) & set(KINDS))
    if clash:
        raise BenchError(f"the family {model['kind']!r} redraws the kinds "
                         f"{clash}")
    return {**KINDS, **own}


@torch.no_grad()
def encoder_params(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor} of every parameter and BN running statistic."""
    spec = param_spec(model)
    stats = bn_stat_names(model)
    draw = kinds(model)
    total = sum(math.prod(s) for _, s, _ in spec) + 2 * sum(
        c for _, c in stats)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              "encoder"))
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        if kind not in draw:
            raise BenchError(f"{name}: no draw of the parameter kind "
                             f"{kind!r}")
        out[name] = draw[kind](z[at:at + n].view(shape), shape).contiguous()
        at += n
    for prefix, c in stats:
        out[f"{prefix}.running_mean"] = 0.1 * z[at:at + c]
        out[f"{prefix}.running_var"] = torch.exp(0.2 * z[at + c:at + 2 * c])
        at += 2 * c
    return out


@torch.no_grad()
def class_table(head: dict, seed: int, device) -> torch.Tensor:
    """(padded_classes, emd) f32, N(0, 0.01²)."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "head"))
    return 0.01 * torch.randn((head["padded_classes"], head["emd_size"]),
                              generator=gen, device=device)


def corpus(n: int, img_size: int, num_classes: int, seed: int):
    """(uint8 images (n, H, W, 3), int64 labels (n,)) on the host."""
    rng = np.random.default_rng([int(seed), STREAMS["corpus"]])
    images = np.frombuffer(rng.bytes(n * img_size * img_size * 3),
                           np.uint8).reshape(n, img_size, img_size, 3)
    labels = rng.integers(0, num_classes, n, dtype=np.int64)
    return images, labels


def embed_images(n_batches: int, batch: int, img_size: int, seed: int,
                 device) -> torch.Tensor:
    """(n_batches, batch, H, W, 3) f32 in [−1, 1], normalised as the
    evaluation sets are, drawn on the device and held in pinned host
    memory."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "embed"))
    x = torch.rand((n_batches, batch, img_size, img_size, 3), generator=gen,
                   device=device) * 2.0 - 1.0
    host = torch.empty(x.shape, dtype=torch.float32,
                       pin_memory=torch.device(device).type == "cuda")
    host.copy_(x)
    return host
