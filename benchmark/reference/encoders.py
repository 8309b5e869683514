"""Plain float32 encoders of the benchmark's configurations: the layers that
families share, and the lookup of a configuration's family by name.

A family is a file, ``benchmark/reference/families/<kind>.py``, named by a
configuration's ``model.kind``. It defines

- ``param_spec(model)``: every parameter of the encoder, as
  (name, shape, kind), in the order ``inputs.encoder_params`` draws them,
  with the names of the reference checkpoints (``conv1``,
  ``layer{s}.{i}.conv1``, ``attn.qkv``, ...);
- ``forward(model, p, images, train, gen, q)``: NHWC float images →
  (B, emd_size) embeddings (not normalised);
- optionally ``INIT``, {kind: fn(z, shape) → tensor}, the draw of each
  parameter kind it adds to those ``inputs.py`` knows (``weight``,
  ``bias``, ``bn_weight``, ``bn_bias``, ``logit_scale``): ``z`` is the
  parameter's share of the one N(0, 1) draw, already in ``shape``.

Every BatchNorm's scale is of the kind ``bn_weight``; its running
statistics follow it (``bn_stat_names``).

Everything is a function of a parameter dict and NCHW float32 tensors.
Every product (convolutions, linear layers, attention's two products)
passes both operands through ``q`` first: the identity for the reference,
a rounding to a lower precision for the control. A ``q`` with an
``attention`` attribute rounds the attention's two products by that one
instead. BatchNorm in training uses the batch's biased statistics; in
evaluation the running ones (eps 1e-5). Dropout and DropPath draw from the
generator handed in, in the forward's order, one ``torch.rand`` per site.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import by_file

Params = Dict[str, torch.Tensor]
Quant = Callable[[torch.Tensor], torch.Tensor]
EPS_BN = 1e-5


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


# ---------------------------------------------------------------------------
# The family of a configuration, by name
# ---------------------------------------------------------------------------

def family(model: dict):
    """The module ``families/<model.kind>.py``; a kind with no such file
    raises BenchError naming it."""
    return by_file("families", model["kind"])


def param_spec(model: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every parameter of the encoder: (name, shape, kind)."""
    return family(model).param_spec(model)


def bn_stat_names(model: dict) -> List[Tuple[str, int]]:
    """(BN prefix, channels) of every BatchNorm, for the running
    statistics."""
    return [(n[:-len(".weight")], shape[0])
            for n, shape, kind in param_spec(model) if kind == "bn_weight"]


def forward(model: dict, p: Params, images, train: bool,
            gen: Optional[torch.Generator] = None, q: Quant = identity):
    """NHWC float images → (B, emd_size) embeddings (not normalised)."""
    return family(model).forward(model, p, images, train, gen, q)


# ---------------------------------------------------------------------------
# Layouts that families share
# ---------------------------------------------------------------------------

def bn_spec(spec, prefix: str, ch: int) -> None:
    spec.append((f"{prefix}.weight", (ch,), "bn_weight"))
    spec.append((f"{prefix}.bias", (ch,), "bn_bias"))


def basic_spec(spec, prefix: str, cin: int, cout: int, stride: int) -> None:
    """An IR BasicBlock's parameters: conv3x3 → BN → conv3x3(stride) → BN,
    and a conv1x1(stride) + BN shortcut where the shape changes."""
    spec.append((f"{prefix}.conv1.weight", (cin, cin, 3, 3), "weight"))
    bn_spec(spec, f"{prefix}.bn1", cin)
    spec.append((f"{prefix}.conv2.weight", (cout, cin, 3, 3), "weight"))
    bn_spec(spec, f"{prefix}.bn2", cout)
    if stride != 1 or cin != cout:
        spec.append((f"{prefix}.downsample.0.weight", (cout, cin, 1, 1),
                     "weight"))
        bn_spec(spec, f"{prefix}.downsample.1", cout)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def batch_norm(x, p: Params, prefix: str, train: bool):
    if train:
        return F.batch_norm(x, None, None, p[f"{prefix}.weight"],
                            p[f"{prefix}.bias"], True, 0.0, EPS_BN)
    return F.batch_norm(x, p[f"{prefix}.running_mean"],
                        p[f"{prefix}.running_var"], p[f"{prefix}.weight"],
                        p[f"{prefix}.bias"], False, 0.0, EPS_BN)


def conv(x, w, stride: int, q: Quant):
    return F.conv2d(q(x), q(w), None, stride, (w.shape[-1] - 1) // 2)


def linear(x, w, b, q: Quant):
    y = q(x) @ q(w).t()
    return y if b is None else y + b


def basic_block(x, p, prefix, stride, train, q):
    """An IR BasicBlock (no output ReLU)."""
    out = F.relu(batch_norm(conv(x, p[f"{prefix}.conv1.weight"], 1, q), p,
                            f"{prefix}.bn1", train))
    out = batch_norm(conv(out, p[f"{prefix}.conv2.weight"], stride, q), p,
                     f"{prefix}.bn2", train)
    if f"{prefix}.downsample.0.weight" in p:
        x = batch_norm(conv(x, p[f"{prefix}.downsample.0.weight"], stride,
                            q), p, f"{prefix}.downsample.1", train)
    return out + x


def unit(x):
    return x * torch.rsqrt(torch.clamp_min(torch.sum(x * x, -1, keepdim=True),
                                           1e-24))


def keep_or_drop(x, rate: float, shape, gen):
    keep = 1.0 - rate
    draw = torch.rand(shape, generator=gen, device=x.device)
    return torch.where(draw < keep, x / keep, torch.zeros_like(x))
