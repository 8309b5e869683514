"""Seeded full-width weights, images and training runs: how a card without
jax is held to fr_tpu at the full width of AlterNet50, Swin50, EffiAlter_m
and ResNet100.

``seeded_state_dict`` draws every reference-named state-dict key of a port
encoder from a numpy seed, in state-dict order. fr_tpu takes the same dict
through ``fr_tpu.utils.torch_import.alternet_from_torch``; the port loads it
with ``load_state_dict``. tests/data/alternet50_golden.npz keeps the seed and
fr_tpu's f32 embeddings of ``golden_images(seed)``; tests/test_torch_alternet.py
regenerates it with jax and checks the port against it on the CPU, and
chip_smoke.py checks the card against it.

tests/data/swin50_golden.npz and effialter_m_golden.npz do the same at 112
px (``golden_encoder``; tests/test_torch_swin.py and
tests/test_torch_effialternet.py regenerate them), and
tests/data/resnet100_golden.npz for IR-ResNet100 (tests/test_torch_resnet100.py).
tests/data/alternetsep50_golden.npz and alternetv1_50_golden.npz hold
AlterNetSep50 and AlterNetV1_50 at 112 px; fr_tpu has no importer for them,
so tests/test_torch_alternet_variants.py carries the seeded dict into
fr_tpu's trees with the port's own weight table.

tests/data/alternet50_train_golden.npz keeps fr_tpu's two SGD steps of the
seeded AlterNet50 on ``train_golden_batches(seed)``: losses, gradient norms
and the norm of each tensor's update (``run_train_golden`` is the port's
side; tests/test_torch_train_golden.py regenerates the file with jax).
tests/data/swin50_train_golden.npz is the same for Swin50 at 112 px, head
dropout off (tests/test_torch_swin_train.py regenerates it).
tests/data/resnet100_train_golden.npz is two SGD steps of ResNet100 at 112 px
under a block-sampled head (``BLOCK_GOLDEN``: 1,000 classes in groups of 4,
half of them drawn per step); the file also keeps the groups fr_tpu drew
(``gidx``), which ``run_train_golden`` feeds to the port's step
(tests/test_torch_resnet100.py regenerates it).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from fr_tpu_torch.configs.base import default_img_size
from fr_tpu_torch.models.common import xavier_std

# the training goldens: full-width AlterNet50 (192 px) or Swin50 (112 px),
# f32, 4 images of 2 synthetic identities per step, 1,000 classes, every
# class active, SGD, drop rates 0
TRAIN_GOLDEN = dict(emd_size=512, n_classes=1000, batch=4, steps=2, lr=1e-4)
# ResNet100's training golden: the head samples sample_rate of the classes
# in aligned groups of sample_block rows (125 groups of 4 per step)
BLOCK_GOLDEN = dict(sample_rate=0.5, sample_block=4)

# buffers that are functions of the architecture, kept as the model made them
_FIXED = ("num_batches_tracked", "relative_coords_table",
          "relative_position_index", "attn_mask")


def seeded_state_dict(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Xavier-scaled weights, BN gamma in [0.8, 1.2], running_var in
    [0.5, 1.5], small biases and running means, logit scales ln[5, 20]."""
    rng = np.random.default_rng(seed)
    modules = dict(model.named_modules())
    sd: Dict[str, torch.Tensor] = {}
    for key, ref in model.state_dict().items():
        prefix, leaf = key.rsplit(".", 1)
        shape = tuple(ref.shape)
        if leaf in _FIXED:
            sd[key] = ref.clone()
            continue
        if isinstance(modules[prefix], (nn.BatchNorm1d, nn.BatchNorm2d)):
            lo, hi = {"weight": (0.8, 1.2), "bias": (-0.1, 0.1),
                      "running_mean": (-0.1, 0.1),
                      "running_var": (0.5, 1.5)}[leaf]
            arr = rng.uniform(lo, hi, shape)
        elif leaf == "logit_scale":
            arr = np.log(rng.uniform(5.0, 20.0, shape))
        elif leaf == "temperature":
            arr = rng.uniform(0.5, 1.5, shape)
        elif leaf == "pos_embedding":
            arr = 0.02 * rng.standard_normal(shape)
        elif leaf in ("bias", "q_bias", "v_bias"):
            arr = rng.uniform(-0.1, 0.1, shape)
        elif leaf == "weight":
            arr = rng.standard_normal(shape) * xavier_std(shape)
        else:
            raise KeyError(f"no recipe for state-dict key {key}")
        sd[key] = torch.from_numpy(arr.astype(np.float32))
    return sd


def golden_images(seed: int, n: int = 4, img_size: int = 192) -> np.ndarray:
    """(n, img_size, img_size, 3) f32 normalised-range NHWC images."""
    rng = np.random.default_rng(seed + 1)
    return rng.standard_normal((n, img_size, img_size, 3)).astype(np.float32)


def golden_encoder(network: str, dtype: torch.dtype = torch.float32,
                   train: bool = False) -> nn.Module:
    """The full-width port encoder of a golden: AlterNet50 at 192 px,
    Swin50, EffiAlter_m, ResNet100, AlterNetSep50 or AlterNetV1_50 at 112
    px, emd 512; ``train`` turns the drop rates to 0 (AlterNet's DropPath
    and head dropout, Swin's head dropout)."""
    from fr_tpu_torch.models.alternet import (ALTERNET_PLANS,
                                              ALTERNET_SEP_PLANS, AlterNet,
                                              AlterNetSep)
    from fr_tpu_torch.models.alternet_v1 import ALTERNET_V1_PLANS, AlterNetV1
    from fr_tpu_torch.models.effialternet import EFFIALTER_CFGS, EffNetV2
    from fr_tpu_torch.models.resnet import RESNET_LAYERS, ResNet
    from fr_tpu_torch.models.swinv2 import SWIN_PLANS, Swin

    size = default_img_size(network)
    if network == "AlterNet50":
        drop = dict(drop_path_rate=0.0, head_drop=0.0) if train else {}
        return AlterNet(*ALTERNET_PLANS[network], img_size=size,
                        emd_size=512, compute_dtype=dtype, **drop)
    if network == "Swin50":
        return Swin(*SWIN_PLANS[network], emd_size=512,
                    head_drop=0.0 if train else 0.5, compute_dtype=dtype)
    if network == "EffiAlter_m":
        return EffNetV2(EFFIALTER_CFGS[network], img_size=size, emd_size=512,
                        compute_dtype=dtype)
    if network == "ResNet100":
        return ResNet(RESNET_LAYERS[network], emd_size=512, img_size=size,
                      compute_dtype=dtype)
    if network == "AlterNetSep50":
        return AlterNetSep(*ALTERNET_SEP_PLANS[network], emd_size=512,
                           compute_dtype=dtype)
    if network == "AlterNetV1_50":
        # 112 px: at default_img_size's 192 it does not build (ROADMAP §3)
        return AlterNetV1(*ALTERNET_V1_PLANS[network], img_size=112,
                          emd_size=512, compute_dtype=dtype)
    raise ValueError(f"no golden for {network}")


def train_golden_conf(network: str = "AlterNet50"):
    """The training golden's configuration (SGD, ArcFace s=30 m=0.35, f32;
    sample_rate 1.0, or ``BLOCK_GOLDEN``'s sampling for ResNet100)."""
    from fr_tpu_torch.configs.base import Config

    sampling = BLOCK_GOLDEN if network == "ResNet100" else dict(
        sample_rate=1.0, sample_block=1)
    return Config(network=network, img_size=default_img_size(network),
                  emd_size=TRAIN_GOLDEN["emd_size"],
                  n_classes=TRAIN_GOLDEN["n_classes"], metric="ArcFace",
                  loss_s=30.0, loss_m=0.35, optimizer_name="SGD",
                  optimizer="SGD", wd=5e-4, mom=0.9, eps=1e-8,
                  betas=(0.9, 0.999), mixed_precision=False, **sampling)


def train_golden_batches(seed: int, img_size: int = 192
                         ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(images (4, img_size, img_size, 3) f32, labels (4,) int32) per step:
    two synthetic identities, template + noise."""
    rng = np.random.default_rng(seed + 2)
    size, n = img_size, TRAIN_GOLDEN["batch"]
    templates = rng.standard_normal((2, size, size, 3))
    classes = rng.choice(TRAIN_GOLDEN["n_classes"], 2, replace=False)
    out = []
    for _ in range(TRAIN_GOLDEN["steps"]):
        ident = np.arange(n) % 2
        images = templates[ident] + 0.3 * rng.standard_normal(
            (n, size, size, 3))
        out.append((images.astype(np.float32),
                    classes[ident].astype(np.int32)))
    return out


def train_golden_head(seed: int) -> np.ndarray:
    """The head weight (1000, 512) f32, N(0, 0.01)."""
    rng = np.random.default_rng(seed + 3)
    return (0.01 * rng.standard_normal(
        (TRAIN_GOLDEN["n_classes"], TRAIN_GOLDEN["emd_size"]))).astype(
            np.float32)


def run_train_golden(seed: int, device, network: str = "AlterNet50",
                     gidx: Optional[np.ndarray] = None
                     ) -> Dict[str, np.ndarray]:
    """The port's side of a training golden on ``device``: losses,
    grad_norms, and update_names / update_norms (‖after − before‖ of every
    encoder parameter by its state-dict name, then "head"). ``gidx``
    (steps, groups): the groups the golden's block-sampled head drew, one
    row per step."""
    from fr_tpu_torch.heads.partial_fc import PFCConfig, PFCState
    from fr_tpu_torch.train.state import (TrainState, init_encoder_slots,
                                          stream_generators)
    from fr_tpu_torch.train.step import make_train_step

    conf = train_golden_conf(network)
    model = golden_encoder(network, train=True)
    model.load_state_dict(seeded_state_dict(model, seed), strict=True)
    model.to(device)
    w0 = torch.from_numpy(train_golden_head(seed)).to(device)
    state = TrainState(step=0, encoder=model,
                       opt_slots=init_encoder_slots("SGD", model),
                       pfc=PFCState(weight=w0.clone(), slots={
                           "momentum": torch.zeros_like(w0)}),
                       generators=stream_generators(seed, device))
    cfg = PFCConfig(conf.n_classes, conf.emd_size, margin="ArcFace",
                    s=30.0, m=0.35, mixed_precision=False,
                    sample_rate=conf.sample_rate,
                    sample_block=conf.sample_block)
    if cfg.sampling and gidx is None:
        raise ValueError(f"the {network} golden samples its head: pass the "
                         f"groups stored in the golden file")
    step = make_train_step(conf, cfg, device)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses, norms = [], []
    for i, (images, labels) in enumerate(
            train_golden_batches(seed, conf.img_size)):
        m = step(state, images, labels, TRAIN_GOLDEN["lr"],
                 sample_gidx=gidx[i] if cfg.sampling else None)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    names = list(before) + ["head"]
    after = dict(model.named_parameters())
    updates = [float(torch.linalg.vector_norm(after[n].detach() - before[n]))
               for n in before]
    updates.append(float(torch.linalg.vector_norm(state.pfc.weight - w0)))
    return {"losses": np.array(losses), "grad_norms": np.array(norms),
            "update_names": np.array(names), "update_norms":
            np.array(updates)}
