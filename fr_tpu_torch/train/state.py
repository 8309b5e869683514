"""The training state (counterpart of fr_tpu/train/state.py): the encoder
module (parameters and BN running statistics), its optimizer slots, the
PartialFC head with its slots and step count, the step counter, and the
random-number generators of the training step.

The encoder's slots are keyed by parameter name, as
``encoder.named_parameters()`` gives them. The counters are host integers.
fr_tpu derives every random key from (key, step), so its state needs no
generator; torch's generators are stateful, and a checkpoint has to carry
their states for a resumed run to draw the same negatives, augmentations
and dropout masks (ckpt/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn as nn

from fr_tpu_torch.heads.partial_fc import PFCConfig, PFCState, init_pfc_state
from fr_tpu_torch.train.optim import init_slots

EncoderSlots = Dict[str, Dict[str, torch.Tensor]]
# fr_tpu's stream_key tags
STREAMS = {"sample": 0, "augment": 1, "dropout": 2}


def stream_generators(seed: int, device) -> Dict[str, torch.Generator]:
    """One generator per RNG stream (negative sampling, augmentation,
    dropout), seeded apart from each other."""
    return {name: torch.Generator(device=device).manual_seed(
        seed * len(STREAMS) + tag) for name, tag in STREAMS.items()}


@dataclasses.dataclass
class TrainState:
    step: int
    encoder: nn.Module
    opt_slots: EncoderSlots   # {"momentum": {param name: tensor}} etc.
    pfc: PFCState
    generators: Dict[str, torch.Generator]   # one per stream of STREAMS


def init_encoder_slots(optimizer: str, encoder: nn.Module) -> EncoderSlots:
    names, params = zip(*encoder.named_parameters())
    return {slot: dict(zip(names, tensors))
            for slot, tensors in init_slots(optimizer, params).items()}


def init_train_state(conf, encoder: nn.Module, pfc_cfg: PFCConfig, device,
                     seed: int = 0) -> TrainState:
    """Fresh state around an initialised encoder, moved to ``device``; the
    head weight draws N(0, 0.01) from a generator seeded with ``seed``,
    and the step's three streams are seeded from it too."""
    device = torch.device(device)
    encoder.to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return TrainState(step=0, encoder=encoder,
                      opt_slots=init_encoder_slots(conf.optimizer_name,
                                                   encoder),
                      pfc=init_pfc_state(pfc_cfg, gen, device),
                      generators=stream_generators(seed, device))
