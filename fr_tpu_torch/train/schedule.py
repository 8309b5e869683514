"""LR schedules (a jax-free copy of fr_tpu/train/schedule.py, whose
package top imports jax).

``cosine_annealing_warmup_restarts`` reproduces the epoch-by-epoch values of
the reference scheduler (reference utils/scheduler.py:5-88) as a pure function
``epoch -> lr``:

- torch `_LRScheduler.__init__` performs an implicit step, and the reference's
  `init_lr` pins the base lr to `min_lr`, so the lr used for epoch 0 is
  `min_lr`, epoch e (stepped per epoch, reference model/FR_PartialFC.py:318)
  has step_in_cycle == e.
- warmup: lr = min_lr + (max_lr − min_lr) · e / warmup_steps for e < warmup.
- cosine: lr = min_lr + (max_lr − min_lr) · (1 + cos(π·(e−w)/(cycle−w))) / 2.
- restarts: when step_in_cycle reaches cur_cycle_steps the cycle restarts,
  cur_cycle_steps ← (cur−w)·cycle_mult + w, and max_lr decays by gamma per
  cycle.
"""

from __future__ import annotations

import math
from typing import Callable, List


def cosine_annealing_warmup_restarts(
    first_cycle_steps: int,
    max_lr: float,
    min_lr: float,
    warmup_steps: int = 0,
    cycle_mult: float = 1.0,
    gamma: float = 1.0,
) -> Callable[[int], float]:
    assert warmup_steps < first_cycle_steps

    def lr_at(epoch: int) -> float:
        # Walk cycles exactly as the reference's sequential `step()` does.
        cycle = 0
        step_in_cycle = epoch
        cur_cycle_steps = first_cycle_steps
        while step_in_cycle >= cur_cycle_steps:
            step_in_cycle -= cur_cycle_steps
            cycle += 1
            cur_cycle_steps = int((cur_cycle_steps - warmup_steps) * cycle_mult) + warmup_steps
        cur_max = max_lr * (gamma ** cycle)
        if step_in_cycle < warmup_steps:
            return (cur_max - min_lr) * step_in_cycle / warmup_steps + min_lr
        return min_lr + (cur_max - min_lr) * (
            1 + math.cos(math.pi * (step_in_cycle - warmup_steps)
                         / (cur_cycle_steps - warmup_steps))) / 2

    return lr_at


def multistep(lr: float, decay_epochs: List[int], ratio: float) -> Callable[[int], float]:
    """MultiStepLR: multiply by `ratio` at each epoch in decay_epochs
    (reference configs/ms1m_arcface_122.py:252-254, torch MultiStepLR semantics)."""

    def lr_at(epoch: int) -> float:
        k = sum(1 for e in decay_epochs if epoch >= e)
        return lr * (ratio ** k)

    return lr_at


def step_lr(lr: float, step_size: int, ratio: float) -> Callable[[int], float]:
    """StepLR (reference configs/ms1m_arcface_122.py:260-262)."""

    def lr_at(epoch: int) -> float:
        return lr * (ratio ** (epoch // step_size))

    return lr_at


def get_schedule(conf) -> Callable[[int], float]:
    """Scheduler dispatch by conf.lr_scheduler (reference model/FR_PartialFC.py:452-464)."""
    name = conf.lr_scheduler
    if name == "CosineAnnealingWarmupRestarts":
        return cosine_annealing_warmup_restarts(
            first_cycle_steps=conf.num_epoch, max_lr=conf.lr,
            min_lr=conf.min_lr, warmup_steps=conf.warmup_steps)
    if name == "CosineAnnealingLR":
        return cosine_annealing_warmup_restarts(
            first_cycle_steps=conf.num_epoch, max_lr=conf.lr,
            min_lr=conf.min_lr, warmup_steps=0)
    if name == "MultiStep":
        return multistep(conf.lr, conf.lr_decay_epoch, conf.lr_decay_ratio)
    if name == "StepLR":
        return step_lr(conf.lr, conf.lr_decay_epoch_size, conf.lr_decay_ratio)
    raise ValueError(f"Unknown scheduler {name!r}")
