"""Full training-state checkpoints with exact resume (counterpart of
fr_tpu/ckpt/checkpoint.py:25-116; the encoder-only ``.npz`` snapshot lives
in utils/jax_import.py).

One file per step under ``<save_dir>/state/``, ``<step>.pt``: a ``torch.save``
of plain tensors, ints and dicts (the encoder's ``state_dict``, its optimizer
slots by parameter name, the head's weight, slots and count, the step, and
the ``get_state()`` of the three random-number generators), written under a
temporary name and moved into place with ``os.replace``, so a reader never
sees half a file. It is loaded with ``weights_only=True`` onto the state's
device. fr_tpu derives every random key from (key, step) and resumes
exactly for free; here the generators' states are what makes five steps
equal three steps, a save, a restore and two steps, bit for bit.

``PFCConfig.num_classes_padded`` grows with ``sample_block``, so a run saved
under one ``sample_block`` has a differently padded head than a state built
under another. ``restore_train_state`` migrates that, and only that: the
class-axis tail of the head's weight and slots is padded with zeros or
truncated. The padding rows are masked out of the softmax and never sampled,
so they hold nothing trained. Any other difference raises ``ValueError``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import torch

from fr_tpu_torch.train.state import TrainState


def _ckpt_dir(save_dir) -> Path:
    return Path(save_dir).absolute() / "state"


def _tree(state: TrainState) -> Dict[str, Any]:
    """The state as nested dicts of tensors and ints."""
    return {"step": state.step,
            "encoder": dict(state.encoder.state_dict()),
            "opt_slots": {slot: dict(tensors)
                          for slot, tensors in state.opt_slots.items()},
            "pfc": {"weight": state.pfc.weight,
                    "slots": dict(state.pfc.slots),
                    "count": state.pfc.count},
            "generators": {name: gen.get_state()
                           for name, gen in state.generators.items()}}


def save_train_state(save_dir, state: TrainState, step: int) -> None:
    path = _ckpt_dir(save_dir)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f"{step}.pt.{os.getpid()}.tmp"
    torch.save(_tree(state), tmp)
    os.replace(tmp, path / f"{step}.pt")


def latest_step(save_dir) -> Optional[int]:
    steps = [int(p.stem) for p in _ckpt_dir(save_dir).glob("*.pt")
             if p.stem.isdigit()]
    return max(steps, default=None)


def restore_train_state(save_dir, state: TrainState,
                        step: Optional[int] = None) -> TrainState:
    """Load step ``step`` (the latest by default) into ``state``, in place,
    on the device its head lies on, and return it. ``state`` gives the
    structure and shapes (a freshly initialised one will do); see the module
    docstring for the one migration allowed."""
    step = latest_step(save_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {_ckpt_dir(save_dir)}")
    device = state.pfc.weight.device
    raw = torch.load(_ckpt_dir(save_dir) / f"{step}.pt", map_location=device,
                     weights_only=True)
    new = _migrate_pfc_padding(raw, _tree(state))
    state.encoder.load_state_dict(new["encoder"], strict=True)
    state.opt_slots = new["opt_slots"]
    state.pfc.weight = new["pfc"]["weight"]
    state.pfc.slots = new["pfc"]["slots"]
    state.pfc.count = int(new["pfc"]["count"])
    state.step = int(new["step"])
    for name, gen in state.generators.items():
        gen.set_state(new["generators"][name].cpu())
    return state


def _pad_or_truncate_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] >= rows:
        return t[:rows].clone()
    pad = torch.zeros((rows - t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    return torch.cat([t, pad], dim=0)


def _migrate_pfc_padding(raw, target):
    """Map a loaded tree onto the target's structure and shapes, allowing a
    different size of the class axis (axis 0) only inside the ``pfc``
    subtree."""

    def walk(r, t, path, in_pfc):
        if isinstance(t, Mapping):
            if not isinstance(r, Mapping) or set(r) != set(t):
                raise ValueError(
                    f"checkpoint/state structure mismatch at '{path}': "
                    f"{sorted(r) if isinstance(r, Mapping) else type(r)} vs "
                    f"{sorted(t)}")
            return {k: walk(r[k], t[k], f"{path}/{k}", in_pfc or k == "pfc")
                    for k in t}
        if not isinstance(t, torch.Tensor):
            if isinstance(r, (Mapping, torch.Tensor)):
                raise ValueError(f"checkpoint/state structure mismatch at "
                                 f"'{path}': {type(r)} vs {type(t)}")
            return r
        if not isinstance(r, torch.Tensor):
            raise ValueError(f"checkpoint/state structure mismatch at "
                             f"'{path}': {type(r)} vs a tensor")
        if r.shape == t.shape:
            return r
        if (in_pfc and r.dim() == t.dim() and r.dim() >= 1
                and r.shape[1:] == t.shape[1:]):
            return _pad_or_truncate_rows(r, t.shape[0])
        raise ValueError(
            f"checkpoint/state shape mismatch at '{path}': "
            f"{tuple(r.shape)} vs {tuple(t.shape)} (only pfc class-axis "
            f"padding differences are migratable)")

    return walk(raw, target, "", False)
