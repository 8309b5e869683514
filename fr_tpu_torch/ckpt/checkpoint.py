"""Full training-state checkpoints with exact resume (counterpart of
fr_tpu/ckpt/checkpoint.py:25-120; the encoder-only ``.npz`` snapshot lives
in utils/jax_import.py).

One file per step under ``<save_dir>/state/``, ``<step>.pt``: a ``torch.save``
of plain tensors, ints and dicts (the encoder's ``state_dict``, its optimizer
slots by parameter name, the head's weight, slots and count, the step, and
the ``get_state()`` of the three random-number generators), written under a
temporary name and moved into place with ``os.replace``, so a reader never
sees half a file. It is loaded with ``weights_only=True``, memory-mapped,
and moved onto the state's device. fr_tpu derives every random key from
(key, step) and resumes exactly for free; here the generators' states are
what makes five steps equal three steps, a save, a restore and two steps,
bit for bit.

On a mesh (parallel/mesh.py) the file keeps the one-device layout: the
whole padded head and its slots, gathered over the model group to the host
a chunk of rows at a time, and rank 0's generators, with every other rank's
under ``rank_generators`` and the mesh's (data, model) under ``mesh``. Every
rank calls ``save_train_state``; rank 0 writes while the others wait at a
barrier. On restore each rank takes its model shard of the head. The sample
stream is the model shard's, shared by the shard's data rows (the rows'
head gradients are summed, so they must draw the same columns): shard m
takes the file's shard m's stream where the file has that shard, else all
its data rows keep the same fresh one. The augment and dropout streams are
the rank's own: rank r takes the file's rank r's where it has one, else
keeps its fresh ones. So a run saved at one mesh shape resumes at another,
as fr_tpu's restores across shardings (:45-69, :78-120).

``PFCConfig.num_classes_padded`` grows with ``sample_block`` and with the
model axis, so a run saved under one of them has a differently padded head
than a state built under another. ``restore_train_state`` migrates that,
and only that: the class-axis tail of the head's weight and slots is padded
with zeros or truncated. The padding rows are masked out of the softmax and
never sampled, so they hold nothing trained. Any other difference raises
``ValueError``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import torch
import torch.distributed as dist

from fr_tpu_torch.parallel.collectives import all_gather, gather_rows_to_host
from fr_tpu_torch.parallel.mesh import local_class_slice
from fr_tpu_torch.train.state import TrainState


def _ckpt_dir(save_dir) -> Path:
    return Path(save_dir).absolute() / "state"


def _generators(state: TrainState) -> Dict[str, torch.Tensor]:
    return {name: gen.get_state() for name, gen in state.generators.items()}


def _tree(state: TrainState, head=None) -> Dict[str, Any]:
    """The state as nested dicts of tensors and ints; ``head`` replaces the
    head's weight and slots (the gathered ones)."""
    weight, slots = head if head else (state.pfc.weight,
                                       dict(state.pfc.slots))
    return {"step": state.step,
            "encoder": dict(state.encoder.state_dict()),
            "opt_slots": {slot: dict(tensors)
                          for slot, tensors in state.opt_slots.items()},
            "pfc": {"weight": weight, "slots": slots,
                    "count": state.pfc.count},
            "generators": _generators(state)}


def _all_generators(state: TrainState, mesh):
    """Every rank's generator states, in rank order."""
    out = [dict() for _ in range(mesh.size)]
    for name, t in _generators(state).items():
        rows = all_gather(t.to(state.pfc.weight.device)[None],
                          mesh.world_group).cpu()
        for r in range(mesh.size):
            out[r][name] = rows[r].clone()
    return out


def save_train_state(save_dir, state: TrainState, step: int,
                     mesh=None) -> None:
    """Write the state of step ``step``; on a mesh every rank calls it."""
    rank = mesh.rank if mesh else 0
    if mesh is None or mesh.size == 1:
        tree = _tree(state)
    else:
        def gather(t):  # the whole table, on rank 0's host
            return gather_rows_to_host(t, mesh.model_group, keep=rank == 0)

        head = (gather(state.pfc.weight),
                {k: gather(v) for k, v in state.pfc.slots.items()})
        gens = _all_generators(state, mesh)
        tree = _tree(state, head) if rank == 0 else None
        if rank == 0:
            tree["generators"] = gens[0]
            tree["rank_generators"] = gens[1:]
            tree["mesh"] = [mesh.data, mesh.model]
    if rank == 0:
        path = _ckpt_dir(save_dir)
        path.mkdir(parents=True, exist_ok=True)
        tmp = path / f"{step}.pt.{os.getpid()}.tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path / f"{step}.pt")
    if mesh is not None and mesh.size > 1:
        dist.barrier()


def latest_step(save_dir) -> Optional[int]:
    steps = [int(p.stem) for p in _ckpt_dir(save_dir).glob("*.pt")
             if p.stem.isdigit()]
    return max(steps, default=None)


def restore_train_state(save_dir, state: TrainState,
                        step: Optional[int] = None,
                        mesh=None) -> TrainState:
    """Load step ``step`` (the latest by default) into ``state``, in place,
    on the device its head lies on, and return it. ``state`` gives the
    structure and shapes (a freshly initialised one will do); see the module
    docstring for the one migration allowed and for meshes."""
    step = latest_step(save_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {_ckpt_dir(save_dir)}")
    device = state.pfc.weight.device
    raw = torch.load(_ckpt_dir(save_dir) / f"{step}.pt", map_location="cpu",
                     weights_only=True, mmap=True)
    ranks = [raw["generators"]] + list(raw.pop("rank_generators", []))
    saved_model = int(raw.pop("mesh", [1, 1])[1])
    model = mesh.model if mesh else 1
    midx = mesh.model_idx if mesh else 0
    num_local = state.pfc.weight.shape[0]

    def whole(t):  # the shape of the whole head, for the migration
        return torch.empty((model * num_local,) + tuple(t.shape[1:]),
                           dtype=t.dtype, device="meta")

    target = _tree(state, (whole(state.pfc.weight),
                           {k: whole(v) for k, v in state.pfc.slots.items()}))
    new = _migrate_pfc_padding(raw, target)

    start, _ = local_class_slice(model * num_local, model, midx)

    def mine(t):  # a copy: the loaded tensors map the file
        return t[start:start + num_local].to(device, copy=True)

    state.encoder.load_state_dict(new["encoder"], strict=True)
    state.opt_slots = {slot: {k: v.to(device, copy=True)
                              for k, v in tensors.items()}
                       for slot, tensors in new["opt_slots"].items()}
    state.pfc.weight = mine(new["pfc"]["weight"])
    state.pfc.slots = {k: mine(v) for k, v in new["pfc"]["slots"].items()}
    state.pfc.count = int(new["pfc"]["count"])
    state.step = int(new["step"])
    rank = mesh.rank if mesh else 0
    gens = dict(ranks[rank]) if rank < len(ranks) else {}
    # the sample stream is the shard's; the file's rank midx sits at
    # (0, midx) of its mesh
    gens.pop("sample", None)
    if midx < saved_model:
        gens["sample"] = ranks[midx]["sample"]
    for name, gen_state in gens.items():
        state.generators[name].set_state(gen_state.cpu())
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
