"""Grouped sparse-row access to the PartialFC class table: the Hopper
kernels' launch wrappers and their plain PyTorch versions.

Counterpart of fr_tpu/ops/sparse_rows.py (``expand_group_index``,
``grouped_gather``, ``grouped_update_sgd``, ``grouped_update_adamw``,
``grouped_update``). Under block-aligned sampling (PFCConfig.sample_block >
1) the head draws ``ng`` aligned groups of ``block`` consecutive class rows;
``gidx`` (ng,) holds their sorted unique group ids, and only those groups
move: the gather copies them into a dense (ng·block, D) array, and the
updates apply torch-exact SGD-momentum or AdamW to them in the table and its
slots. The kernels (csrc/sparse_rows.cu) replace fr_tpu's three TPU kernels
``grouped_gather`` (:70), ``grouped_update_sgd`` (:99) and
``grouped_update_adamw`` (:151); their contract is that file's jnp fallbacks
on the expanded row index, of which the ``*_reference`` functions here are
the PyTorch twins (the per-row updates below on the expanded index:
``index_select`` → the rule → ``index_copy_``). All three are bound by
bytes: a group is one contiguous run of block·D·4 bytes in the table and in
the dense array, and a CUDA block moves one chunk of it in 16-byte vectors.

The per-row updates (``row_sgd_update``, ``row_adamw_update``) and AdamW's
bias corrections live here too, below everything that trains:
train/optim.py takes them from this module, and this module imports nothing
of the training layer.

Unlike fr_tpu's functional updates (aliased outputs there), the updates here
return ``None`` and mutate ``weight`` and the slots in place, as
``row_sgd_update`` does: PyTorch allows it, and the table is never copied.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Each wrapper counts its launches in ``.launches``. The wrappers
check dtype, device, contiguity and shapes, not the ids: ``gidx`` must hold
unique ids in [0, C // block) (checking would synchronise with the device;
``sample_groups`` gives such ids). Duplicate ids make the update race; an id
outside the table is skipped by the kernel. fr_tpu's ``sharded_grouped_*``
wrappers are GSPMD machinery and have no counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch


def expand_group_index(gidx: torch.Tensor, block: int) -> torch.Tensor:
    """(ng,) sorted group ids → (ng·block,) sorted unique row ids."""
    return (gidx[:, None] * block
            + torch.arange(block, device=gidx.device)[None, :]).reshape(-1)


# ---------------------------------------------------------------------------
# Per-row updates (torch-exact SGD-momentum and AdamW on the rows ``idx``)
# ---------------------------------------------------------------------------

def _sgd(p, g, b, lr, wd: float, mom: float) -> None:
    b.mul_(mom).add_(g + wd * p)
    p.sub_(lr * b)


def _adamw(p, g, m, v, lr, wd: float, b1: float, b2: float, eps: float,
           bc1: float, bc2: float) -> None:
    p.mul_(1.0 - lr * wd)
    m.mul_(b1).add_((1.0 - b1) * g)
    v.mul_(b2).add_((1.0 - b2) * torch.square(g))
    p.sub_((lr / bc1) * m / (torch.sqrt(v) / bc2 ** 0.5 + eps))


def bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """1 − βᵗ with the powers taken in f32, as fr_tpu does."""
    t = torch.tensor(float(count), dtype=torch.float32)
    return (float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t),
            float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t))


@torch.no_grad()
def row_sgd_update(weight: torch.Tensor, slots: Dict[str, torch.Tensor],
                   idx: Optional[torch.Tensor], grad_rows: torch.Tensor,
                   lr: float, wd: float, mom: float) -> None:
    """SGD on the sampled rows only; idx=None means every row."""
    if idx is None:
        return _sgd(weight, grad_rows, slots["momentum"], lr, wd, mom)
    w = weight.index_select(0, idx)
    b = slots["momentum"].index_select(0, idx)
    _sgd(w, grad_rows, b, lr, wd, mom)
    weight.index_copy_(0, idx, w)
    slots["momentum"].index_copy_(0, idx, b)


@torch.no_grad()
def row_adamw_update(weight: torch.Tensor, slots: Dict[str, torch.Tensor],
                     idx: Optional[torch.Tensor], grad_rows: torch.Tensor,
                     lr: float, wd: float, b1: float, b2: float, eps: float,
                     count: int) -> None:
    """AdamW on the sampled rows with the head's single step count."""
    bc1, bc2 = bias_corrections(b1, b2, count)
    if idx is None:
        return _adamw(weight, grad_rows, slots["exp_avg"],
                      slots["exp_avg_sq"], lr, wd, b1, b2, eps, bc1, bc2)
    w = weight.index_select(0, idx)
    m = slots["exp_avg"].index_select(0, idx)
    v = slots["exp_avg_sq"].index_select(0, idx)
    _adamw(w, grad_rows, m, v, lr, wd, b1, b2, eps, bc1, bc2)
    weight.index_copy_(0, idx, w)
    slots["exp_avg"].index_copy_(0, idx, m)
    slots["exp_avg_sq"].index_copy_(0, idx, v)


# ---------------------------------------------------------------------------
# Plain versions of the grouped kernels
# ---------------------------------------------------------------------------

def grouped_gather_reference(table: torch.Tensor, gidx: torch.Tensor,
                             block: int) -> torch.Tensor:
    return table.index_select(0, expand_group_index(gidx, block))


def grouped_update_sgd_reference(weight, slots, gidx, grad_rows, lr: float,
                                 wd: float, mom: float, block: int) -> None:
    row_sgd_update(weight, slots, expand_group_index(gidx, block), grad_rows,
                   lr, wd, mom)


def grouped_update_adamw_reference(weight, slots, gidx, grad_rows, lr: float,
                                   wd: float, b1: float, b2: float,
                                   eps: float, count: int, block: int
                                   ) -> None:
    row_adamw_update(weight, slots, expand_group_index(gidx, block),
                     grad_rows, lr, wd, b1, b2, eps, count)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _route(table: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if table.device.type == "cpu":
        return False
    if table.device.type != "cuda":
        raise ValueError(f"no grouped-row kernel for device {table.device}")
    return True


def _check(tables: Dict[str, torch.Tensor], gidx: torch.Tensor, block: int,
           grad_rows=None) -> None:
    """What the kernels take: (C, D) f32 contiguous tables of one shape on
    one device with C % block == 0, int64 contiguous gidx (ng,) and, for an
    update, f32 contiguous grad_rows (ng·block, D), all on that device."""
    (first, table), *_ = tables.items()
    if table.dim() != 2 or block < 1 or table.shape[0] % block:
        raise ValueError(f"{first} must be (C, D) with C % block == 0, got "
                         f"{tuple(table.shape)} and block {block}")
    if gidx.dim() != 1 or gidx.dtype != torch.int64 or gidx.shape[0] == 0:
        raise ValueError(f"gidx must be a non-empty (ng,) int64, got "
                         f"{tuple(gidx.shape)} {gidx.dtype}")
    dense = {} if grad_rows is None else {"grad_rows": grad_rows}
    for name, t in {**tables, **dense}.items():
        shape = ((gidx.shape[0] * block, table.shape[1]) if name in dense
                 else tuple(table.shape))
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in {**tables, **dense, "gidx": gidx}.items():
        if t.device != table.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {table.device} "
                             f"(it is on {t.device})")


def _launch(name: str, table: torch.Tensor, block: int, gidx: torch.Tensor,
            pointers, scalars=()) -> None:
    from fr_tpu_torch.ops._build import check_launch, load_library

    lib = load_library()
    dev = table.device
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = getattr(lib, name)(
            *(t.data_ptr() for t in pointers), table.shape[0] // block,
            gidx.shape[0], block * table.shape[1], *map(float, scalars),
            stream)
    check_launch(lib, err, name)


def grouped_gather(table: torch.Tensor, gidx: torch.Tensor,
                   block: int) -> torch.Tensor:
    """Gather ng aligned groups of ``block`` rows of the (C, D) f32 table:
    (ng·block, D). The gradient of the head is taken with respect to the
    gathered rows, so this carries no autograd."""
    _check({"table": table}, gidx, block)
    if not _route(table):
        return grouped_gather_reference(table, gidx, block)
    out = torch.empty((gidx.shape[0] * block, table.shape[1]),
                      dtype=table.dtype, device=table.device)
    _launch("grouped_gather", table, block, gidx, (table, gidx, out))
    grouped_gather.launches += 1
    return out


@torch.no_grad()
def grouped_update_sgd(weight: torch.Tensor, slots: Dict[str, torch.Tensor],
                       gidx: torch.Tensor, grad_rows: torch.Tensor,
                       lr: float, wd: float, mom: float, block: int) -> None:
    """g ← g + wd·w; buf ← mom·buf + g; w ← w − lr·buf on the sampled groups
    only. Mutates ``weight`` and ``slots["momentum"]`` in place and returns
    None; every other row keeps its bits."""
    buf = slots["momentum"]
    _check({"weight": weight, "momentum": buf}, gidx, block, grad_rows)
    if not _route(weight):
        return grouped_update_sgd_reference(weight, slots, gidx, grad_rows,
                                            lr, wd, mom, block)
    _launch("grouped_update_sgd", weight, block, gidx,
            (weight, buf, gidx, grad_rows), (lr, wd, mom))
    grouped_update_sgd.launches += 1


@torch.no_grad()
def grouped_update_adamw(weight: torch.Tensor, slots: Dict[str, torch.Tensor],
                         gidx: torch.Tensor, grad_rows: torch.Tensor,
                         lr: float, wd: float, b1: float, b2: float,
                         eps: float, count: int, block: int) -> None:
    """Sampled-group AdamW with the head's one step count (the bias
    corrections are those of ``row_adamw_update``). Mutates ``weight``,
    ``slots["exp_avg"]`` and ``slots["exp_avg_sq"]`` in place and returns
    None."""
    m, v = slots["exp_avg"], slots["exp_avg_sq"]
    _check({"weight": weight, "exp_avg": m, "exp_avg_sq": v}, gidx, block,
           grad_rows)
    if not _route(weight):
        return grouped_update_adamw_reference(weight, slots, gidx, grad_rows,
                                              lr, wd, b1, b2, eps, count,
                                              block)
    bc1, bc2 = bias_corrections(b1, b2, count)
    _launch("grouped_update_adamw", weight, block, gidx,
            (weight, m, v, gidx, grad_rows), (lr, wd, b1, b2, eps, bc1, bc2))
    grouped_update_adamw.launches += 1


grouped_gather.launches = 0
grouped_update_sgd.launches = 0
grouped_update_adamw.launches = 0


def grouped_update(optimizer: str, conf, weight, slots, gidx, grad_rows, lr,
                   count: int, block: int) -> None:
    """Dispatch by optimizer, as ``pfc_row_update`` does for single rows."""
    if optimizer == "SGD":
        return grouped_update_sgd(weight, slots, gidx, grad_rows, lr,
                                  conf.wd, conf.mom, block)
    if optimizer == "AdamW":
        b1, b2 = conf.betas
        return grouped_update_adamw(weight, slots, gidx, grad_rows, lr,
                                    conf.wd, b1, b2, conf.eps, count, block)
    raise ValueError(optimizer)
