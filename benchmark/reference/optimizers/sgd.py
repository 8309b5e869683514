"""SGD with momentum and coupled weight decay, as the configuration states
it: b ← μ·b + (g + wd·p), p ← p − lr·b, on each leaf of the encoder and on
the drawn rows of the class table only. Its one slot is the program's
``momentum``; the readings take its change over a step."""

from __future__ import annotations

from typing import Dict

import torch

SLOTS = ("momentum",)
READ = "momentum"


def program_keys(opt: dict) -> dict:
    """{the program's configuration key: the value the configuration
    states}."""
    return {"lr": opt["lr"], "mom": opt["momentum"],
            "wd": opt["weight_decay"]}


def decay(opt: dict) -> float:
    """The read slot's decay over a step: μ."""
    return opt["momentum"]


@torch.no_grad()
def update_leaf(opt: dict, p: torch.Tensor, g: torch.Tensor,
                slots: Dict[str, torch.Tensor], count: int) -> torch.Tensor:
    """Updates p and its slots in place; returns the read slot's change."""
    mom = slots["momentum"]
    delta = (opt["momentum"] - 1.0) * mom + g + opt["weight_decay"] * p
    mom.add_(delta)
    p.sub_(opt["lr"] * mom)
    return delta


@torch.no_grad()
def update_rows(opt: dict, table: torch.Tensor, rows: torch.Tensor,
                g_rows: torch.Tensor, slots: Dict[str, torch.Tensor],
                count: int):
    """Updates the drawn rows of the table and of its slots in place;
    returns (the read slot's change on those rows, what the step added to
    the decayed slot there: g + wd·w)."""
    mom = slots["momentum"]
    b_old = mom.index_select(0, rows)
    w = table.index_select(0, rows)
    head_grad = g_rows + opt["weight_decay"] * w
    b = opt["momentum"] * b_old + head_grad
    table.index_copy_(0, rows, w - opt["lr"] * b)
    mom.index_copy_(0, rows, b)
    return b - b_old, head_grad
