"""AdamW with decoupled weight decay, as the configuration states it, on
each leaf of the encoder and on the drawn rows of the class table only:
p ← p·(1 − lr·wd); m ← β1·m + (1 − β1)·g; v ← β2·v + (1 − β2)·g²;
p ← p − lr/(1 − β1ᵗ) · m/(√v/√(1 − β2ᵗ) + eps), t the step's count (the
encoder's steps, and the head's, counted apart). Its slots are the
program's ``exp_avg`` (m) and ``exp_avg_sq`` (v); the readings take m's
change over a step."""

from __future__ import annotations

import math
from typing import Dict

import torch

SLOTS = ("exp_avg", "exp_avg_sq")
READ = "exp_avg"


def program_keys(opt: dict) -> dict:
    """{the program's configuration key: the value the configuration
    states}."""
    return {"lr": opt["lr"], "betas": tuple(opt["betas"]), "eps": opt["eps"],
            "wd": opt["weight_decay"]}


def decay(opt: dict) -> float:
    """The read slot's decay over a step: β1."""
    return opt["betas"][0]


def _adamw(opt: dict, p, g, m_old, v_old, count: int):
    """(p, m, v) after one step from (p, m_old, v_old)."""
    b1, b2 = opt["betas"]
    lr = opt["lr"]
    p = p * (1.0 - lr * opt["weight_decay"])
    m = b1 * m_old + (1.0 - b1) * g
    v = b2 * v_old + (1.0 - b2) * g * g
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    return (p - (lr / bc1) * m / (torch.sqrt(v) / math.sqrt(bc2)
                                  + opt["eps"]), m, v)


@torch.no_grad()
def update_leaf(opt: dict, p: torch.Tensor, g: torch.Tensor,
                slots: Dict[str, torch.Tensor], count: int) -> torch.Tensor:
    """Updates p and its slots in place; returns the read slot's change."""
    m_old = slots["exp_avg"]
    p_new, m, v = _adamw(opt, p, g, m_old, slots["exp_avg_sq"], count)
    delta = m - m_old
    p.copy_(p_new)
    m_old.copy_(m)
    slots["exp_avg_sq"].copy_(v)
    return delta


@torch.no_grad()
def update_rows(opt: dict, table: torch.Tensor, rows: torch.Tensor,
                g_rows: torch.Tensor, slots: Dict[str, torch.Tensor],
                count: int):
    """Updates the drawn rows of the table and of its slots in place;
    returns (the read slot's change on those rows, what the step added to
    the decayed slot there: (1 − β1)·g)."""
    m_old = slots["exp_avg"].index_select(0, rows)
    w, m, v = _adamw(opt, table.index_select(0, rows), g_rows, m_old,
                     slots["exp_avg_sq"].index_select(0, rows), count)
    table.index_copy_(0, rows, w)
    slots["exp_avg"].index_copy_(0, rows, m)
    slots["exp_avg_sq"].index_copy_(0, rows, v)
    return m - m_old, (1.0 - opt["betas"][0]) * g_rows
