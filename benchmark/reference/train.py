"""Plain float32 PyTorch of the training step that the train cells time,
and of the embedding step of the embed cell.

One training step, as the configuration states it:

1. the train-time augmentation of the uint8 batch (``augment.py``);
2. the PartialFC head's draw: the batch's positives' groups of ``block``
   class rows forced in, the other groups by a uniform top-k, groups of
   padding rows excluded, ``sampled_columns // block`` groups in all;
3. the encoder in training mode (batch statistics) → L2-normalise → cosine
   logits against the L2-normalised drawn rows, clamped to [−1, 1] → the
   configuration's margin on each target column (ArcFace: cos(θ + m);
   CosFace: cos θ − m) → scale → padding columns masked → softmax
   cross-entropy, −log(max(p_target, 1e-30)), mean over the batch;
4. gradients of the encoder and of the drawn rows; the encoder's clipped to
   global norm ``max_grad_norm``;
5. the configuration's optimizer, ``optimizers/<optimizer.name
   lowercased>.py``, on the encoder and on the drawn rows only.

The random numbers (the augmentation's, the draw's, dropout's) come from
generators that the caller sets to the states the program's generators
had before each step: this reference follows the program step by step
from those states and checks what it draws (every positive's group in,
the count of groups).

An optimizer's module names its slots (``SLOTS``, the program's names),
the one the readings take (``READ``) and that slot's decay over a step
(``decay``), and updates a leaf (``update_leaf``) and the drawn rows
(``update_rows``) in place. The steps start from the weights and class
table handed in, with the slots at zero and the step counts at 0 as in a
fresh run, or with the slots and counts handed in (``start``). Readings of
the steps (``steps``):
- ``loss``: each step's loss;
- ``grad1``: per leaf, the norm of the read slot's change over the first
  step; from zero slots that is the gradient as the optimizer takes it;
- ``gnorm1``: per leaf, the norm of the first step's clipped gradient g;
- ``mom1``: per leaf, the read slot's change over the first step itself;
- ``head1``: the first step's drawn rows and what the step added to their
  decayed read slot (from zero slots, the slot's change there);
- ``change3``: per leaf, ‖p − p₀‖ after the last step.
The leaves are the encoder's parameters by name, and ``head``, the whole
class table.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch

from benchmark.reference import augment as aug
from benchmark.reference import by_file
from benchmark.reference.encoders import Quant, forward, identity, unit


def optimizer(opt: dict):
    """The module ``optimizers/<opt.name lowercased>.py``; a name with no
    such file raises BenchError naming it."""
    return by_file("optimizers", opt["name"].lower())


def gen_at(state: torch.Tensor, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


def draw_rows(head: dict, labels: torch.Tensor, gen: torch.Generator):
    """(sorted drawn rows, their validity) of one step."""
    block = head["sample_block"]
    n_rows = head["padded_classes"]
    groups = n_rows // block
    n_draw = head["sampled_columns"] // block
    dev = labels.device
    gpos = torch.zeros(groups, dtype=torch.bool, device=dev)
    gpos[labels // block] = True
    gvalid = torch.arange(groups, device=dev) * block < head["num_classes"]
    perm = torch.rand(groups, generator=gen, device=dev)
    perm = torch.where(gpos, 2.0, perm)
    perm = torch.where(gvalid, perm, -1.0)
    gidx = torch.sort(torch.topk(perm, n_draw, sorted=False).indices).values
    if int(gpos.sum()) <= n_draw and not bool(gpos[gidx].sum()
                                              == gpos.sum()):
        raise AssertionError("a positive's group was not drawn")
    rows = (gidx[:, None] * block
            + torch.arange(block, device=dev)[None, :]).reshape(-1)
    return rows, rows < head["num_classes"]


def target_cosine(c: torch.Tensor, head: dict) -> torch.Tensor:
    """The margin on a target column's cosine: ArcFace's cos(θ + m), kept
    monotone below cos(π − m) as cos θ − sin(π − m)·m; CosFace's cos θ − m."""
    m = head["m"]
    if head["margin"] == "CosFace":
        return c - m
    if head["margin"] != "ArcFace":
        raise ValueError(f"no reference for the margin {head['margin']!r}")
    sq = 1.0 - c * c
    sin = torch.where(sq > 0, torch.sqrt(torch.where(sq > 0, sq, 1.0)), 0.0)
    phi = c * math.cos(m) - sin * math.sin(m)
    return torch.where(c > math.cos(math.pi - m), phi,
                       c - math.sin(math.pi - m) * m)


def margin_ce(emb, labels, w_rows, rows, valid, head: dict, q: Quant):
    """Per-sample loss of the margin softmax over the drawn rows."""
    col = torch.searchsorted(rows, labels)
    col = torch.clamp_max(col, rows.shape[0] - 1)
    hit = rows[col] == labels
    c = torch.clamp(q(unit(emb)) @ q(unit(w_rows)).t(), -1.0, 1.0)
    target = torch.zeros_like(c, dtype=torch.bool)
    target[torch.arange(c.shape[0], device=c.device)[hit], col[hit]] = True
    logits = torch.where(target, target_cosine(c, head), c) * head["s"]
    logits = torch.where(valid[None, :], logits, -1e30)
    ex = torch.exp(logits - logits.amax(dim=1, keepdim=True).detach())
    t = torch.where(hit, ex.gather(1, col[:, None])[:, 0], 0.0)
    return -torch.log(torch.clamp_min(t / ex.sum(dim=1), 1e-30))


def step_grads(cfg: dict, st: dict, p: Dict[str, torch.Tensor],
               stats: Dict[str, torch.Tensor], table: torch.Tensor,
               q: Quant = identity, half_batch: bool = False):
    """One step's (loss, the gradient of each leaf of ``p`` in its order,
    the drawn rows, their gradient) on one card: the batch augmented, the
    head's draw, the encoder, the margin CE over the drawn rows."""
    model, head = cfg["model"], cfg["head"]
    dev = table.device
    images = st["images"].to(dev)
    labels = st["labels"].to(dev).long()
    acfg = aug.cfg_from_config(cfg["augmentation"])
    x = aug.apply_augment(images, aug.draw_augment(
        acfg, images.shape, gen_at(st["states"]["augment"], dev), dev),
        acfg)
    rows, valid = draw_rows(head, labels, gen_at(st["states"]["sample"],
                                                 dev))
    w_rows = table.index_select(0, rows).requires_grad_(True)
    leaves = {n: v.requires_grad_(True) for n, v in p.items()}
    emb = forward(model, {**leaves, **stats}, x, True,
                  gen_at(st["states"]["dropout"], dev), q)
    per = margin_ce(unit(emb), labels, w_rows, rows, valid, head, q)
    loss = per[: per.shape[0] // 2].mean() if half_batch else per.mean()
    grads = torch.autograd.grad(loss, list(leaves.values()) + [w_rows])
    return loss, list(grads[:-1]), rows, grads[-1]


def train_steps(cfg: dict, params0: Dict[str, torch.Tensor],
                table0: torch.Tensor, steps: List[dict],
                q: Quant = identity, start: Optional[dict] = None,
                grads=step_grads, **fault) -> dict:
    """The readings of ``len(steps)`` steps from params0 and the class
    table table0 (both left as they are). Each step is a dict with
    ``images`` (B, H, W, 3) uint8, ``labels`` (B,) and ``states`` (the
    generators' states: augment, sample, dropout). ``start`` holds the
    optimizer's state to start from (``slots``: {slot: {leaf: tensor}},
    ``head_slots``: {slot: the table's}, ``count`` and ``head_count``: the
    encoder's and the head's steps so far), zero without it.
    ``grads`` gives each step's gradients (``step_grads``, or a mesh's);
    ``fault`` goes to it: ``half_batch=True`` takes the loss over the
    first half of each batch only (a planted fault)."""
    opt = cfg["optimizer"]
    optim = optimizer(opt)
    names = [n for n in params0 if not n.endswith(("running_mean",
                                                   "running_var"))]
    p = {n: params0[n].clone() for n in names}
    stats = {n: v for n, v in params0.items() if n not in p}
    if start is None:
        slots = {s: {n: torch.zeros_like(v) for n, v in p.items()}
                 for s in optim.SLOTS}
        head_slots = {s: torch.zeros_like(table0) for s in optim.SLOTS}
        count = head_count = 0
    else:
        slots = {s: {n: start["slots"][s][n].clone() for n in names}
                 for s in optim.SLOTS}
        head_slots = {s: start["head_slots"][s].clone() for s in optim.SLOTS}
        count, head_count = start["count"], start["head_count"]
    table = table0.clone()
    out: dict = {"loss": []}
    for k, st in enumerate(steps):
        loss, g_enc, rows, g_rows = grads(cfg, st, p, stats, table, q,
                                          **fault)
        total = torch.sqrt(sum(torch.sum(g * g) for g in g_enc))
        coef = torch.clamp_max(opt["max_grad_norm"] / (total + 1e-6), 1.0)
        g_enc = [g * coef for g in g_enc]
        out["loss"].append(float(loss.detach()))
        count, head_count = count + 1, head_count + 1
        with torch.no_grad():
            delta = {}
            for n, g in zip(names, g_enc):
                p[n] = p[n].detach()
                delta[n] = optim.update_leaf(
                    opt, p[n], g, {s: slots[s][n] for s in optim.SLOTS},
                    count)
            moved, added = optim.update_rows(opt, table, rows, g_rows,
                                             head_slots, head_count)
        if k == 0:
            out["mom1"] = delta
            out["grad1"] = {n: float(torch.linalg.vector_norm(delta[n]))
                            for n in names}
            out["grad1"]["head"] = float(torch.linalg.vector_norm(moved))
            out["gnorm1"] = {n: float(torch.linalg.vector_norm(g))
                             for n, g in zip(names, g_enc)}
            out["gnorm1"]["head"] = float(torch.linalg.vector_norm(g_rows))
            out["head1"] = (rows, added)
        del loss, g_enc, g_rows, moved, added
    out["change3"] = {n: float(torch.linalg.vector_norm(p[n] - params0[n]))
                      for n in names}
    out["change3"]["head"] = float(torch.linalg.vector_norm(table - table0))
    return out


@torch.no_grad()
def embed(cfg: dict, params: Dict[str, torch.Tensor], images,
          q: Quant = identity, block: int = 64) -> torch.Tensor:
    """L2-normalised embeddings of NHWC float images, the encoder in
    evaluation mode (BN's running statistics), ``block`` images at a time
    (evaluation mode makes the rows independent)."""
    return torch.cat([unit(forward(cfg["model"], params,
                                   images[i:i + block], False, None, q))
                      for i in range(0, images.shape[0], block)])


def fp8_rounding(x: torch.Tensor) -> torch.Tensor:
    """The control's rounding: x scaled so that its largest magnitude is
    e4m3's 448, rounded to float8_e4m3fn and scaled back, with the
    gradient passed straight through."""
    amax = torch.clamp_min(x.detach().abs().amax(), 1e-30)
    y = (x.detach() * (448.0 / amax)).to(torch.float8_e4m3fn).float() \
        * (amax / 448.0)
    return x + (y - x).detach()


class _RoundBF16(torch.autograd.Function):
    """Rounds a tensor to bfloat16 on the way forward and its gradient on
    the way back, as a bf16 autocast product holds both."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def bf16_rounding(x: torch.Tensor) -> torch.Tensor:
    """A witness of the program's own precision: every product's operands
    and their gradients rounded to bfloat16."""
    return _RoundBF16.apply(x)


def bf16_attention(x: torch.Tensor) -> torch.Tensor:
    """The same witness for the window attention's two products alone."""
    return x


bf16_attention.attention = bf16_rounding


@contextlib.contextmanager
def no_tf32():
    """A context in which float32 products stay float32 (TF32 off)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
