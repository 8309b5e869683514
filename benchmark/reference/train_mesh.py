"""Plain float32 PyTorch of the training step that a mesh of ranks times,
undistributed: the class table sharded over ``model`` ranks of the mesh
(data 1, model n), each rank holding ``batch_size`` images of the global
batch. One step, as the program's mesh runs it:

1. each rank's uint8 images augmented by that rank's augmentation state;
2. each shard's draw from that shard's sample state: the groups of
   ``sample_block`` rows of its slice of the padded table that hold a
   positive of the global batch forced in, the others by a uniform top-k,
   groups of padding rows excluded, ``sampled_columns // block`` groups
   a shard; the union of the shards' rows, in global order;
3. the encoder in training mode on each rank's images in turn, so that
   BatchNorm's statistics are each rank's own;
4. the margin softmax CE of every row of the global batch over the union
   of the drawn rows, the mean over the global batch;
5. the encoder's gradient, the sum over the ranks of what each rank's rows
   give (the mean over the global batch), and the drawn rows'.

The encoder's backward runs a rank's images at a time: the first walk
makes every rank's embeddings without a graph, the CE gives their
gradient, and each rank's forward is run again, from the same states,
with its graph, and walked back from its rows of that gradient. Steps 4
and 5 then follow ``train.train_steps``: the clip, the optimizer on the
encoder and on the drawn rows.

Planted faults (``train_steps``' ``fault``): ``half_batch``, the loss over
the first half of the global batch; ``no_grad_sum``, the encoder's
gradient from rank 0's rows alone, as a rank that steps on its own
gradient has it; ``part_grad_sum``, the same for the encoder's last
leaves that hold a quarter of its parameters (``tail_leaves``: the first
bucket that an all-reduce overlapped with the backward would send), the
others summed; ``local_head``, each shard's CE over its own rank's rows
alone (no all-gather), the sum over the shards of each one's mean.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from benchmark.reference import augment as aug
from benchmark.reference import train
from benchmark.reference.encoders import Quant, forward, identity, unit


def draw_shard_rows(head: dict, shards: int, shard: int,
                    labels: torch.Tensor, gen: torch.Generator):
    """(sorted global ids of the rows that shard ``shard`` draws, their
    validity) of one step."""
    block = head["sample_block"]
    n_local = head["padded_classes"] // shards
    groups = n_local // block
    n_draw = head["sampled_columns"] // block
    dev = labels.device
    start = shard * n_local
    loc = labels - start
    owned = (loc >= 0) & (loc < n_local)
    gpos = torch.zeros(groups, dtype=torch.bool, device=dev)
    gpos[loc[owned] // block] = True
    gvalid = start + torch.arange(groups, device=dev) * block \
        < head["num_classes"]
    perm = torch.rand(groups, generator=gen, device=dev)
    perm = torch.where(gpos, 2.0, perm)
    perm = torch.where(gvalid, perm, -1.0)
    gidx = torch.sort(torch.topk(perm, n_draw, sorted=False).indices).values
    if int(gpos.sum()) <= n_draw and not bool(gpos[gidx].sum()
                                              == gpos.sum()):
        raise AssertionError("a positive's group was not drawn")
    rows = start + (gidx[:, None] * block
                    + torch.arange(block, device=dev)[None, :]).reshape(-1)
    return rows, rows < head["num_classes"]


def tail_leaves(p: Dict[str, torch.Tensor], share: float = 0.25) -> set:
    """The names of the last leaves of ``p``, in its order, that together
    hold at least ``share`` of its elements."""
    total, held, out = sum(v.numel() for v in p.values()), 0, set()
    for n in reversed(list(p)):
        if held >= share * total:
            break
        out.add(n)
        held += p[n].numel()
    return out


def mesh_step_grads(cfg: dict, st: dict, p: Dict[str, torch.Tensor],
                    stats: Dict[str, torch.Tensor], table: torch.Tensor,
                    q: Quant = identity, half_batch: bool = False,
                    no_grad_sum: bool = False, part_grad_sum: bool = False,
                    local_head: bool = False):
    """``train.step_grads`` of one step of the mesh: ``st`` holds each
    rank's ``images`` and ``states`` (lists in rank order) and the global
    ``labels``."""
    model, head = cfg["model"], cfg["head"]
    shards = cfg["deployment"]["mesh"]["model"]
    dev = table.device
    labels = st["labels"].to(dev).long()
    acfg = aug.cfg_from_config(cfg["augmentation"])
    xs = []
    for images, states in zip(st["images"], st["states"]):
        images = images.to(dev)
        xs.append(aug.apply_augment(images, aug.draw_augment(
            acfg, images.shape, train.gen_at(states["augment"], dev), dev),
            acfg))
    ranks, b = len(xs), xs[0].shape[0]
    drawn = [draw_shard_rows(head, shards, s, labels,
                             train.gen_at(st["states"][s]["sample"], dev))
             for s in range(shards)]
    rows = torch.cat([r for r, _ in drawn])
    valid = torch.cat([v for _, v in drawn])
    w_rows = table.index_select(0, rows).requires_grad_(True)
    leaves = {n: v.requires_grad_(True) for n, v in p.items()}

    def embed(r):
        return forward(model, {**leaves, **stats}, xs[r], True,
                       train.gen_at(st["states"][r]["dropout"], dev), q)

    with torch.no_grad():
        emb = torch.cat([embed(r) for r in range(ranks)])
    emb.requires_grad_(True)
    if local_head:
        at, per = 0, []
        for s, (r_s, v_s) in enumerate(drawn):
            rs = slice(s * b, (s + 1) * b)
            per.append(train.margin_ce(unit(emb[rs]), labels[rs],
                                       w_rows[at:at + r_s.shape[0]], r_s,
                                       v_s, head, q))
            at += r_s.shape[0]
        loss = torch.cat(per).mean()
    else:
        per = train.margin_ce(unit(emb), labels, w_rows, rows, valid, head,
                              q)
        loss = per[: per.shape[0] // 2].mean() if half_batch else per.mean()
    g_emb, g_rows = torch.autograd.grad(
        loss * shards if local_head else loss, [emb, w_rows])
    g_enc = None
    unsummed = tail_leaves(p) if part_grad_sum else set()
    for r in range(1 if no_grad_sum else ranks):
        got = torch.autograd.grad(embed(r), list(leaves.values()),
                                  g_emb[r * b:(r + 1) * b])
        g_enc = list(got) if g_enc is None else [
            a if n in unsummed else a + g
            for n, a, g in zip(leaves, g_enc, got)]
    return loss, g_enc, rows, g_rows


def train_steps(cfg: dict, params0: Dict[str, torch.Tensor],
                table0: torch.Tensor, steps: List[dict],
                q: Quant = identity, start: Optional[dict] = None,
                **fault) -> dict:
    """``train.train_steps`` over steps of the mesh (``mesh_step_grads``)."""
    return train.train_steps(cfg, params0, table0, steps, q=q, start=start,
                             grads=mesh_step_grads, **fault)
