"""PartialFC on one device (counterpart of fr_tpu/heads/partial_fc.py with
model_axis=None: one class shard, so no collectives).

The (num_classes, emd) class-centre matrix is padded to num_classes_padded
and the padding masked out of the softmax; negative sampling
(sample_rate < 1) draws num_sample sorted columns per step with the batch's
positives forced in, and the labels are remapped onto the sampled columns.
fr_tpu's deliberate divergences from its torch reference carry over: excess
positives beyond num_sample are dropped (their rows hit the 1e-30 log
clamp), and classes are padded rather than split unevenly.

Block-aligned sampling (sample_block > 1) draws aligned groups of
``sample_block`` consecutive class rows instead (``shard_group_masks``,
``sample_groups``), so that the sampled rows are whole contiguous runs of the
class table for the grouped kernels of ops/sparse_rows.py. Its two
divergences from the per-row draw are fr_tpu's: negatives of one group come
together, and negatives that share a group with one of the batch's positives
are always in.

The default CE (use_fused=False) is plain PyTorch, as it is plain XLA in
fr_tpu; use_fused=True takes the margin-softmax CE kernels of
ops/fused_pfc.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from fr_tpu_torch.heads.margins import get_margin_fn
from fr_tpu_torch.models.common import l2_normalize

MASK_VALUE = -1e30  # additive logit mask for padded/invalid class columns


@dataclasses.dataclass(frozen=True)
class PFCConfig:
    """Static configuration of the head: fr_tpu's fields and properties for
    one class shard (its model_size is 1, its TPU fused_tiles have no use
    here)."""
    num_classes: int
    embedding_size: int
    sample_rate: float = 1.0
    margin: str = "ArcFace"      # conf.metric
    s: float = 64.0
    m: float = 0.5
    mixed_precision: bool = True
    optimizer: str = "SGD"
    use_fused: bool = False      # the margin-softmax CE kernels
    easy_margin: bool = False
    sample_block: int = 1

    @property
    def num_classes_padded(self) -> int:
        m = max(1, self.sample_block)
        return ((self.num_classes + m - 1) // m) * m

    @property
    def num_local(self) -> int:
        """Classes of the one shard: all of them, padding included."""
        return self.num_classes_padded

    @property
    def num_sample(self) -> int:
        if self.sample_rate >= 1.0:
            return self.num_local
        n = max(1, int(self.sample_rate * self.num_local))
        if self.sample_block > 1:
            n = max(self.sample_block,
                    (n // self.sample_block) * self.sample_block)
        return n

    @property
    def num_sample_groups(self) -> int:
        return self.num_sample // max(1, self.sample_block)

    @property
    def sampling(self) -> bool:
        return self.num_sample < self.num_local

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.mixed_precision else torch.float32

    def margin_fn(self) -> Callable:
        return get_margin_fn(self.margin, self.s, self.m, self.easy_margin)


@dataclasses.dataclass
class PFCState:
    """Head weight (num_classes_padded, emd) f32, its optimizer slots of the
    same shape, and the head's own AdamW step count."""
    weight: torch.Tensor
    slots: Dict[str, torch.Tensor]
    count: int = 0


def init_pfc_state(cfg: PFCConfig, generator: torch.Generator,
                   device) -> PFCState:
    """weight ~ N(0, 0.01), zero slots."""
    w = 0.01 * torch.randn((cfg.num_classes_padded, cfg.embedding_size),
                           generator=generator, device=device)
    if cfg.optimizer == "SGD":
        slots = {"momentum": torch.zeros_like(w)}
    elif cfg.optimizer == "AdamW":
        slots = {"exp_avg": torch.zeros_like(w),
                 "exp_avg_sq": torch.zeros_like(w)}
    else:
        raise ValueError(cfg.optimizer)
    return PFCState(weight=w, slots=slots, count=0)


def shard_valid_mask(cfg: PFCConfig, device=None) -> torch.Tensor:
    """True for the real (non-padding) class rows."""
    return torch.arange(cfg.num_local, device=device) < cfg.num_classes


def sample_columns(cfg: PFCConfig, generator: torch.Generator,
                   pos_mask: torch.Tensor, valid: torch.Tensor
                   ) -> torch.Tensor:
    """num_sample sorted class indices: positives forced in (noise 2.0),
    negatives by uniform top-k, padding rows excluded."""
    perm = torch.rand(cfg.num_local, generator=generator,
                      device=pos_mask.device)
    perm = torch.where(pos_mask, 2.0, perm)
    perm = torch.where(valid, perm, -1.0)
    idx = torch.topk(perm, cfg.num_sample, sorted=False).indices
    return torch.sort(idx).values


def shard_group_masks(cfg: PFCConfig, labels: torch.Tensor,
                      owned: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-level (positives, valid) masks, (num_local // sample_block,)
    each, built without any num_local-sized tensor: the positives scatter
    straight onto the group axis, and a group holds a real class iff its
    first row id is below num_classes."""
    block = cfg.sample_block
    ng_total = cfg.num_local // block
    gpos = torch.zeros(ng_total, dtype=torch.bool, device=labels.device)
    gpos[labels[owned] // block] = True
    first_row = torch.arange(ng_total, device=labels.device) * block
    return gpos, first_row < cfg.num_classes


def sample_groups(cfg: PFCConfig, generator: torch.Generator,
                  gpos: torch.Tensor, gvalid: torch.Tensor) -> torch.Tensor:
    """num_sample_groups sorted group indices from the group-level masks:
    the positives' groups forced in (noise 2.0), the rest by uniform top-k,
    groups of padding rows only excluded (a partly padded tail group stays
    drawable; its padding columns are masked per column)."""
    perm = torch.rand(gpos.shape[0], generator=generator, device=gpos.device)
    perm = torch.where(gpos, 2.0, perm)
    perm = torch.where(gvalid, perm, -1.0)
    gidx = torch.topk(perm, cfg.num_sample_groups, sorted=False).indices
    return torch.sort(gidx).values


def remap_labels(cfg: PFCConfig, idx: torch.Tensor, local_labels: torch.Tensor,
                 owned: torch.Tensor) -> torch.Tensor:
    """Owned class ids → sampled-column positions; -1 where the class was
    not sampled."""
    r = torch.searchsorted(idx, torch.where(owned, local_labels, 0))
    r = torch.clamp_max(r, cfg.num_sample - 1)
    hit = (idx[r] == local_labels) & owned
    return torch.where(hit, r, -1)


def shard_softmax_ce(cfg: PFCConfig, emb_row: torch.Tensor,
                     label_cols: torch.Tensor, w_act: torch.Tensor,
                     col_valid: torch.Tensor) -> torch.Tensor:
    """Cosine logits → margin → softmax CE, per sample.

    emb_row (N, D) L2-normalised embeddings; label_cols (N,) target column
    or -1; w_act (K, D) the (sampled) class centres; col_valid (K,) False
    for padding columns. Returns the per-sample loss (N,) f32."""
    compute = cfg.compute_dtype
    if cfg.use_fused:
        from fr_tpu_torch.ops.fused_pfc import fused_margin_softmax_ce
        return fused_margin_softmax_ce(
            l2_normalize(emb_row.float()).to(compute),
            l2_normalize(w_act.float()).to(compute),
            label_cols, col_valid, cfg)
    ne = l2_normalize(emb_row).to(compute)
    nw = l2_normalize(w_act).to(compute)
    # f32 products of the compute-dtype operands: fr_tpu's
    # preferred_element_type=f32 (a bf16 matmul here would round the logits)
    logits = torch.matmul(ne.float(), nw.float().t())
    logits = torch.clamp(logits, -1.0, 1.0)
    logits = cfg.margin_fn()(logits, label_cols)
    logits = torch.where(col_valid[None, :], logits, MASK_VALUE)
    # the max shift cancels in the softmax, so it carries no gradient
    mx = torch.amax(logits, dim=1, keepdim=True).detach()
    ex = torch.exp(logits - mx)
    denom = torch.sum(ex, dim=1)
    has_target = label_cols >= 0
    tgt_ex = torch.gather(ex, 1, torch.clamp_min(label_cols, 0)[:, None])[:, 0]
    tgt = torch.where(has_target, tgt_ex, 0.0) / denom
    return -torch.log(torch.clamp_min(tgt, 1e-30))


def dense_partial_fc_loss(cfg: PFCConfig, embeddings: torch.Tensor,
                          labels: torch.Tensor,
                          weight: torch.Tensor) -> torch.Tensor:
    """Full-softmax mean loss over every class column, no sampling."""
    full_valid = torch.arange(weight.shape[0],
                              device=weight.device) < cfg.num_classes
    return shard_softmax_ce(cfg, l2_normalize(embeddings.float()), labels,
                            weight, full_valid).mean()


def label_columns(cfg: PFCConfig, labels: torch.Tensor,
                  idx: Optional[torch.Tensor]) -> torch.Tensor:
    """Each sample's target column among the active columns, or -1
    (fr_tpu/train/step.py:155-167 on one shard)."""
    owned = (labels >= 0) & (labels < cfg.num_local)
    if idx is None:
        return torch.where(owned, labels, -1)
    return remap_labels(cfg, idx, labels, owned)
