"""Pair and cross verification metrics (counterpart of
fr_tpu/eval/verification.py, whose module top imports jax).

- score = 1 − ‖e1 − e2‖² / 4 on L2-normalised embeddings, the difference
  taken in the input dtype and squared and summed in float64 in element
  order, as the reference's numba kernel does;
- histogram bin = int((1e5 − 1)·score) into 100001-bin genuine/imposter
  histograms;
- ROC sweep over thresholds 1e5 → 1 with the reference's tie-breaking;
- accuracy at the EER threshold.

``pair_score`` and ``cross_score`` run on the host in f64, through the
native library (fr_tpu_torch/native) for f32 embeddings, else numpy; both
routes give the same bits. ``pair_score_device`` and ``cross_score_device``
score in f32 on a torch device (CUDA by default) for large evaluation
loops; their bins can differ from the host's at bucket edges.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

NUM_BINS = 100001
_BIN_SCALE = 1e5 - 1.0


def _sum_squares(diff: np.ndarray) -> np.ndarray:
    """Row sums of diff² in f64, added in element order: np.sum would add
    pairwise; cumsum keeps every score bit-equal to the reference's
    sequential f64 loop and to the native library."""
    return np.cumsum(np.square(diff.astype(np.float64)), axis=-1)[..., -1]


def pair_score(embedding_1, embedding_2, labels
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(genuine histogram, imposter histogram, scores), all float64."""
    e1 = np.asarray(embedding_1)
    e2 = np.asarray(embedding_2)
    labels = np.asarray(labels)
    if e1.dtype == np.float32:
        from fr_tpu_torch import native
        res = native.pair_score_native(e1, e2, labels)
        if res is not None:
            return res
    score = 1.0 - _sum_squares(e1 - e2) / 4.0
    hist_idx = np.clip((_BIN_SCALE * score).astype(np.int64), 0, NUM_BINS - 1)
    genuine = labels.astype(bool)
    hg = np.bincount(hist_idx[genuine], minlength=NUM_BINS).astype(np.float64)
    hi = np.bincount(hist_idx[~genuine], minlength=NUM_BINS).astype(np.float64)
    return hg, hi, score


def cross_score(embeddings, labels):
    """All-pairs verification (reference utils/eval.py:102-137): (genuine
    histogram, imposter histogram, scores, pair labels), all float64, over
    every pair i > j in the reference's order (i outer, j inner)."""
    emb = np.asarray(embeddings)
    lab = np.asarray(labels)
    if emb.dtype == np.float32 and np.issubdtype(lab.dtype, np.integer):
        from fr_tpu_torch import native
        res = native.cross_score_native(emb, lab)
        if res is not None:
            return res
    n, d = emb.shape
    ii, jj = np.tril_indices(n, k=-1)   # row-major: i outer, j inner
    score_list = np.empty(len(ii), np.float64)
    label_list = np.empty(len(ii), np.float64)
    hg = np.zeros(NUM_BINS, np.float64)
    hi = np.zeros(NUM_BINS, np.float64)
    block = max(1, (1 << 24) // max(d, 1))   # pairs per block: 128 MiB f64
    for s in range(0, len(ii), block):
        e = slice(s, min(s + block, len(ii)))
        sc = 1.0 - _sum_squares(emb[jj[e]] - emb[ii[e]]) / 4.0
        match = lab[jj[e]] == lab[ii[e]]
        score_list[e] = sc
        label_list[e] = match.astype(np.float64)
        bins = np.clip((_BIN_SCALE * sc).astype(np.int64), 0, NUM_BINS - 1)
        hg += np.bincount(bins[match], minlength=NUM_BINS)
        hi += np.bincount(bins[~match], minlength=NUM_BINS)
    return hg, hi, score_list, label_list


def _bins(score: torch.Tensor) -> torch.Tensor:
    """f32 scores → int64 bins, truncated toward zero as fr_tpu's
    astype(int32) does."""
    return torch.clamp((_BIN_SCALE * score).to(torch.int32), 0,
                       NUM_BINS - 1).long()


def _histograms(bins: torch.Tensor, genuine: torch.Tensor):
    """Integer counts of the genuine and the imposter bins."""
    return (torch.bincount(bins[genuine], minlength=NUM_BINS),
            torch.bincount(bins[~genuine], minlength=NUM_BINS))


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


def pair_score_device(embedding_1, embedding_2, labels, device="cuda"):
    """Pair scores in f32 on ``device`` (fr_tpu's _pair_score_device):
    (genuine histogram, imposter histogram, scores) as float64 numpy."""
    device = torch.device(device)
    e1 = torch.as_tensor(embedding_1).to(device, torch.float32)
    e2 = torch.as_tensor(embedding_2).to(device, torch.float32)
    genuine = torch.as_tensor(np.asarray(labels).astype(bool)).to(device)
    score = 1.0 - torch.sum(torch.square(e1 - e2), dim=-1) / 4.0
    hg, hi = _histograms(_bins(score), genuine)
    return _f64(hg), _f64(hi), _f64(score)


def cross_score_device(embeddings, labels, device="cuda", block: int = 512):
    """All-pairs (i > j) histograms in f32 on ``device`` (fr_tpu's
    _cross_score_device), blocked over ``block`` rows so memory stays
    (block, n): d² = |r|² + |e|² − 2·r·e with the product in full f32 (TF32
    off for the call: at TF32's 1e-3 the bins would move). Returns the
    genuine and imposter histograms only, as float64 numpy; the score lists
    are the host's (cross_score)."""
    device = torch.device(device)
    emb = torch.as_tensor(np.asarray(embeddings)).to(device, torch.float32)
    lab = torch.as_tensor(np.asarray(labels).astype(np.int64)).to(device)
    n = emb.shape[0]
    sq = torch.sum(torch.square(emb), dim=-1)
    hg = torch.zeros(NUM_BINS, dtype=torch.int64, device=device)
    hi = torch.zeros_like(hg)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i0 in range(0, n, block):
            i1 = min(i0 + block, n)
            # columns j < i1 hold every pair j < i of these rows
            d2 = sq[i0:i1, None] + sq[None, :i1] - 2.0 * torch.matmul(
                emb[i0:i1], emb[:i1].T)
            ii = torch.arange(i0, i1, device=device)[:, None]
            jj = torch.arange(i1, device=device)[None, :]
            valid = jj < ii
            bins = _bins(1.0 - d2 / 4.0)[valid]
            genuine = (lab[i0:i1, None] == lab[None, :i1])[valid]
            g, i = _histograms(bins, genuine)
            hg += g
            hi += i
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return _f64(hg), _f64(hi)


def performance_roc(hist_genuine: np.ndarray, hist_imposter: np.ndarray,
                    min_level: int = 3, max_level: int = 9
                    ) -> Tuple[str, int]:
    """FRR@FAR≤1e-k for k in [min_level, max_level], EER and its threshold.

    FAR(t) = Σ imposter bins ≥ t / total, FRR(t) = Σ genuine bins ≤ t /
    total over t = 100000 … 1; strict improvements keep the highest
    threshold."""
    hist_genuine = np.asarray(hist_genuine, np.float64)
    hist_imposter = np.asarray(hist_imposter, np.float64)
    total_genuine = int(hist_genuine.sum())
    total_imposter = int(hist_imposter.sum())

    t = np.arange(int(1e5), 0, -1)
    cum_imp_from_top = np.cumsum(hist_imposter[::-1])[::-1]
    cum_gen_to_bin = np.cumsum(hist_genuine)
    far = cum_imp_from_top[t] / total_imposter
    frr = cum_gen_to_bin[t] / total_genuine

    levels = list(range(min_level, max_level + 1))
    frr_far: List[Optional[float]] = [None] * len(levels)
    frr_far_th: List[Optional[int]] = [None] * len(levels)
    for k, level in enumerate(levels):
        ok = far <= float(f"1e-{level}")
        if ok.any():
            best = int(np.argmin(np.where(ok, frr, np.inf)))
            frr_far[k] = float(frr[best])
            frr_far_th[k] = int(t[best])

    best = int(np.argmin(np.abs(far - frr)))
    eer = float((far[best] + frr[best]) / 2)
    eer_threshold = int(t[best])

    roc_result = "\n"
    for k, level in enumerate(levels):
        if frr_far[k] is None:
            roc_result += f"- FRR @ FAR{level} n/a\n"
        else:
            roc_result += (f"- FRR @ FAR{level} {100 * frr_far[k]:6.3f}%, "
                           f"(Threshold = {frr_far_th[k] / 1e5:.5f})  \n")
    roc_result += "- EER {0:6.3f}%, (Threshold = {1:.5f})\n".format(
        100 * eer, eer_threshold / 1e5)
    roc_result += "- Total count = {:,}\n".format(total_genuine + total_imposter)
    roc_result += "- Total genuine count = {:,}\n".format(total_genuine)
    roc_result += "- Total imposter count = {:,}\n".format(total_imposter)
    return roc_result, eer_threshold


def performance_acc(score_list: np.ndarray, label_list: np.ndarray,
                    th: int) -> float:
    """Accuracy (%) at threshold th/1e5: FR = genuine scored ≤ th, FA =
    imposter scored > th."""
    score = np.asarray(score_list, np.float64)
    label = np.asarray(label_list)
    fr = int(np.sum((score <= th / 1e5) & (label == 1)))
    fa = int(np.sum((score > th / 1e5) & (label == 0)))
    return (1 - (fa + fr) / len(score)) * 100
