"""Synthetic identity data and in-memory loaders (numpy copies of
fr_tpu/data/synthetic.py and fr_tpu/data/folder.py::ArrayTrainLoader, whose
package top imports jax). Each class has a fixed template; samples are
template + noise. Real-dataset loaders wait for datasets in the repository
(ROADMAP §1, eval extras)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_corpus(n_classes: int, per_class: int, img_size: int,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 NHWC images and int32 labels, per_class samples per class."""
    rng = np.random.default_rng(seed)
    templates = rng.integers(0, 256, (n_classes, img_size, img_size, 3))
    labels = np.repeat(np.arange(n_classes), per_class)
    noise = rng.integers(-30, 31, (len(labels), img_size, img_size, 3))
    imgs = np.clip(templates[labels] + noise, 0, 255).astype(np.uint8)
    return imgs, labels.astype(np.int32)


def synthetic_pairs(n_pairs: int, n_classes: int, img_size: int,
                    seed: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Normalised float pairs (n, 2, H, W, 3) + bool same-identity labels."""
    rng = np.random.default_rng(seed)
    templates = rng.standard_normal((n_classes, img_size, img_size, 3))
    y1 = rng.integers(0, n_classes, n_pairs)
    same = rng.integers(0, 2, n_pairs).astype(bool)
    y2 = np.where(same, y1, (y1 + 1 + rng.integers(0, n_classes - 1, n_pairs))
                  % n_classes)
    a = templates[y1] + 0.3 * rng.standard_normal(
        (n_pairs, img_size, img_size, 3))
    b = templates[y2] + 0.3 * rng.standard_normal(
        (n_pairs, img_size, img_size, 3))
    pairs = np.stack([a, b], axis=1).astype(np.float32)
    return pairs, same


class ArrayPairDataset:
    """In-memory pair dataset with the PairDataset batching interface."""

    def __init__(self, pairs: np.ndarray, labels: np.ndarray):
        self.pairs = pairs
        self.labels = labels

    def __len__(self) -> int:
        return len(self.labels)

    def batches(self, batch_size: int):
        for s in range(0, len(self.labels), batch_size):
            yield self.pairs[s:s + batch_size], self.labels[s:s + batch_size]


class ArrayTrainLoader:
    """In-memory training batches: a seeded permutation per epoch, whole
    batches only (fr_tpu's ArrayTrainLoader on one process)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, seed: int = 0):
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError(f"uint8 NHWC images expected, got "
                             f"{images.dtype} {images.shape}")
        self.images = images
        self.labels = labels.astype(np.int32)
        self.batch_size = batch_size
        self.seed = seed

    def steps_per_epoch(self) -> int:
        return len(self.images) // self.batch_size

    def epoch(self, epoch: int):
        order = np.random.default_rng(self.seed + epoch).permutation(
            len(self.images))
        for s in range(self.steps_per_epoch()):
            sel = order[s * self.batch_size:(s + 1) * self.batch_size]
            yield self.images[sel], self.labels[sel]
