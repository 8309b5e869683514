"""Synthetic identity data for tests, demos and the card's smoke run
(counterpart of fr_tpu/data/synthetic.py). Each class has a fixed uint8
template; samples are template + noise. ``write_synthetic_folder`` writes
the corpus as an image folder for the loaders of data/folder.py.
``ArrayTrainLoader`` lives in data/folder.py, as in fr_tpu, and is
importable from here too."""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

from fr_tpu_torch.data.folder import ArrayTrainLoader  # noqa: F401


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


def write_synthetic_folder(root: str, n_classes: int, per_class: int,
                           img_size: int, seed: int = 0) -> None:
    """Write synthetic_corpus as JPEGs in the CustomImageFolder layout
    (<root>/imgs/id_<label>/<index>.jpg); needs cv2."""
    import cv2
    imgs, labels = synthetic_corpus(n_classes, per_class, img_size, seed)
    base = Path(root) / "imgs"
    for i, (img, lab) in enumerate(zip(imgs, labels)):
        d = base / f"id_{lab:05d}"
        d.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(d / f"{i:06d}.jpg"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


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
