"""Validation / test datasets (counterpart of fr_tpu/data/pairs.py).

``PairDataset`` is the reference's VAL_DATASET_BYTE (reference
utils/data_partial.py:63-92): a bcolz carray of already-normalised float
images (N, C, H, W) viewed as (N/2, 2, C, H, W) pairs, with
``{dir}_list.npy`` boolean labels. The array is read with bcolz where it is
installed, else with the first-party rootdir reader (data/bcolz_reader.py,
the system libblosc), else from ``{dir}.npy`` / ``{dir}.npz`` of the same
layout. The pairs are shuffled by a seeded permutation, as fr_tpu does (the
reference's shuffle is unseeded; histograms are order-free, so no metric
depends on it), and returned NHWC.

``CrossDataset`` is the cross-matching TEST_DATASET (reference
utils/data_partial.py:20-58): a csv ``imgs/<name>.csv`` of (filename, label)
rows; images are decoded with cv2, resized and normalised with mean .5 /
std .5. pandas and cv2 are imported where they are used.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np


def _load_pair_array(data_dir: str) -> np.ndarray:
    """(N, C, H, W) float array of pair images, bcolz or npy/npz fallback."""
    p = Path(data_dir)
    try:
        import bcolz  # optional; the reference's storage format
        if (p / "meta").exists() or (p / "__attrs__").exists():
            return np.asarray(bcolz.carray(rootdir=str(p), mode="r"))
    except ImportError:
        # the first-party rootdir reader: bcolz itself does not install on
        # modern Pythons, its storage does
        if (p / "meta").is_dir() and (p / "data").is_dir():
            from fr_tpu_torch.data.bcolz_reader import (blosc_available,
                                                        read_carray)
            if blosc_available():
                return read_carray(str(p))
    for ext in (".npy", ".npz"):
        f = p.with_suffix(ext) if p.suffix != ext else p
        if Path(str(p) + ext).exists():
            f = Path(str(p) + ext)
        if f.exists():
            arr = np.load(f)
            if isinstance(arr, np.lib.npyio.NpzFile):
                arr = arr[arr.files[0]]
            return np.asarray(arr)
    raise FileNotFoundError(
        f"no pair data at {data_dir} (bcolz dir, .npy or .npz)")


class PairDataset:
    """(num_pairs, 2, H, W, C) float32 pairs + bool labels."""

    def __init__(self, data_dir: str, img_size: int,
                 shuffle_seed: Optional[int] = 0):
        arr = _load_pair_array(data_dir)
        n, c, h, w = arr.shape
        pairs = arr.reshape(n // 2, 2, c, h, w)
        labels = np.load(f"{data_dir}_list.npy")
        assert pairs.shape[0] == labels.shape[0], \
            "Not match size of patch and label !!!"
        if shuffle_seed is not None:
            perm = np.random.default_rng(shuffle_seed).permutation(len(labels))
            pairs, labels = pairs[perm], labels[perm]
        # NCHW → NHWC, the encoders' layout
        self.pairs = np.transpose(pairs, (0, 1, 3, 4, 2)).astype(np.float32)
        self.labels = np.asarray(labels).astype(bool)
        self.img_size = img_size

    def __len__(self) -> int:
        return len(self.labels)

    def batches(self, batch_size: int
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """((b, 2, H, W, C) float, (b,) bool); the embed step resizes to
        conf.img_size on the device where the sizes differ."""
        for s in range(0, len(self), batch_size):
            yield self.pairs[s:s + batch_size], self.labels[s:s + batch_size]


class CrossDataset:
    """Cross-matching image list (reference utils/data_partial.py:20-58)."""

    def __init__(self, data_dir: str, img_size: int):
        import pandas as pd
        name = Path(data_dir).name
        self.img_dir = Path(data_dir) / "imgs"
        info = pd.read_csv(str(self.img_dir / f"{name}.csv"), header=None)
        self.files = np.asarray(info.iloc[:, 0])
        self.labels = np.asarray(info.iloc[:, 1])
        self.img_size = img_size

    def __len__(self) -> int:
        return len(self.files)

    def batches(self, batch_size: int
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """((b, img_size, img_size, 3) normalised float32, (b,) labels)."""
        import cv2
        for s in range(0, len(self), batch_size):
            sel = self.files[s:s + batch_size]
            imgs = np.empty((len(sel), self.img_size, self.img_size, 3),
                            np.float32)
            for j, fname in enumerate(sel):
                img = cv2.imread(str(self.img_dir / fname), cv2.IMREAD_COLOR)
                if img is None:
                    raise IOError(f"failed to decode {self.img_dir / fname}")
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
                img = cv2.resize(img, (self.img_size, self.img_size),
                                 interpolation=cv2.INTER_LINEAR)
                imgs[j] = (img.astype(np.float32) / 255.0 - 0.5) / 0.5
            yield imgs, self.labels[s:s + batch_size]
