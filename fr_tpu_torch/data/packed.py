"""Packed training corpus: pre-decoded uint8 images in a memory-mapped file
(counterpart of fr_tpu/data/packed.py, on one process).

Packing decodes a CustomImageFolder corpus once; training then
memory-maps ``images.npy`` (N, H, W, 3) uint8 and gathers each batch with
the native threaded ``gather_u8`` (fr_tpu_torch/native), or numpy's
indexing without it, with no decode on the hot path.

Layout under <root>/:
    images.npy   (N, H, W, 3) uint8, C-order  (np.lib.format, memmap-able)
    labels.npy   (N,) int32
    classes.json list of class names (index = label)
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np


def pack_image_folder(src_root: str, dst_root: str, img_size: int,
                      log_every: int = 1000) -> int:
    """Convert a CustomImageFolder-layout corpus (<src>/imgs/<class>/*) into
    the packed format, decoding with cv2. Returns the number of images."""
    from fr_tpu_torch.data.folder import ImageFolderIndex, _decode_resize

    index = ImageFolderIndex(src_root)
    dst = Path(dst_root)
    dst.mkdir(parents=True, exist_ok=True)
    n = len(index)
    images = np.lib.format.open_memmap(
        str(dst / "images.npy"), mode="w+", dtype=np.uint8,
        shape=(n, img_size, img_size, 3))
    labels = np.empty(n, np.int32)
    for i, (path, lab) in enumerate(index.samples):
        images[i] = _decode_resize(path, img_size)
        labels[i] = lab
        if log_every and (i + 1) % log_every == 0:
            print(f"packed {i + 1}/{n}")
    images.flush()
    np.save(str(dst / "labels.npy"), labels)
    (dst / "classes.json").write_text(json.dumps(index.classes))
    return n


class PackedTrainLoader:
    """Epoch iterator over a packed corpus: the epoch-seeded permutation
    (DistributedSampler.set_epoch, reference utils/trainer.py:72), whole
    batches, each batch's rows read in sorted order."""

    def __init__(self, root: str, batch_size: int, seed: int = 0):
        root_p = Path(root)
        self.images = np.load(str(root_p / "images.npy"), mmap_mode="r")
        self.labels = np.load(str(root_p / "labels.npy"))
        classes_file = root_p / "classes.json"
        self.classes = (json.loads(classes_file.read_text())
                        if classes_file.exists() else None)
        self.batch_size = batch_size
        self.seed = seed

    @property
    def num_classes(self) -> int:
        if self.classes is not None:
            return len(self.classes)
        return int(self.labels.max()) + 1

    def steps_per_epoch(self) -> int:
        return len(self.labels) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        from fr_tpu_torch import native
        order = np.random.default_rng(self.seed + epoch).permutation(
            len(self.labels))
        bs = self.batch_size
        for s in range(self.steps_per_epoch()):
            sel = np.sort(order[s * bs:(s + 1) * bs])  # sequential reads
            imgs = native.gather_u8_native(self.images, sel)
            if imgs is None:
                imgs = np.ascontiguousarray(self.images[sel])
            yield imgs, self.labels[sel].astype(np.int32)
