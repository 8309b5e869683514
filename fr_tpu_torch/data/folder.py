"""Training datasets: a class-per-directory image folder and an in-memory
corpus (counterpart of fr_tpu/data/folder.py).

``ImageFolderIndex`` scans ``<root>/imgs/<class>/*`` with the reference's
CustomImageFolder semantics (reference utils/data_partial.py:95-164,
torchvision DatasetFolder: classes sorted, labels by sorted order).
``TrainLoader`` decodes and resizes each batch to fixed-size uint8 on a
background thread, a few batches ahead; the augmentation runs on the device
in the training step. Every epoch draws a permutation seeded by
``seed + epoch`` (DistributedSampler.set_epoch, reference
utils/trainer.py:72) and drops the last partial batch (reference
utils/data_partial.py:271-278), so the batches are fr_tpu's.

Under several processes (the reference's DistributedSampler role,
utils/data_partial.py:273) ``batch_size`` is the global batch: every
process draws the same permutation, decodes only its contiguous slice of
each global batch, rows ``[process_index·b_loc, (process_index + 1)·b_loc)``,
and yields (local images, global labels). The labels come from the index,
not from decoding, so the whole vector costs nothing on every process; the
training step takes it whole.

Decoding takes the native threaded libjpeg pool (fr_tpu_torch/native) when
every file of a batch is a JPEG and the pool built, else cv2 per image.
"""

from __future__ import annotations

import os
import queue
import threading
from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm")


class ImageFolderIndex:
    """Scan of <root>/imgs/<class>/* (reference utils/data_partial.py:103-108)."""

    def __init__(self, root: str, subdir: str = "imgs"):
        base = Path(root) / subdir
        if not base.is_dir():
            base = Path(root)  # allow pointing directly at the class dirs
        self.root = str(base)
        classes = sorted(d.name for d in base.iterdir() if d.is_dir())
        if not classes:
            raise FileNotFoundError(f"no class directories under {base}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = base / c
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith(IMG_EXTENSIONS):
                    samples.append((str(cdir / f), self.class_to_idx[c]))
        if not samples:
            raise FileNotFoundError(f"no images under {base}")
        self.samples = samples

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def num_classes(self) -> int:
        return len(self.classes)


def _decode_resize(path: str, img_size: int) -> np.ndarray:
    """uint8 HWC RGB at img_size × img_size (cv2 decode, INTER_LINEAR)."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"failed to decode {path}")
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.shape[:2] != (img_size, img_size):
        img = cv2.resize(img, (img_size, img_size),
                         interpolation=cv2.INTER_LINEAR)
    return img


class TrainLoader:
    """Epoch iterator of (uint8 images (B/P, H, W, 3), int32 labels (B,)),
    decoded ``prefetch`` batches ahead on a background thread (the
    reference uses torch DataLoader workers, utils/data_partial.py:271-278).
    A decode error is raised again at the consumer; leaving the epoch early
    stops the thread. P = process_count (see the module docstring)."""

    def __init__(self, index: ImageFolderIndex, batch_size: int,
                 img_size: int, seed: int = 0, prefetch: int = 4,
                 process_index: int = 0, process_count: int = 1):
        _check_split(batch_size, process_count)
        self.index = index
        self.batch_size = batch_size
        self.img_size = img_size
        self.seed = seed
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count

    def steps_per_epoch(self) -> int:
        return len(self.index) // self.batch_size  # drop_last=True

    def _decode_batch(self, sel: np.ndarray) -> np.ndarray:
        paths = [self.index.samples[int(i)][0] for i in sel]
        if all(p.lower().endswith((".jpg", ".jpeg")) for p in paths):
            from fr_tpu_torch import native
            if native.jpeg_available():
                blobs = [Path(p).read_bytes() for p in paths]
                out = native.decode_jpegs_native(blobs, self.img_size)
                if out is not None:
                    return out
        imgs = np.empty((len(paths), self.img_size, self.img_size, 3),
                        np.uint8)
        for j, p in enumerate(paths):
            imgs[j] = _decode_resize(p, self.img_size)
        return imgs

    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = np.random.default_rng(self.seed + epoch).permutation(
            len(self.index))
        nsteps = self.steps_per_epoch()
        lo, hi = _local_rows(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # never block forever once the consumer has left the epoch
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for s in range(nsteps):
                    if stop.is_set():
                        return
                    sel = order[s * self.batch_size:(s + 1) * self.batch_size]
                    labels = np.array(
                        [self.index.samples[int(i)][1] for i in sel], np.int32)
                    if not put((self._decode_batch(sel[lo:hi]), labels)):
                        return
                put(None)
            except BaseException as e:  # raised again at the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True,
                             name="TrainLoader.epoch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


class ArrayTrainLoader:
    """In-memory training batches (synthetic data, tests): the same
    epoch-seeded permutation, whole batches only, and the same split over
    processes as TrainLoader."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError(f"uint8 NHWC images expected, got "
                             f"{images.dtype} {images.shape}")
        _check_split(batch_size, process_count)
        self.images = images
        self.labels = labels.astype(np.int32)
        self.batch_size = batch_size
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count

    def steps_per_epoch(self) -> int:
        return len(self.images) // self.batch_size

    def epoch(self, epoch: int):
        order = np.random.default_rng(self.seed + epoch).permutation(
            len(self.images))
        lo, hi = _local_rows(self)
        for s in range(self.steps_per_epoch()):
            sel = order[s * self.batch_size:(s + 1) * self.batch_size]
            yield self.images[sel[lo:hi]], self.labels[sel]


def _check_split(batch_size: int, process_count: int) -> None:
    if batch_size % process_count:
        raise ValueError(f"global batch {batch_size} does not split over "
                         f"{process_count} processes")


def _local_rows(loader) -> Tuple[int, int]:
    """[lo, hi): the process's rows of each global batch."""
    b_loc = loader.batch_size // loader.process_count
    return loader.process_index * b_loc, (loader.process_index + 1) * b_loc
