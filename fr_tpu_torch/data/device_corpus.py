"""Device-resident training corpus for one device (counterpart of
fr_tpu/data/device_corpus.py with a mesh of one).

When the decoded corpus fits beside the model state in device memory, it
is uploaded once as a uint8 tensor and each batch is gathered on the device
with ``index_select``: no image byte crosses the host-device link on the hot
path. Each epoch uploads its permutation once (KBs); a step only slices it.
The permutation is fr_tpu's numpy draw seeded by ``(seed, epoch, 0)``, so
the batches are fr_tpu's. Striping the corpus over several devices is
multi-GPU work (ROADMAP §1, multi-GPU).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

# rows per host → device copy of the upload: a memory-mapped corpus is
# read a chunk at a time, never whole into host memory
_UPLOAD_ROWS = 4096


class DeviceCorpusLoader:
    """Epoch iterator of device-resident (uint8 images (b, H, W, 3), int32
    labels (b,)) batches, directly consumable by the training step.

    images: (N, H, W, 3) uint8 host array (e.g. PackedTrainLoader's memmap);
    labels: (N,) int labels. ``device`` defaults to CUDA.
    """

    device_resident = True  # the Trainer skips its host → device prefetch

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.seed = seed
        host_labels = np.asarray(labels).astype(np.int32)
        self._num_classes = int(host_labels.max()) + 1
        self.n = len(host_labels)
        self.images = torch.empty((self.n,) + tuple(images.shape[1:]),
                                  dtype=torch.uint8, device=self.device)
        for s in range(0, self.n, _UPLOAD_ROWS):
            rows = np.array(images[s:s + _UPLOAD_ROWS], np.uint8)
            self.images[s:s + len(rows)].copy_(torch.from_numpy(rows))
        self.labels = torch.from_numpy(host_labels).to(self.device)

    @property
    def num_classes(self) -> int:
        return self._num_classes

    def steps_per_epoch(self) -> int:
        return self.n // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Tuple[torch.Tensor,
                                                  torch.Tensor]]:
        perm = np.random.default_rng((self.seed, epoch, 0)).permutation(
            self.n)
        order = torch.from_numpy(perm).to(self.device)
        b = self.batch_size
        for s in range(self.steps_per_epoch()):
            idx = order[s * b:(s + 1) * b]
            yield (self.images.index_select(0, idx),
                   self.labels.index_select(0, idx))
