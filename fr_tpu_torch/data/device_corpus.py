"""Device-resident training corpus, striped over the ranks of a mesh
(counterpart of fr_tpu/data/device_corpus.py).

When the decoded corpus fits beside the model state in device memory, it
is uploaded once as a uint8 tensor and each batch is gathered on the device
with ``index_select``: no image byte crosses the host-device link on the hot
path.

Over P = ``process_count`` ranks the corpus is cut into P equal contiguous
blocks (the rows beyond ``(N // P) · P`` are left out) and rank r uploads
only block r, reading the host array a chunk at a time. Each epoch rank r
permutes its block with numpy seeded by ``(seed, epoch, r)``; step s takes
its ``batch_size // P`` images from that permutation and yields them with
the global label vector, every rank's labels of the step in rank order. The
rank order is ``Mesh.rank`` (data_idx · model + model_idx), fr_tpu's flat
device order of ``P(('data', 'model'))``, so rank r's images are device r's
rows of fr_tpu's global batch and the labels are fr_tpu's. An epoch uploads
the rank's permutation and the epoch's global labels once (a few MB at
MS1M); a step only slices them on the device.

The stripes depend on P: a run resumed at another world size draws other
batches from the same epoch on, as fr_tpu does at another device count.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from fr_tpu_torch.data.folder import _check_split
from fr_tpu_torch.utils.profiling import DATA_BATCH, DATA_EPOCH, span

# rows per host → device copy of the upload: a memory-mapped corpus is
# read a chunk at a time, never whole into host memory
_UPLOAD_ROWS = 4096


class DeviceCorpusLoader:
    """Epoch iterator of device-resident (uint8 images (B/P, H, W, 3),
    int32 labels (B,)) batches, directly consumable by the training step.

    images: (N, H, W, 3) uint8 host array (e.g. PackedTrainLoader's memmap);
    labels: (N,) int labels; ``batch_size`` is the global batch B; P =
    ``process_count`` (see the module docstring). ``device`` defaults to
    CUDA.
    """

    device_resident = True  # the Trainer skips its host → device prefetch

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, seed: int = 0, device="cuda",
                 process_index: int = 0, process_count: int = 1):
        _check_split(batch_size, process_count)
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.b_loc = batch_size // process_count
        self.n_loc = len(labels) // process_count
        n_use = self.n_loc * process_count
        # (P, n_loc): block r's labels in row r
        self.host_labels = np.asarray(labels[:n_use]).astype(
            np.int32).reshape(process_count, self.n_loc)
        self._num_classes = int(self.host_labels.max()) + 1
        lo = process_index * self.n_loc
        self.images = torch.empty((self.n_loc,) + tuple(images.shape[1:]),
                                  dtype=torch.uint8, device=self.device)
        for s in range(0, self.n_loc, _UPLOAD_ROWS):
            rows = np.array(images[lo + s:lo + min(s + _UPLOAD_ROWS,
                                                   self.n_loc)], np.uint8)
            self.images[s:s + len(rows)].copy_(torch.from_numpy(rows))

    @property
    def num_classes(self) -> int:
        return self._num_classes

    def steps_per_epoch(self) -> int:
        return self.n_loc // self.b_loc

    def epoch(self, epoch: int) -> Iterator[Tuple[torch.Tensor,
                                                  torch.Tensor]]:
        steps, b = self.steps_per_epoch(), self.b_loc
        with span(DATA_EPOCH):
            # every rank's permutation of its block (the labels need them
            # all)
            perms = np.stack([
                np.random.default_rng((self.seed, epoch, r)).permutation(
                    self.n_loc) for r in range(self.process_count)])
            used = perms[:, :steps * b]
            # (steps, B): step s's labels, rank 0's b first
            labels = np.take_along_axis(self.host_labels, used, axis=1)
            labels = labels.reshape(self.process_count, steps, b).transpose(
                1, 0, 2).reshape(steps, self.batch_size)
            order = torch.from_numpy(used[self.process_index]).to(
                self.device)
            labels = torch.from_numpy(np.ascontiguousarray(labels)).to(
                self.device)
        for s in range(steps):
            # the span closes before the yield: the consumer's step is not
            # the loader's
            with span(DATA_BATCH):
                batch = (self.images.index_select(
                    0, order[s * b:(s + 1) * b]), labels[s])
            yield batch
