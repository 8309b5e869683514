"""The ('data', 'model') device mesh over torch.distributed (counterpart of
fr_tpu/parallel/mesh.py).

One process drives one device, as torchrun launches them. The mesh is
fr_tpu's:

    ('data', 'model')

- the global batch is split over the whole mesh (both axes flattened, rank
  order), each rank holding rows ``[rank·b_loc, (rank + 1)·b_loc)``;
- the classifier's class axis is split over 'model' and replicated over
  'data';
- the reference topology is data = 1, model = every device.

A rank sits at ``(data_idx, model_idx)`` with ``rank = data_idx·model +
model_idx``, the order of fr_tpu's ``np.asarray(devices).reshape(data,
model)``. The mesh holds three process groups: the model group (the ranks of
its data row), the data group (the ranks of its model column) and the
world. A group of one rank is None, so a (1, 1) mesh needs no process group
and runs without ``init_process_group``; every collective of
parallel/collectives.py is the identity on None.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_shape(n: int, data: Optional[int] = None,
               model: Optional[int] = None) -> Tuple[int, int]:
    """(data, model) for n devices, with fr_tpu's defaults: model = n,
    data = 1; one of them given, the other is n divided by it."""
    if model is None and data is None:
        data, model = 1, n
    elif model is None:
        model = n // data
    elif data is None:
        data = n // model
    assert data * model == n, f"mesh {data}x{model} != {n} devices"
    return data, model


def mesh_coords(rank: int, model: int) -> Tuple[int, int]:
    """(data_idx, model_idx) of a rank."""
    return divmod(rank, model)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the mesh and its three process groups (None
    where the group has one rank)."""
    data: int
    model: int
    data_idx: int = 0
    model_idx: int = 0
    model_group: Optional[object] = None
    data_group: Optional[object] = None
    world_group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def rank(self) -> int:
        return self.data_idx * self.model + self.model_idx


def make_mesh(data: Optional[int] = None,
              model: Optional[int] = None) -> Mesh:
    """The mesh over the initialised process group's ranks, or over the one
    device of a process without one. Every rank calls it, in the same
    order, because each group is created by all ranks."""
    import torch.distributed as dist

    world = (dist.get_world_size() if dist.is_available()
             and dist.is_initialized() else 1)
    data, model = mesh_shape(world, data, model)
    if world == 1:
        return Mesh(data, model)
    rank = dist.get_rank()
    didx, midx = mesh_coords(rank, model)
    model_group = data_group = None
    for d in range(data):
        ranks = [d * model + m for m in range(model)]
        group = dist.new_group(ranks) if model > 1 else None
        if d == didx:
            model_group = group
    for m in range(model):
        ranks = [d * model + m for d in range(data)]
        group = dist.new_group(ranks) if data > 1 else None
        if m == midx:
            data_group = group
    return Mesh(data, model, didx, midx, model_group, data_group,
                dist.group.WORLD)


def local_class_slice(num_classes_padded: int, model_size: int,
                      model_idx: int) -> Tuple[int, int]:
    """(class_start, num_local) of a model shard: an equal split of the
    padded class count."""
    num_local = num_classes_padded // model_size
    return model_idx * num_local, num_local


def pad_classes(num_classes: int, model_size: int) -> int:
    """The class count rounded up to a multiple of the model axis."""
    return ((num_classes + model_size - 1) // model_size) * model_size
