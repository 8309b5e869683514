"""The ('data', 'model') mesh over torch.distributed and its collectives
(counterpart of fr_tpu/parallel)."""

from fr_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                        local_class_slice, make_mesh,
                                        pad_classes)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "local_class_slice",
           "make_mesh", "pad_classes"]
