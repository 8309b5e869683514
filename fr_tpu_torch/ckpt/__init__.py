"""Full training-state checkpoints of the port (counterpart of
fr_tpu/ckpt)."""

from fr_tpu_torch.ckpt.checkpoint import (latest_step, restore_train_state,
                                          save_train_state)

__all__ = ["latest_step", "restore_train_state", "save_train_state"]
