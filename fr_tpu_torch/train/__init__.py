"""Training and embedding steps, optimizers, schedule, state, task and
trainer of the port (counterpart of fr_tpu/train)."""
