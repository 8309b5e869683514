"""Of the device milliseconds per training step launched inside
``encoder:forward`` and ``encoder:backward``, those of the operations
launched under an ``aten::copy_`` host operation on the launching thread:
the casts and the f32 round trips around BatchNorm."""

from benchmark import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.device_ms_per_step(
        run.trace, [spans.ENCODER_FORWARD, spans.ENCODER_BACKWARD],
        copies=True)
