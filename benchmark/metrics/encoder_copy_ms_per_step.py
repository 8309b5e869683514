"""Of the device milliseconds per training step launched inside
``encoder:forward`` and ``encoder:backward``, those of the operations
launched under an ``aten::copy_`` host operation on the launching thread:
the casts of the convolutions' weights to the activations' dtype, and any
other copy the encoder makes (BatchNorm, a hand-written kernel in the
activations' dtype, casts nothing)."""

from benchmark import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.device_ms_per_step(
        run.trace, [spans.ENCODER_FORWARD, spans.ENCODER_BACKWARD],
        copies=True)
