"""Device milliseconds per training step of the operations launched inside
the step's ``encoder:forward`` span: the encoder in train mode, its cast
to f32 and the L2 normalisation (``spans.device_ms_per_step``)."""

from benchmark import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.device_ms_per_step(run.trace, [spans.ENCODER_FORWARD])
