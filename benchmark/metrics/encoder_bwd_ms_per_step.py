"""Device milliseconds per training step of the operations launched inside
the step's ``encoder:backward`` span: the encoder's gradients from the
embeddings' gradient, launched by the autograd engine's thread."""

from benchmark import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.device_ms_per_step(run.trace, [spans.ENCODER_BACKWARD])
