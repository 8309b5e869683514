"""Device milliseconds per training step of the operations launched inside
the step's ``data:augment`` span: the on-device augmentation of the uint8
batch."""

from benchmark import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.device_ms_per_step(run.trace, [spans.AUGMENT])
