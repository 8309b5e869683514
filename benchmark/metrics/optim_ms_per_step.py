"""Device milliseconds per training step of the operations launched inside
the step's ``optim:encoder`` span: the global-norm clip and the encoder's
update."""

from benchmark import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.device_ms_per_step(run.trace, [spans.OPTIM_ENCODER])
