"""Device milliseconds per training step of the operations launched inside
the program's ``encoder:attention`` spans: every global attention's
forward and backward (``spans.device_ms_per_step``). None where the span
never opened, as in an encoder without global attention."""

from benchmark import spans

ENCODER_ATTENTION = "encoder:attention"


def read(run):
    if run.kind != "train":
        return None
    return spans.device_ms_per_step(run.trace, [ENCODER_ATTENTION])
