"""Device milliseconds per embedding call of the operations launched inside
the call's ``embed:encoder`` span: the encoder in eval mode and the L2
normalisation."""

from benchmark import spans


def read(run):
    if run.kind != "embed":
        return None
    return spans.device_ms_per_step(run.trace, [spans.EMBED_ENCODER])
