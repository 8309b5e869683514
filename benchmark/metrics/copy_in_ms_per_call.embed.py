"""Device milliseconds per embedding call of the operations launched inside
the call's ``embed:copy_in`` span: the host-to-device copy of the f32
images, and the resize where their size is not the encoder's."""

from benchmark import spans


def read(run):
    if run.kind != "embed":
        return None
    return spans.device_ms_per_step(run.trace, [spans.EMBED_COPY_IN])
