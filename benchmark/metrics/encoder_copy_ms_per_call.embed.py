"""Of the device milliseconds per embedding call launched inside
``embed:encoder``, those of the operations launched under an
``aten::copy_`` host operation on the launching thread: the casts and the
f32 round trips around BatchNorm."""

from benchmark import spans


def read(run):
    if run.kind != "embed":
        return None
    return spans.device_ms_per_step(run.trace, [spans.EMBED_ENCODER],
                                    copies=True)
