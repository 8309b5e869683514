"""Of ``collective_ms_per_step``, the device milliseconds per training step
in which no other operation ran on that card: the collectives' time that
no compute hides. None where the trace holds no collective's kernel."""

from benchmark import yardstick as ys


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    mine, rest = ys.collective_kernels(run.trace.kernels)
    if not mine:
        return None
    return 1e3 * (ys.busy_s(mine) - ys.overlap_s(mine, rest)) \
        / run.trace.steps
