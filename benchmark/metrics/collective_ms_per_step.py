"""Device milliseconds per training step in which a collective's kernel
(NCCL's, by name) ran on the card of rank 0, whichever span launched it:
the union of their intervals over the traced steps. A collective's kernel
runs from its launch on this card until the last rank has joined, so the
time holds the wait for the slowest rank too. None where the trace holds
no such kernel, as on one card."""

from benchmark import yardstick as ys


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    mine, _ = ys.collective_kernels(run.trace.kernels)
    if not mine:
        return None
    return 1e3 * ys.busy_s(mine) / run.trace.steps
