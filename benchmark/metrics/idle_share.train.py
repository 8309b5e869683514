"""1 − the device's busy time per step (the union of its operations'
intervals over the traced steps) ÷ the host-clock time per step of the
unprofiled window: the share of a timed step in which the card idles.
The profiler's own cost lengthens the traced steps' wall time, not the
device's operations, so the wall comes from the window."""


def read(run):
    if run.kind != "train" or run.trace is None or not run.trace.kernels:
        return None
    busy = run.trace.busy_s / run.trace.steps
    wall = run.window["elapsed"] / run.window["steps"]
    return 1.0 - busy / wall
