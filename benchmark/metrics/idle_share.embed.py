"""1 − the device's busy time per call (the union of its operations'
intervals over the traced calls) ÷ the host-clock time per call of the
unprofiled window: the share of a timed call in which the card idles.
The profiler's own cost lengthens the traced calls' wall time, not the
device's operations, so the wall comes from the window."""


def read(run):
    if run.kind != "embed" or run.trace is None or not run.trace.kernels:
        return None
    busy = run.trace.busy_s / run.trace.steps
    wall = run.window["elapsed"] / run.window["steps"]
    return 1.0 - busy / wall
