"""Device operations (kernels, copies, sets) per training step in the
traced steps."""


def read(run):
    if run.kind != "train" or run.trace is None or not run.trace.kernels:
        return None
    return len(run.trace.kernels) / run.trace.steps
