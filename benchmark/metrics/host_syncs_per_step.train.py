"""Blocking runtime calls per training step (``spans.SYNC_CALLS``: stream,
device and event synchronises, synchronous copies) that start inside the
step's ``train_step`` span: each holds the host until the device has
drained the work before it, and none can be captured in a CUDA graph."""

from benchmark import spans


def read(run):
    if run.kind != "train" or run.trace is None or not run.trace.kernels:
        return None
    found = spans.host_syncs(run.trace.events)
    return None if found is None else len(found) / run.trace.steps
