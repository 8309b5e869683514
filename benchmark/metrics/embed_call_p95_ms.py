"""The 95th percentile over all calls of the window of a call's host-clock
milliseconds, from the host copy in to the embeddings back on the
host."""

from benchmark import yardstick as ys


def read(run):
    if run.kind != "embed":
        return None
    return 1e3 * ys.percentile(run.window["latencies"], 95)
