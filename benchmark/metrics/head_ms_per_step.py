"""Device milliseconds per step of the operations launched inside the
training step's ``pfc_head:*`` ranges (rows, loss, backward, update)."""


def read(run):
    if run.kind != "train" or run.trace is None or not run.trace.head_ms:
        return None
    return sum(run.trace.head_ms.values())
