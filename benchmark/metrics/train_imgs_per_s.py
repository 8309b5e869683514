"""Images of the training steps completed in the window over the window's
host-clock length, closed by a synchronise."""


def read(run):
    return run.window["rate"] if run.kind == "train" else None
