"""Images embedded in the window over the window's host-clock length."""


def read(run):
    return run.window["rate"] if run.kind == "embed" else None
