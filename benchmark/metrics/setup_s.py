"""Seconds from the harness's start to the first timed step: loading,
building the program's kernels where none are built, making the inputs
and warming the cell's shapes."""


def read(run):
    return run.setup_s
