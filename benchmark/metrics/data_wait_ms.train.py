"""Host milliseconds per training step spent in the loader's ``next()``
(``data/device_corpus.py``), on the benchmark's clock, over the window."""


def read(run):
    if run.kind != "train":
        return None
    waits = run.window["waits"]
    return 1e3 * sum(waits) / len(waits)
