"""Host milliseconds per ``training_step`` call, on the benchmark's clock
with no synchronise, over the window: the host's share of a step that the
host paces."""


def read(run):
    if run.kind != "train":
        return None
    hosts = run.window["hosts"]
    return 1e3 * sum(hosts) / len(hosts)
