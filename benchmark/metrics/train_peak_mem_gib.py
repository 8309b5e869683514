"""``torch.cuda.max_memory_allocated()`` over the training window (reset
at its start, the state resident), in GiB."""


def read(run):
    if run.kind != "train" or not run.peak_bytes:
        return None
    return run.peak_bytes / 2 ** 30
