"""The margin-softmax CE's share of its roofline, in %: its least time at
the batch, the sampled columns and the embedding width
(``yardstick.margin_ce_least_s``) over the device time per step under
``pfc_head:loss`` and ``pfc_head:backward``."""

from benchmark import yardstick as ys


def read(run):
    if run.kind != "train" or run.trace is None or run.peak is None:
        return None
    ms = run.trace.head_ms.get("loss", 0.0) + run.trace.head_ms.get(
        "backward", 0.0)
    if ms <= 0:
        return None
    head = run.cfg["head"]
    least = ys.margin_ce_least_s(run.cfg["batch_size"],
                                 head["sampled_columns"], head["emd_size"],
                                 run.peak)
    return 100.0 * least / (ms / 1e3)
