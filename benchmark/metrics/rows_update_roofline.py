"""The sampled rows' SGD update's share of its roofline, in %: 5·n·D·4
bytes at the card's peak bandwidth (``yardstick.rows_update_least_s``)
over the device time per step under ``pfc_head:update``."""

from benchmark import yardstick as ys


def read(run):
    if run.kind != "train" or run.trace is None or run.peak is None:
        return None
    ms = run.trace.head_ms.get("update", 0.0)
    if ms <= 0:
        return None
    head = run.cfg["head"]
    least = ys.rows_update_least_s(head["sampled_columns"],
                                   head["emd_size"], run.peak)
    return 100.0 * least / (ms / 1e3)
