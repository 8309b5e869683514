"""The drawn rows' AdamW update's share of its roofline, in %: 7·n·D·4
bytes at the card's peak bandwidth (the f32 rows and both slots read and
written, the row gradient read, n the drawn columns and D the embedding
width) over the device time per step under ``pfc_head:update``. None for
another optimizer, or where the span recorded nothing."""


def least_s(n: int, d: int, peak: dict) -> float:
    return 7.0 * n * d * 4 / peak["bytes_per_s"]


def read(run):
    if (run.kind != "train" or run.trace is None or run.peak is None
            or run.cfg["optimizer"]["name"] != "AdamW"):
        return None
    ms = run.trace.head_ms.get("update", 0.0)
    if ms <= 0:
        return None
    head = run.cfg["head"]
    return 100.0 * least_s(head["sampled_columns"], head["emd_size"],
                           run.peak) / (ms / 1e3)
