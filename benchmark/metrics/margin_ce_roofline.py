"""The margin-softmax CE's share of its roofline, in %: its least time at
the batch, the sampled columns and the embedding width
(``yardstick.margin_ce_least_s``) over the device time per step under
``pfc_head:loss`` and ``pfc_head:backward``, less the collectives' kernels
launched there (on a mesh the embeddings' all-gather, the softmax's
``pmax``/``psum`` and the reduce-scatter, with their waits for the
slowest rank; none on one card). On a mesh it is rank 0's: the batch of
every rank of its model group, gathered, against its own shard's
columns."""

from benchmark import yardstick as ys


def read(run):
    if run.kind != "train" or run.trace is None or run.peak is None:
        return None
    mine, rest = ys.collective_kernels(run.trace.kernels)
    head = (ys.head_ms(run.trace.events, rest, run.trace.steps) if mine
            else run.trace.head_ms)
    ms = head.get("loss", 0.0) + head.get("backward", 0.0)
    if ms <= 0:
        return None
    cfg = run.cfg["head"]
    rows = run.cfg["batch_size"] * ys.mesh(run.cfg)[1]
    least = ys.margin_ce_least_s(rows, cfg["sampled_columns"],
                                 cfg["emd_size"], run.peak)
    return 100.0 * least / (ms / 1e3)
