"""The whole training step's share of the card's dense bf16 peak: the
window's images per second (the traced run's unprofiled steps) × (3 × the
configuration's forward FLOPs + 6·D·n of the head over its n sampled
columns)."""

from benchmark import yardstick as ys


def read(run):
    if run.kind != "train" or run.peak is None:
        return None
    return ys.mfu(ys.train_flops_per_img(run.cfg), run.window["rate"],
                  run.peak)
