"""The whole training step's share of the cards' dense bf16 peak: the
window's images per second (the traced run's unprofiled steps, every
rank's images on a mesh) × (3 × the configuration's forward FLOPs + 6·D·n
of the head over its n sampled columns, every shard's), over the peak of
as many cards as the configuration's mesh holds."""

from benchmark import yardstick as ys


def read(run):
    if run.kind != "train" or run.peak is None:
        return None
    return ys.mfu(ys.train_flops_per_img(run.cfg), run.window["rate"],
                  run.peak) / ys.chips(run.cfg)
