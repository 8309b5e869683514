"""The embedding step's share of the card's dense bf16 peak: the window's
images per second × the configuration's forward FLOPs per image."""

from benchmark import yardstick as ys


def read(run):
    if run.kind != "embed" or run.peak is None:
        return None
    return ys.mfu(run.cfg["fwd_flops_per_img"], run.window["rate"], run.peak)
