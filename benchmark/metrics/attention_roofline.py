"""The global attention's share of its roofline, in %: the least time of
the encoder's ``depth`` attention layers, forward and backward, over the
device time per step under ``encoder:attention``.

Per layer, at batch B, H heads of width d_h, D = H·d_h and L tokens (the
tokens the blocks see in training, int(N·(1 − mask_ratio)) of the N
patches), the least time is the larger of 12·B·H·L²·d_h FLOPs (q·kᵀ and
·v forward, their four products backward) at the card's bf16 peak and
24·B·L·D bytes at its peak bandwidth: bf16 q, k and v read and o written
forward; q, k, v, o and the output's gradient read and dq, dk and dv
written backward. None where the span never opened or the configuration
has no such layers."""

from benchmark import spans

ENCODER_ATTENTION = "encoder:attention"


def least_s(model: dict, batch: int, peak: dict) -> float:
    n = (model["img_size"] // model["patch"]) ** 2
    tokens = int(n * (1 - model["mask_ratio"]))
    d = model["embed_dim"]
    flops = 12.0 * batch * tokens * tokens * d
    nbytes = 24.0 * batch * tokens * d
    return model["depth"] * max(flops / peak["bf16_flops"],
                                nbytes / peak["bytes_per_s"])


def read(run):
    if run.kind != "train" or run.peak is None:
        return None
    model = run.cfg["model"]
    if not {"patch", "embed_dim", "depth", "mask_ratio"} <= set(model):
        return None
    ms = spans.device_ms_per_step(run.trace, [ENCODER_ATTENTION])
    if not ms:
        return None
    return 100.0 * least_s(model, run.cfg["batch_size"], run.peak) / (
        ms / 1e3)
