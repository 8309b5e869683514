"""Encoder dispatch by conf.network substring, in fr_tpu's order
(counterpart of fr_tpu/models/__init__.py)."""

from fr_tpu_torch.models.alternet import build_alternet
from fr_tpu_torch.models.effialternet import build_effialternet
from fr_tpu_torch.models.resnet import build_resnet
from fr_tpu_torch.models.swinv2 import build_swin


def build_encoder(conf):
    name = conf.network
    if "EffiAlter" in name:
        return build_effialternet(conf)
    if "AlterNetV1" in name or "AlterNetSep" in name:
        raise NotImplementedError(
            f"{name} is not ported yet: ROADMAP §1 slice 6 "
            f"(retired variants)")
    if "AlterNet" in name:
        return build_alternet(conf)
    if "Swin" in name:
        return build_swin(conf)
    if "ResNet" in name:
        return build_resnet(conf)
    raise ValueError(f"Unknown network {conf.network!r}")
