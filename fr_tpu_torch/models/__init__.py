"""Encoder dispatch by conf.network substring, in fr_tpu's order
(counterpart of fr_tpu/models/__init__.py)."""

from fr_tpu_torch.models.alternet import build_alternet, build_alternet_sep
from fr_tpu_torch.models.alternet_v1 import build_alternet_v1
from fr_tpu_torch.models.effialternet import build_effialternet
from fr_tpu_torch.models.resnet import build_resnet
from fr_tpu_torch.models.swinv2 import build_swin


def build_encoder(conf):
    name = conf.network
    if "EffiAlter" in name:
        return build_effialternet(conf)
    if "AlterNetV1" in name:
        return build_alternet_v1(conf)
    if "AlterNetSep" in name:
        return build_alternet_sep(conf)
    if "AlterNet" in name:
        return build_alternet(conf)
    if "Swin" in name:
        return build_swin(conf)
    if "ResNet" in name:
        return build_resnet(conf)
    raise ValueError(f"Unknown network {conf.network!r}")
