"""Config system: the port's own copy of fr_tpu/configs/base.py, kept
identical in behaviour (including the re-flatten in ``load_config`` that
resets a config module's own table keys, ROADMAP §3), so that the port
imports nothing of fr_tpu.

Mirrors the reference's config semantics (reference configs/ms1m_arcface_122.py):
a flat attribute-dict ``conf`` plus per-choice tables for network / loss /
optimizer / scheduler, and a ``generate_config`` that flattens the chosen
table entries into the flat conf (reference configs/ms1m_arcface_122.py:266-274).

We use a small local ``Config`` attrdict instead of easydict (not installed),
and dataclass-free plain dicts so configs stay trivially serialisable.
"""

from __future__ import annotations

import copy
import importlib
from typing import Any


class Config(dict):
    """Attribute-style dict (drop-in for the reference's easydict usage)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def copy(self) -> "Config":
        return Config(copy.deepcopy(dict(self)))

    def pretty(self) -> str:
        return "\n".join(f"{k}: {v}" for k, v in sorted(self.items()))


# Registry of valid choices (reference configs/ms1m_arcface_122.py:6-15).
NETWORKS = [
    "ResNet18", "ResNet34", "ResNet50", "ResNet100", "ResNet200",
    "AlterNet18", "AlterNet34", "AlterNet50", "AlterNet100", "AlterNet200",
    "AlterNetV1_18", "AlterNetV1_34", "AlterNetV1_50", "AlterNetV1_100",
    "AlterNetV1_200",
    "AlterNetSep18", "AlterNetSep34", "AlterNetSep50", "AlterNetSep100",
    "AlterNetSep200",
    "Swin18", "Swin34", "Swin50", "Swin100", "Swin200",
    "EffiAlter_s", "EffiAlter_m", "EffiAlter_l", "EffiAlter_xl",
    # the port's own: insightface's ViT-L and a tiny preset for tests
    # (models/vit.py), which fr_tpu lacks
    "ViT_L", "ViT_T",
]
LOSSES = ["ArcFace", "CosFace", "PartialFC"]
METRICS = ["ArcFace"]
OPTIMIZERS = ["SGD", "AdamW"]

# Dataset registry with class counts (reference configs/ms1m_arcface_122.py:22-26).
N_CLASSES = {
    "webface42m": 2059906,
    "lfw": 5749,
    "ms1m_arcface_122": 86690,
    "synthetic": 1000,
}
VAL_DATA = ["lfw", "agedb_30", "cfp_fp", "cfp_ff", "calfw", "cplfw", "synthetic"]


def loss_table() -> Config:
    """Per-loss hyperparameter tables (reference configs/ms1m_arcface_122.py:169-192)."""
    t = Config()
    t.ArcFace = Config(loss_name="ArcFace", emd_size=512, loss_s=30.0,
                       loss_m=0.35, easy_margin=False)
    t.CosFace = Config(loss_name="CosFace", emd_size=512, loss_s=30.0,
                       loss_m=0.35)
    t.PartialFC = Config(loss_name="PartialFC", emd_size=512, loss_s=30.0,
                         loss_m=0.35, sample_rate=1.0)
    return t


def optimizer_table() -> Config:
    """Per-optimizer tables (reference configs/ms1m_arcface_122.py:196-224)."""
    t = Config()
    t.SGD = Config(optimizer_name="SGD", wd=5e-4, mom=0.9)
    t.AdamW = Config(optimizer_name="AdamW", wd=5e-4, eps=1e-8,
                     betas=(0.9, 0.999))
    return t


def scheduler_table(lr: float) -> Config:
    """Per-scheduler tables (reference configs/ms1m_arcface_122.py:228-262)."""
    t = Config()
    t.CosineAnnealingWarmupRestarts = Config(warmup_steps=5, min_lr=lr / 1000)
    t.CosineAnnealingLR = Config(warmup_steps=0, min_lr=lr / 1000)
    t.MultiStep = Config(lr_decay_epoch=[8, 12, 16, 20, 40], lr_decay_ratio=0.95)
    t.StepLR = Config(lr_decay_epoch_size=500, lr_decay_ratio=0.5)
    return t


def network_table() -> Config:
    t = Config()
    for name in NETWORKS:
        t[name] = Config(network_name=name)
    return t


def generate_config(conf: Config, network: str, loss: str, optimizer: str,
                    scheduler: str) -> Config:
    """Flatten the chosen table entries into the flat conf.

    Same flattening order as the reference (loss → optimizer → network →
    scheduler, reference configs/ms1m_arcface_122.py:266-274) so later tables
    override earlier keys identically.
    """
    for k, v in loss_table()[loss].items():
        conf[k] = v
    for k, v in optimizer_table()[optimizer].items():
        conf[k] = v
    for k, v in network_table()[network].items():
        conf[k] = v
    for k, v in scheduler_table(conf.lr)[scheduler].items():
        conf[k] = v
    return conf


def validate(conf: Config) -> None:
    assert conf.network in NETWORKS, f"Invalid model {conf.network!r}"
    assert conf.loss in LOSSES, f"Invalid loss {conf.loss!r}"
    assert conf.optimizer in OPTIMIZERS, f"Invalid optimizer {conf.optimizer!r}"
    assert conf.min_level <= conf.security_level <= conf.max_level


def default_img_size(network: str) -> int:
    """AlterNet hybrids use a stride-2 stem, hence 192px; everything else 112
    (reference main/main.py:102). The Seperate ablation variant
    (nets/AlterNet_SwinV2_FAN_Seperate.py) has a stride-1 stem and window-7
    blocks at stage resolutions 56/28/14/7, so it is a 112px network."""
    if "AlterNetSep" in network:
        return 112
    return 192 if "AlterNet" in network else 112


def load_config(name: str, **overrides: Any) -> Config:
    """Load ``fr_tpu_torch.configs.<name>`` by name (reference main/main.py:81) and
    apply CLI-style overrides (CLI wins over config, reference main/main.py:81-102)."""
    mod = importlib.import_module(f"fr_tpu_torch.configs.{name}")
    conf = mod.make_config()
    for k, v in overrides.items():
        if v is not None:
            conf[k] = v
    assert conf.network in NETWORKS, f"Invalid model {conf.network!r}"
    assert conf.loss in LOSSES, f"Invalid loss {conf.loss!r}"
    assert conf.optimizer in OPTIMIZERS, f"Invalid optimizer {conf.optimizer!r}"
    # Re-flatten in case network/loss/optimizer choices were overridden —
    # then re-apply the overrides: the tables carry defaults for keys the
    # CLI may set (sample_rate, loss_s, ...) and CLI wins over config
    # (reference main/main.py:81-102 sets args after the config module's
    # generate_config ran at import).
    generate_config(conf, conf.network, conf.loss, conf.optimizer,
                    conf.lr_scheduler)
    for k, v in overrides.items():
        if v is not None:
            conf[k] = v
    if "img_size" not in conf or conf.img_size is None:
        conf.img_size = default_img_size(conf.network)
    if "min_lr" not in conf:
        conf.min_lr = conf.lr / 1000
    validate(conf)
    return conf
