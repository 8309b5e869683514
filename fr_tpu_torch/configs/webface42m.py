"""WebFace42M-scale training config (the reference's largest dataset point:
2,059,906 identities, reference configs/ms1m_arcface_122.py:22-26), with
PartialFC negative sampling at rate 0.1 (the insightface convention for this
scale) and the fused loss kernel."""

from fr_tpu_torch.configs.base import N_CLASSES
from fr_tpu_torch.configs.ms1m_arcface_122 import make_config as _base


def make_config():
    conf = _base()
    conf.train_dataset = "webface42m"
    conf.n_classes = N_CLASSES["webface42m"]
    conf.sample_rate = 0.1
    conf.network = "ResNet100"
    conf.num_epoch = 20
    return conf
