"""Data of the port (counterpart of fr_tpu/data): the on-device
augmentation, the training loaders (image folder, packed corpus,
device-resident corpus, in-memory arrays), the validation and test
datasets, and synthetic data. ``augment_batch`` is the port's ``augment``
(images, cfg, generator): torch draws from an explicit generator where
fr_tpu's takes a jax key."""

from fr_tpu_torch.data.augment import augment as augment_batch  # noqa: F401
from fr_tpu_torch.data.augment import (  # noqa: F401
    augment_cfg_from_conf,
    normalize_only,
)
from fr_tpu_torch.data.device_corpus import DeviceCorpusLoader  # noqa: F401
from fr_tpu_torch.data.folder import (  # noqa: F401
    ArrayTrainLoader,
    ImageFolderIndex,
    TrainLoader,
)
from fr_tpu_torch.data.packed import (  # noqa: F401
    PackedTrainLoader,
    pack_image_folder,
)
from fr_tpu_torch.data.pairs import CrossDataset, PairDataset  # noqa: F401
from fr_tpu_torch.data.synthetic import (  # noqa: F401
    ArrayPairDataset,
    synthetic_corpus,
    synthetic_pairs,
    write_synthetic_folder,
)
