"""MS1M-ArcFace training config (reference configs/ms1m_arcface_122.py semantics)."""

from pathlib import Path

from fr_tpu_torch.configs.base import Config, N_CLASSES, generate_config

DATA_DIR = "/workspace/dataset/FR"


def make_config() -> Config:
    conf = Config()
    conf.network = "AlterNet50"
    conf.security_level = 3
    conf.max_level = 6
    conf.min_level = 1

    conf.loss = "PartialFC"
    conf.metric = "ArcFace"
    conf.optimizer = "SGD"

    conf.train_dataset = "ms1m_arcface_122"
    conf.n_classes = N_CLASSES[conf.train_dataset]
    conf.val_dataset = ["lfw"]
    conf.test_dataset = ["lfw", "agedb_30", "cfp_fp", "cfp_ff", "calfw", "cplfw"]
    conf.val_byte = True

    conf.train_dataset_dir = str(Path(DATA_DIR) / "train" / conf.train_dataset)
    conf.val_dataset_dir = [str(Path(DATA_DIR) / "validation" / n) for n in conf.val_dataset]
    conf.test_dataset_dir = [str(Path(DATA_DIR) / "validation" / n) for n in conf.test_dataset]
    conf.model_dir = "./models"

    # Hyperparameters (reference configs/ms1m_arcface_122.py:87-107).
    conf.b = 128
    conf.lr = 0.05
    conf.k = 1
    conf.sample_rate = 0.3
    conf.num_workers = 10
    conf.num_epoch = 15
    conf.valid_freq = 5
    conf.save_epoch = 5
    conf.matching_type = "euclidean"
    conf.data_augmentation = [
        "RandomHorizontalFlip", "RandomGammaContrast", "RandomMotionBlur",
        "ISONoise", "RandomErasing",
    ]
    conf.label_smooth = False
    conf.mixed_precision = True
    conf.lr_scheduler = "CosineAnnealingWarmupRestarts"

    conf.img_augmentation = Config(
        gamma_s=(80, 120), gamma_p=0.5,
        blur_p=0.5,
        c_shift=(0.0, 0.05), intensity=(0.0, 0.3), iso_p=0.5,
        erase_p=0.5, erase_min_holes=1, erase_max_holes=1,
        erase_max_h=20, erase_max_w=20,
    )

    generate_config(conf, conf.network, conf.loss, conf.optimizer, conf.lr_scheduler)
    conf.sample_rate = 0.3
    return conf
