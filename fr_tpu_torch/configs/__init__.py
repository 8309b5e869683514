from fr_tpu_torch.configs.base import (  # noqa: F401
    Config,
    N_CLASSES,
    NETWORKS,
    LOSSES,
    OPTIMIZERS,
    default_img_size,
    generate_config,
    load_config,
    validate,
)
