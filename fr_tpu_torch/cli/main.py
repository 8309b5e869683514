"""CLI entry point (counterpart of fr_tpu/cli/main.py, same flag surface).

    python -m fr_tpu_torch.cli.main --config ms1m_arcface_122 --mode train \
        --network AlterNet50 --data_dir <root with imgs/<class>/*> --device cuda
    python -m fr_tpu_torch.cli.main --config ms1m_arcface_122 --mode train \
        --network AlterNet50 --packed_dir <packed corpus> [--device_corpus]
    python -m fr_tpu_torch.cli.main --config ms1m_arcface_122 --mode test \
        --network AlterNet50 --ckpt_path <.npz or .pth> --test_b 64 \
        [--test_type cross]
    python -m fr_tpu_torch.cli.main --config webface42m --mode train \
        --network ResNet100 --sample_rate 0.1 --sample_block 64 --synthetic \
        --device cuda        # and again with --resume to go on from a save

On one device, every input path of fr_tpu's CLI: training from an image
folder (``--data_dir``, else ``conf.train_dataset_dir``), from a packed
corpus (``--packed_dir``) or from a packed corpus uploaded to the card
(``--device_corpus``), validating on the config's pair sets where they
exist; testing pairs (bcolz roots or ``.npy``/``.npz``) or cross sets (a
csv of images) under ``conf.test_dataset_dir``, skipping sets that are
absent; ``--synthetic`` for either mode and test type. Encoder snapshots are
written in fr_tpu's ``.npz`` layout beside full-state checkpoints;
``--ckpt_path`` takes an ``.npz`` snapshot or a reference ``.pth``;
``--sample_block N`` samples the head in aligned groups; ``--resume``
continues the newest matching run. ``--device {cuda,cpu}`` takes the place
of JAX_PLATFORMS; it raises when CUDA is asked for and absent and never
switches device on its own. ``--profile N`` records a torch.profiler trace
of N training steps into <run dir>/profile/trace.json, and training writes
TensorBoard scalars into <run dir>/TBLog. The multi-GPU flags raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

_MULTI_GPU = "multi-GPU runs are not ported yet: ROADMAP §1, multi-GPU"


def parse_args(argv=None):
    p = argparse.ArgumentParser("fr_tpu_torch")
    p.add_argument("--config", type=str, default="lfw")
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "test"])
    p.add_argument("--network", type=str, default=None)
    p.add_argument("--loss", type=str, default=None)
    p.add_argument("--optimizer", type=str, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--sample_rate", type=float, default=None)
    p.add_argument("--sample_block", type=int, default=1)
    p.add_argument("--ckpt_path", type=str, default=None,
                   help="fr_tpu .npz or reference .pth encoder snapshot "
                        "to evaluate")
    p.add_argument("--test_type", type=str, default="pair",
                   choices=["pair", "cross"])
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--packed_dir", type=str, default=None)
    p.add_argument("--device_corpus", action="store_true")
    p.add_argument("--num_epoch", type=int, default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--test_b", type=int, default=None,
                   help="test-mode batch (pairs); default 1")
    p.add_argument("--img_size", type=int, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="train/evaluate on synthetic identity data")
    p.add_argument("--synthetic_classes", type=int, default=128)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile", type=int, default=0,
                   help="record a torch.profiler trace of N steps")
    p.add_argument("--save_root", type=str, default="save")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--mesh_data", type=int, default=None)
    p.add_argument("--mesh_model", type=int, default=None)
    p.add_argument("--spmd_mode", choices=["auto", "shard_map", "gspmd"],
                   default="auto")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the encoder runs; cuda raises when absent")
    return p.parse_args(argv)


def build_conf(args):
    from fr_tpu_torch.configs import default_img_size, load_config

    conf = load_config(
        args.config, network=args.network, loss=args.loss,
        optimizer=args.optimizer, lr=args.lr, sample_rate=args.sample_rate,
        ckpt_path=args.ckpt_path)
    conf.test_type = args.test_type
    conf.sample_block = args.sample_block
    if args.test_b is not None:
        conf.test_b = args.test_b
    conf.img_size = (args.img_size if args.img_size
                     else default_img_size(conf.network))
    conf.min_lr = conf.lr / 1000
    if args.num_epoch is not None:
        conf.num_epoch = args.num_epoch
    if args.batch is not None:
        conf.b = args.batch
    if args.data_dir is not None:
        conf.train_dataset_dir = args.data_dir
    return conf


def make_save_dir(args, conf) -> Path:
    """Timestamped run dir with the resolved config dump and log.txt.
    ``--resume`` reuses the newest run dir of the same network and loss
    under save_root, where the saved state lives; a fresh dir would start
    again from epoch 0."""
    from fr_tpu_torch.utils.logger import print_log

    prefix = f"{conf.network}_{conf.loss}_"
    if getattr(args, "resume", False):
        prior = sorted(Path(args.save_root).glob(f"{prefix}*"))
        if prior:
            print(f"--resume: reusing run dir {prior[-1]}")
            return prior[-1]
    stamp = time.strftime("%Y%m%d_%H%M%S")
    save = Path(args.save_root) / f"{prefix}{stamp}"
    save.mkdir(parents=True, exist_ok=True)
    with open(save / f"{args.config}_config.txt", "w") as f:
        f.write(conf.pretty())
    print_log(str(save / "log.txt"), conf.pretty())
    return save


def _single_device(args):
    if args.distributed or (args.mesh_data or 1) * (args.mesh_model or 1) > 1:
        raise NotImplementedError(_MULTI_GPU)


def _loaders(args, conf, device):
    """(training loader, {name: validation pair set}) as fr_tpu's CLI makes
    them; sets conf.n_classes from the corpus."""
    from fr_tpu_torch.data import (ArrayPairDataset, ArrayTrainLoader,
                                   ImageFolderIndex, PairDataset,
                                   TrainLoader, synthetic_corpus,
                                   synthetic_pairs)
    if args.synthetic:
        imgs, labels = synthetic_corpus(args.synthetic_classes, 8,
                                        conf.img_size)
        conf.n_classes = args.synthetic_classes
        conf.val_dataset = ["synthetic"]
        train = ArrayTrainLoader(imgs, labels, conf.b)
        pairs, same = synthetic_pairs(256, args.synthetic_classes,
                                      conf.img_size)
        return train, {"synthetic": ArrayPairDataset(pairs, same)}
    if args.packed_dir:
        from fr_tpu_torch.data import PackedTrainLoader
        train = PackedTrainLoader(args.packed_dir, conf.b)
        packed_size = train.images.shape[1]
        if packed_size != conf.img_size:
            raise ValueError(
                f"packed corpus is {packed_size}px but conf.img_size is "
                f"{conf.img_size}; repack with --img_size {conf.img_size} "
                f"or pass --img_size {packed_size}")
        conf.n_classes = train.num_classes
        if args.device_corpus:
            from fr_tpu_torch.data import DeviceCorpusLoader
            train = DeviceCorpusLoader(train.images, train.labels, conf.b,
                                       device=device)
    else:
        index = ImageFolderIndex(conf.train_dataset_dir)
        conf.n_classes = index.num_classes
        train = TrainLoader(index, conf.b, conf.img_size,
                            prefetch=conf.get("num_workers", 4))
    vals = {}
    for name, d in zip(conf.val_dataset, conf.val_dataset_dir):
        try:
            vals[name] = PairDataset(d, conf.img_size)
        except FileNotFoundError as e:
            print(f"skipping val dataset {name}: {e}")
    # the task names a set by its index among those present (see
    # _test_sets)
    conf.val_dataset = list(vals)
    return train, vals


def _test_sets(args, conf):
    """{name: pair or cross set} for conf.test_type, as fr_tpu's CLI makes
    them; absent sets are skipped with a message. conf.test_dataset becomes
    the names present: the task names a set by its index among them (fr_tpu
    keeps the configured list, so a skipped set shifts the names of the
    sets after it)."""
    from fr_tpu_torch.data import (ArrayPairDataset, CrossDataset,
                                   PairDataset, synthetic_corpus,
                                   synthetic_pairs)
    tests = {}
    if args.synthetic:
        conf.n_classes = args.synthetic_classes
        conf.test_dataset = ["synthetic"]
        if conf.test_type == "pair":
            pairs, same = synthetic_pairs(256, args.synthetic_classes,
                                          conf.img_size)
            tests["synthetic"] = ArrayPairDataset(pairs, same)
        else:  # cross: a flat image list + identity labels
            imgs, labels = synthetic_corpus(args.synthetic_classes, 4,
                                            conf.img_size)
            imgs_f = (imgs.astype("float32") / 255.0 - 0.5) / 0.5
            tests["synthetic"] = ArrayPairDataset(imgs_f, labels)
        return tests
    for name, d in zip(conf.test_dataset, conf.test_dataset_dir):
        try:
            if conf.test_type == "pair":
                tests[name] = PairDataset(d, conf.img_size)
            else:
                tests[name] = CrossDataset(d, conf.img_size)
        except FileNotFoundError as e:
            print(f"skipping test dataset {name}: {e}")
    conf.test_dataset = list(tests)
    return tests


def train(args):
    """Training on one device; returns the task (its ``history`` holds each
    epoch's results)."""
    from fr_tpu_torch.train.task import FaceRecognitionTask, resolve_device
    from fr_tpu_torch.train.trainer import Trainer

    _single_device(args)
    device = resolve_device(args.device)
    conf = build_conf(args)
    save = make_save_dir(args, conf)
    logger = str(save / "log.txt")

    loader, vals = _loaders(args, conf, device)
    task = FaceRecognitionTask(conf, logger=logger, stage="train",
                               device=device)
    return Trainer(conf, save, "train", logger).train(
        task, loader, vals, resume=args.resume, profile_steps=args.profile)


def test(args):
    """Pair or cross test; returns {dataset name: Config(acc, infer_time,
    roc, embeddings)}."""
    from fr_tpu_torch.train.task import FaceRecognitionTask, resolve_device
    from fr_tpu_torch.train.trainer import Trainer

    _single_device(args)
    device = resolve_device(args.device)
    conf = build_conf(args)
    save = make_save_dir(args, conf)
    logger = str(save / "log.txt")

    tests = _test_sets(args, conf)
    task = FaceRecognitionTask(conf, logger=logger, stage="test",
                               device=device)
    return Trainer(conf, save, "test", logger).test(task, tests)


def main(argv=None):
    """Runs the mode; returns the trained task (train) or the test report
    (test)."""
    args = parse_args(argv)
    if args.mode == "train":
        return train(args)
    return test(args)


if __name__ == "__main__":
    main()
