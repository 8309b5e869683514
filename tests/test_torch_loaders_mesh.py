"""The loaders split over processes (fr_tpu_torch/data/folder.py,
packed.py): ArrayTrainLoader, TrainLoader and PackedTrainLoader at
process_count 2 and 4, every process_index, give fr_tpu's loaders' (local
images, global labels) for the same seed, epoch after epoch; a global
batch that does not split raises; --device_corpus under two ranks gives
each rank its stripe of the corpus."""

import numpy as np
import pytest

from fr_tpu.data.folder import ArrayTrainLoader as JaxArrayTrainLoader
from fr_tpu.data.folder import ImageFolderIndex as JaxImageFolderIndex
from fr_tpu.data.folder import TrainLoader as JaxTrainLoader
from fr_tpu.data.packed import PackedTrainLoader as JaxPackedTrainLoader
from fr_tpu_torch.cli.main import _loaders, build_conf, parse_args
from fr_tpu_torch.data import (ArrayTrainLoader, DeviceCorpusLoader,
                               ImageFolderIndex, PackedTrainLoader,
                               TrainLoader, pack_image_folder,
                               synthetic_corpus, write_synthetic_folder)
from fr_tpu_torch.parallel.mesh import Mesh
from test_torch_loaders import _same_batches

cv2 = pytest.importorskip("cv2")
SPLITS = [(i, n) for n in (2, 4) for i in range(n)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """6 classes × 4 JPEGs of 16 px as a folder and as a packed corpus."""
    root = tmp_path_factory.mktemp("corpus")
    write_synthetic_folder(str(root / "folder"), 6, 4, 16)
    pack_image_folder(str(root / "folder"), str(root / "packed"), 16,
                      log_every=0)
    return root


def _epochs(ours, ref, local):
    for e in (0, 1):
        got = _same_batches(ours.epoch(e), ref.epoch(e))
        for images, labels in got:
            assert images.shape[0] == local and labels.shape[0] == 8


@pytest.mark.parametrize("index,count", SPLITS)
def test_array_loader_split_equals_fr_tpu(index, count):
    imgs, labels = synthetic_corpus(6, 4, 16)
    split = dict(process_index=index, process_count=count)
    _epochs(ArrayTrainLoader(imgs, labels, 8, seed=3, **split),
            JaxArrayTrainLoader(imgs, labels, 8, seed=3, **split), 8 // count)


@pytest.mark.parametrize("index,count", SPLITS)
def test_folder_loader_split_equals_fr_tpu(corpus, index, count):
    split = dict(process_index=index, process_count=count)
    _epochs(TrainLoader(ImageFolderIndex(str(corpus / "folder")), 8, 16,
                        seed=3, **split),
            JaxTrainLoader(JaxImageFolderIndex(str(corpus / "folder")), 8,
                           16, seed=3, **split), 8 // count)


@pytest.mark.parametrize("index,count", SPLITS)
def test_packed_loader_split_equals_fr_tpu(corpus, index, count):
    split = dict(process_index=index, process_count=count)
    _epochs(PackedTrainLoader(str(corpus / "packed"), 8, seed=2, **split),
            JaxPackedTrainLoader(str(corpus / "packed"), 8, seed=2, **split),
            8 // count)


def test_a_batch_that_does_not_split_raises(corpus):
    imgs, labels = synthetic_corpus(6, 4, 16)
    with pytest.raises(ValueError, match="does not split"):
        ArrayTrainLoader(imgs, labels, 8, process_count=3)
    with pytest.raises(ValueError, match="does not split"):
        PackedTrainLoader(str(corpus / "packed"), 8, process_count=3)
    with pytest.raises(ValueError, match="does not split"):
        DeviceCorpusLoader(imgs, labels, 8, device="cpu", process_count=3)


@pytest.mark.parametrize("rank", [0, 1])
def test_device_corpus_under_two_ranks_stripes(corpus, rank):
    args = parse_args(["--config", "ms1m_arcface_122", "--network",
                       "ResNet18", "--img_size", "16", "--batch", "8",
                       "--packed_dir", str(corpus / "packed"),
                       "--device_corpus", "--device", "cpu"])
    conf = build_conf(args)
    train, _ = _loaders(args, conf, "cpu", Mesh(1, 2, 0, rank))
    assert isinstance(train, DeviceCorpusLoader)
    assert (train.process_index, train.process_count) == (rank, 2)
    images, labels = next(iter(train.epoch(0)))
    assert images.shape[0] == 4 and labels.shape[0] == 8
    assert train.images.shape[0] == 12
    # the same corpus splits over the two ranks without --device_corpus
    args.device_corpus = False
    train, _ = _loaders(args, conf, "cpu", Mesh(1, 2, 0, 1))
    assert (train.process_index, train.process_count) == (1, 2)
    images, labels = next(iter(train.epoch(0)))
    assert images.shape[0] == 4 and labels.shape[0] == 8
    assert np.isin(labels, np.arange(6)).all()
