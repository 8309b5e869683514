"""The port's training loaders and its data-driven CLI paths against
fr_tpu on the same files: the image-folder index and loader (with the
native JPEG decode and with cv2), the packed corpus, the device-resident
corpus (on the CPU here), the prefetch to the device, and CLI runs from an
image folder, a packed corpus, a device corpus, a bcolz pair root and a csv
cross set. Every file is written by the test; small encoders on the CPU."""

import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import fr_tpu.data as jax_data
from fr_tpu import native as jax_native
from fr_tpu.data.device_corpus import DeviceCorpusLoader as JaxDeviceCorpus
from fr_tpu.data.folder import ImageFolderIndex as JaxImageFolderIndex
from fr_tpu.data.folder import TrainLoader as JaxTrainLoader
from fr_tpu.data.packed import PackedTrainLoader as JaxPackedTrainLoader
from fr_tpu.data.packed import pack_image_folder as jax_pack_image_folder
from fr_tpu.eval import verification as jax_verification
from fr_tpu.parallel import make_mesh
import fr_tpu_torch.data as data
from fr_tpu_torch import native
from fr_tpu_torch.cli.main import main
from fr_tpu_torch.configs import load_config
from fr_tpu_torch.configs import ms1m_arcface_122
from fr_tpu_torch.data import (DeviceCorpusLoader, ImageFolderIndex,
                               PackedTrainLoader, TrainLoader,
                               pack_image_folder, synthetic_corpus,
                               synthetic_pairs, write_synthetic_folder)
from fr_tpu_torch.train.step import prefetch_to_device
from fr_tpu_torch.train.task import FaceRecognitionTask
from test_torch_cpu_threads import one_torch_thread  # noqa: F401
from test_torch_eval_data import _write_rootdir_genuine, write_cross_set

cv2 = pytest.importorskip("cv2")

SMALL = ["--config", "ms1m_arcface_122", "--network", "ResNet18",
         "--img_size", "16", "--batch", "8", "--sample_rate", "1.0",
         "--device", "cpu"]
TRAIN = SMALL + ["--mode", "train", "--num_epoch", "6"]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """6 classes × 4 JPEGs of 16 px, and the same 6 × 4 at 24 px (the
    loaders resize those)."""
    root = tmp_path_factory.mktemp("folders")
    write_synthetic_folder(str(root / "f16"), 6, 4, 16)
    write_synthetic_folder(str(root / "f24"), 6, 4, 24, seed=1)
    return root


def test_image_folder_index_equals_fr_tpu(folder):
    ours = ImageFolderIndex(str(folder / "f16"))
    ref = JaxImageFolderIndex(str(folder / "f16"))
    assert ours.classes == ref.classes == sorted(ref.classes)
    assert ours.class_to_idx == ref.class_to_idx
    assert ours.samples == ref.samples and len(ours) == 24
    assert ours.num_classes == ref.num_classes == 6
    with pytest.raises(FileNotFoundError):
        ImageFolderIndex(str(folder / "absent"))


def _reset_native(monkeypatch, off: bool):
    """Both packages' native loaders decide again at their next call, with
    FR_TPU_NO_NATIVE set or unset."""
    if off:
        monkeypatch.setenv("FR_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("FR_TPU_NO_NATIVE", raising=False)
    for mod in (native, jax_native):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_TRIED", False)


def _same_batches(ours, ref):
    got, want = list(ours), list(ref)
    assert len(got) == len(want) > 0
    for (xa, la), (xb, lb) in zip(got, want):
        xa, la = np.asarray(xa), np.asarray(la)
        assert xa.dtype == np.asarray(xb).dtype == np.uint8
        assert la.dtype == np.asarray(lb).dtype == np.int32
        np.testing.assert_array_equal(xa, np.asarray(xb))
        np.testing.assert_array_equal(la, np.asarray(lb))
    return got


@pytest.mark.parametrize("native_decode", [True, False])
@pytest.mark.parametrize("src", ["f16", "f24"])
def test_train_loader_batches_equal_fr_tpu(folder, monkeypatch,
                                           native_decode, src):
    """Two epochs, batch 8 of 24 images (drop_last), 16 px out."""
    _reset_native(monkeypatch, off=not native_decode)
    if native_decode and not native.jpeg_available():
        pytest.skip("the native library built without libjpeg")
    assert native.jpeg_available() == native_decode
    ours = TrainLoader(ImageFolderIndex(str(folder / src)), 8, 16, seed=3)
    ref = JaxTrainLoader(JaxImageFolderIndex(str(folder / src)), 8, 16,
                         seed=3)
    assert ours.steps_per_epoch() == ref.steps_per_epoch() == 3
    epochs = [_same_batches(ours.epoch(e), ref.epoch(e)) for e in (0, 1)]
    assert not np.array_equal(epochs[0][0][1], epochs[1][0][1])


def test_train_loader_raises_a_decode_error(tmp_path):
    write_synthetic_folder(str(tmp_path), 2, 4, 8)
    bad = sorted((tmp_path / "imgs" / "id_00000").iterdir())[0]
    bad.write_bytes(b"not an image")
    loader = TrainLoader(ImageFolderIndex(str(tmp_path)), 8, 8)
    with pytest.raises(IOError, match="failed to decode"):
        list(loader.epoch(0))


@pytest.mark.parametrize("native_gather", [True, False])
def test_packed_corpus_equals_fr_tpu(folder, tmp_path, monkeypatch,
                                     native_gather):
    """pack_image_folder writes fr_tpu's files byte for byte (cv2 decode,
    resized 24 → 16 px), and PackedTrainLoader gives fr_tpu's batches."""
    _reset_native(monkeypatch, off=not native_gather)
    n = pack_image_folder(str(folder / "f24"), str(tmp_path / "ours"), 16,
                          log_every=0)
    assert n == jax_pack_image_folder(str(folder / "f24"),
                                      str(tmp_path / "ref"), 16,
                                      log_every=0) == 24
    for name in ("images.npy", "labels.npy", "classes.json"):
        assert (tmp_path / "ours" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name
    ours = PackedTrainLoader(str(tmp_path / "ours"), 8, seed=2)
    ref = JaxPackedTrainLoader(str(tmp_path / "ref"), 8, seed=2)
    assert ours.num_classes == ref.num_classes == 6
    for e in (0, 1):
        _same_batches(ours.epoch(e), ref.epoch(e))
    assert native.available() == native_gather


def test_device_corpus_equals_fr_tpu():
    """DeviceCorpusLoader on the CPU against fr_tpu's single-device loader:
    the same (seed, epoch, 0) permutation, the same rows and labels."""
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (64, 8, 8, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, 64).astype(np.int32)
    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    ref = JaxDeviceCorpus(imgs, labels, batch_size=16, mesh=mesh, seed=5)
    ours = DeviceCorpusLoader(imgs, labels, batch_size=16, seed=5,
                              device="cpu")
    assert ours.device_resident and ours.steps_per_epoch() == 4
    assert ours.num_classes == ref.num_classes
    for e in (0, 3):
        got = _same_batches(ours.epoch(e), ref.epoch(e))
        assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
                   for batch in got for x in batch)


def _prefetch_threads():
    return {t for t in threading.enumerate()
            if t.name == "prefetch_to_device"}


def test_prefetch_keeps_order_and_converts():
    batches = [(np.full((2, 4, 4, 3), i, np.uint8), np.array([i, i + 1]))
               for i in range(7)]
    out = list(prefetch_to_device(iter(batches), "cpu", depth=2))
    assert len(out) == 7
    for i, (x, y) in enumerate(out):
        assert x.dtype == torch.uint8 and y.dtype == torch.int32
        assert int(x[0, 0, 0, 0]) == i and y.tolist() == [i, i + 1]


def test_prefetch_raises_the_worker_error_again():
    def host():
        yield np.zeros((1, 2, 2, 3), np.uint8), np.zeros(1)
        raise ValueError("decode failed at batch 2")

    gen = prefetch_to_device(host(), "cpu")
    assert next(gen)[0].shape == (1, 2, 2, 3)
    with pytest.raises(ValueError, match="batch 2"):
        next(gen)


def test_prefetch_close_stops_the_worker():
    """close() after one batch: within 5 s the worker has left and has
    closed its host iterator, though the iterator had batches to give."""
    closed = threading.Event()

    def host():
        try:
            for i in range(1000):
                yield np.zeros((1, 2, 2, 3), np.uint8), np.array([i])
        finally:
            closed.set()

    before = _prefetch_threads()
    gen = prefetch_to_device(host(), "cpu", depth=2)
    next(gen)
    (worker,) = _prefetch_threads() - before
    gen.close()
    worker.join(timeout=5.0)
    assert not worker.is_alive() and closed.is_set()


def test_prefetched_steps_equal_host_steps():
    """Two training steps fed through the prefetch give the losses of the
    same steps fed host arrays, bit for bit (ResNet18, 16 px, f32)."""
    conf = load_config("ms1m_arcface_122", network="ResNet18")
    conf.update(img_size=16, b=8, n_classes=16, mixed_precision=False,
                sample_rate=1.0)
    imgs, labels = synthetic_corpus(16, 1, 16)
    host = [(imgs[:8], labels[:8]), (imgs[8:], labels[8:])]
    losses = []
    for feed in (iter(host), prefetch_to_device(iter(host), "cpu")):
        task = FaceRecognitionTask(conf, device="cpu")
        losses.append([task.training_step(b)["loss"] for b in feed])
    for a, b in zip(*losses):
        assert torch.equal(a, b)


def _finite_history(task):
    losses = [h["train_loss"] for h in task.history]
    assert len(losses) == 6 and np.isfinite(losses).all()
    return losses


def test_cli_trains_from_an_image_folder(folder, tmp_path, capsys):
    task = main(TRAIN + ["--data_dir", str(folder / "f16"),
                         "--save_root", str(tmp_path)])
    _finite_history(task)
    assert task.conf.n_classes == 6
    out = capsys.readouterr().out
    assert "- Epoch 6/6" in out and "skipping val dataset lfw" in out


@pytest.mark.parametrize("device_corpus", [False, True])
def test_cli_trains_from_a_packed_corpus(folder, tmp_path, monkeypatch,
                                         device_corpus):
    """--packed_dir, and with --device_corpus: the Trainer then takes the
    loader's batches as they come, without its prefetch."""
    pack_image_folder(str(folder / "f16"), str(tmp_path / "packed"), 16,
                      log_every=0)
    prefetches = []
    real = FaceRecognitionTask.prefetch_device_batches

    def counted(self, host_iter, depth=2):
        prefetches.append(1)
        return real(self, host_iter, depth)

    monkeypatch.setattr(FaceRecognitionTask, "prefetch_device_batches",
                        counted)
    task = main(TRAIN + ["--packed_dir", str(tmp_path / "packed"),
                         "--save_root", str(tmp_path / "save")]
                + (["--device_corpus"] if device_corpus else []))
    _finite_history(task)
    assert len(prefetches) == (0 if device_corpus else 6)


def test_cli_refuses_a_packed_corpus_of_another_size(folder, tmp_path):
    pack_image_folder(str(folder / "f16"), str(tmp_path / "packed"), 16,
                      log_every=0)
    with pytest.raises(ValueError, match="packed corpus is 16px"):
        main(TRAIN[:-2] + ["--num_epoch", "6", "--img_size", "32",
                           "--packed_dir", str(tmp_path / "packed"),
                           "--save_root", str(tmp_path / "save")])


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    """The config's dataset roots under tmp_path/FR (its DATA_DIR)."""
    root = tmp_path / "FR"
    monkeypatch.setattr(ms1m_arcface_122, "DATA_DIR", str(root))
    return root / "validation"


def test_cli_test_mode_over_a_bcolz_pair_root(data_dir, tmp_path, capsys):
    """lfw as a bcolz root of 12 pairs at 24 px (resized to 16 on the
    device); the five other test sets are absent and skipped."""
    pytest.importorskip("fr_tpu_torch.data.bcolz_reader")
    from fr_tpu_torch.data.bcolz_reader import blosc_available
    if not blosc_available():
        pytest.skip("libblosc not present")
    pairs, same = synthetic_pairs(12, 4, 24)
    arr = np.ascontiguousarray(np.transpose(pairs, (0, 1, 4, 2, 3)).reshape(
        24, 3, 24, 24))
    data_dir.mkdir(parents=True)
    _write_rootdir_genuine(data_dir / "lfw", arr, chunklen=5)
    np.save(data_dir / "lfw_list.npy", same)
    msg = main(SMALL + ["--mode", "test", "--test_b", "5",
                        "--save_root", str(tmp_path / "save")])
    out = capsys.readouterr().out
    assert list(msg) == ["lfw"]
    assert '[Test with "lfw"]' in out and "- Total count = 12" in out
    assert "skipping test dataset cplfw" in out
    e1, e2 = msg["lfw"].embeddings
    assert e1.shape == e2.shape == (12, 512)


def test_cli_cross_test_over_a_csv_set(data_dir, tmp_path, capsys):
    """agedb_30 as a csv cross set of 5 classes × 3 JPEGs; the report
    equals the text fr_tpu's cross_score, performance_roc and
    performance_acc give for the same embeddings."""
    pytest.importorskip("pandas")
    write_cross_set(data_dir / "agedb_30", 5, 3, 20)
    msg = main(SMALL + ["--mode", "test", "--test_type", "cross",
                        "--test_b", "4", "--save_root",
                        str(tmp_path / "save")])
    out = capsys.readouterr().out
    assert list(msg) == ["agedb_30"]
    assert '[Test with "agedb_30"]' in out and "- Total count = 105" in out
    emb = msg["agedb_30"].embeddings
    assert emb.shape == (15, 512) and emb.dtype == np.float32
    labels = np.repeat(np.arange(5), 3)
    conf = load_config("ms1m_arcface_122")
    hg, hi, scores, pair_labels = jax_verification.cross_score(emb, labels)
    roc, th = jax_verification.performance_roc(
        hg, hi, min_level=conf.min_level, max_level=conf.max_level)
    assert msg["agedb_30"].roc == roc and roc in out
    assert msg["agedb_30"].acc == jax_verification.performance_acc(
        scores, pair_labels, th)


def test_trainloader_thread_stops_when_the_epoch_is_left(folder):
    loader = TrainLoader(ImageFolderIndex(str(folder / "f16")), 4, 16,
                         prefetch=1)
    before = {t for t in threading.enumerate()
              if t.name == "TrainLoader.epoch"}
    gen = loader.epoch(0)
    next(gen)
    (worker,) = {t for t in threading.enumerate()
                 if t.name == "TrainLoader.epoch"} - before
    gen.close()
    deadline = time.monotonic() + 5.0
    while worker.is_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not worker.is_alive()
    assert Path(loader.index.root).name == "imgs"


def test_data_package_exports_fr_tpus_names():
    names = {n for n in dir(jax_data) if not n.startswith("_")}
    missing = {n for n in names if not hasattr(data, n)} - {
        "augment", "bcolz_reader", "device_corpus", "folder", "packed",
        "pairs", "synthetic"}
    assert not missing, missing
    imgs, _ = synthetic_corpus(2, 2, 8)
    np.testing.assert_array_equal(
        data.normalize_only(imgs).numpy(),
        np.asarray(jax_data.normalize_only(imgs)))
