"""The card-resident corpus striped over the ranks of a mesh
(fr_tpu_torch/data/device_corpus.py) against fr_tpu's DeviceCorpusLoader on
a mesh of the conftest's virtual CPU devices: at meshes (1, 2), (1, 4) and
(2, 2), every rank r of ``Mesh.rank`` gets device r's rows of fr_tpu's
global batch, bit for bit, and fr_tpu's global labels, at epochs 0 and 3,
over 66 rows of 8×8×3 (so four ranks leave two rows out) and a global batch
of 8; the same steps per epoch and num_classes. Rank r uploads only its
block, and a step copies nothing from the host. Then the CLI trains from a
packed corpus with --device_corpus at two CPU ranks under torchrun over
gloo."""

import functools
import re

import jax
import numpy as np
import pytest
import torch

from fr_tpu.data.device_corpus import DeviceCorpusLoader as JaxDeviceCorpus
from fr_tpu.parallel import make_mesh as jax_make_mesh
from fr_tpu_torch.data import DeviceCorpusLoader
from fr_tpu_torch.data import device_corpus as device_corpus_module
from fr_tpu_torch.parallel.mesh import Mesh
from test_torch_cpu_threads import one_torch_thread  # noqa: F401
from test_torch_multigpu_cli import _torchrun

N, B, SEED = 66, 8, 7
MESHES = [(1, 2), (1, 4), (2, 2)]
RANKS = [Mesh(data, model, d, m) for data, model in MESHES
         for d in range(data) for m in range(model)]


def _ids(mesh):
    return f"{mesh.data}x{mesh.model}-rank{mesh.rank}"


def _corpus():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (N, 8, 8, 3)).astype(np.uint8)
    labels = rng.integers(0, 20, N).astype(np.int32)
    labels[-1] = 25  # the largest label only in a row four ranks leave out
    return imgs, labels


@functools.lru_cache(maxsize=None)
def _reference(data, model):
    """fr_tpu's loader on a (data, model) mesh of the virtual devices:
    (steps per epoch, num_classes, {epoch: [(global images, labels)]})."""
    imgs, labels = _corpus()
    mesh = jax_make_mesh(data, model, devices=jax.devices()[:data * model])
    ref = JaxDeviceCorpus(imgs, labels, batch_size=B, mesh=mesh, seed=SEED)
    epochs = {e: [(np.asarray(x), np.asarray(y)) for x, y in ref.epoch(e)]
              for e in (0, 3)}
    return ref.steps_per_epoch(), ref.num_classes, epochs


def _ours(mesh):
    imgs, labels = _corpus()
    return DeviceCorpusLoader(imgs, labels, B, seed=SEED, device="cpu",
                              process_index=mesh.rank,
                              process_count=mesh.size)


@pytest.mark.parametrize("mesh", RANKS, ids=_ids)
def test_stripe_equals_fr_tpu_device_rows(mesh):
    steps, num_classes, epochs = _reference(mesh.data, mesh.model)
    ours = _ours(mesh)
    b_loc = B // mesh.size
    assert (ours.steps_per_epoch(), ours.num_classes) == (steps, num_classes)
    for e, want in epochs.items():
        got = list(ours.epoch(e))
        assert len(got) == len(want) == steps
        for (x, y), (gx, gy) in zip(got, want):
            assert x.dtype == torch.uint8 and y.dtype == torch.int32
            assert x.shape == (b_loc, 8, 8, 3) and y.shape == (B,)
            np.testing.assert_array_equal(
                x.numpy(), gx[mesh.rank * b_loc:(mesh.rank + 1) * b_loc])
            np.testing.assert_array_equal(y.numpy(), gy)
    # the epochs draw different batches
    assert not np.array_equal(epochs[0][0][1], epochs[3][0][1])


@pytest.mark.parametrize("mesh", RANKS, ids=_ids)
def test_rank_uploads_only_its_block(mesh):
    imgs, _ = _corpus()
    ours = _ours(mesh)
    n_loc = N // mesh.size
    assert ours.images.shape == (n_loc, 8, 8, 3)
    np.testing.assert_array_equal(
        ours.images.numpy(), imgs[mesh.rank * n_loc:(mesh.rank + 1) * n_loc])
    # every rank takes the same number of steps (the collectives of the
    # last one need them all)
    assert ours.steps_per_epoch() == n_loc // (B // mesh.size)


def test_a_step_copies_nothing_from_the_host(monkeypatch):
    """An epoch turns two host arrays into tensors (the rank's permutation
    and the epoch's labels) before its first step, and none after."""
    ours = _ours(Mesh(2, 2, 1, 0))
    made = []
    from_numpy = torch.from_numpy
    monkeypatch.setattr(device_corpus_module.torch, "from_numpy",
                        lambda a: made.append(a.nbytes) or from_numpy(a))
    batches = ours.epoch(1)
    next(batches)
    assert len(made) == 2
    assert sum(1 for _ in batches) == ours.steps_per_epoch() - 1
    assert len(made) == 2 and sum(made) < ours.images.numel()


def test_torchrun_trains_from_striped_corpus(tmp_path):
    """--distributed --mesh_model 2 --device_corpus over gloo: both ranks
    finish with finite losses; rank 0 alone writes the log and the epoch-5
    snapshot; the saved state's step count is 5 epochs of
    n_loc // b_loc steps."""
    pytest.importorskip("cv2")
    from fr_tpu_torch.data import pack_image_folder, write_synthetic_folder
    write_synthetic_folder(str(tmp_path / "folder"), 7, 5, 32)
    pack_image_folder(str(tmp_path / "folder"), str(tmp_path / "packed"),
                      32, log_every=0)
    out = _torchrun(["--config", "ms1m_arcface_122", "--mode", "train",
                     "--network", "ResNet18", "--img_size", "32", "--batch",
                     str(B), "--sample_rate", "1.0", "--device", "cpu",
                     "--num_epoch", "6", "--packed_dir",
                     str(tmp_path / "packed"), "--device_corpus",
                     "--save_root", str(tmp_path / "train")], tmp_path)
    (run,) = (tmp_path / "train").iterdir()
    log = (run / "log.txt").read_text()
    losses = [float(x) for x in re.findall(r"- Train Loss: (\S+)", log)]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert log.count("of a 1 x 2 mesh") == 1 and "rank 0 of" in log
    assert "rank 1 of a 1 x 2 mesh" in out
    assert sorted(p.name for p in run.glob("*.npz")) == [
        "5_epoch_encoder.npz"]
    assert sorted(p.name for p in (run / "state").iterdir()) == ["5.pt"]
    n_loc, b_loc = 35 // 2, B // 2
    state = torch.load(run / "state" / "5.pt", weights_only=False)
    assert state["step"] == 5 * (n_loc // b_loc) == 20
