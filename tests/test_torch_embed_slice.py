"""The port's serving slice against fr_tpu: verification metrics, the resize
of the embedding step, weight transfer from an fr_tpu snapshot, the task and
trainer report, the CLI, and that the port never imports jax."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fr_tpu.ckpt.checkpoint import export_encoder
from fr_tpu.configs import load_config
from fr_tpu.configs.base import Config
from fr_tpu.eval import verification as jax_verification
from fr_tpu.models.resnet import ResNet as JaxResNet
from fr_tpu_torch.cli.main import main
from fr_tpu_torch.data.synthetic import (ArrayPairDataset, synthetic_corpus,
                                         synthetic_pairs)
from fr_tpu_torch.eval import verification
from fr_tpu_torch.models.resnet import ResNet
from fr_tpu_torch.train.step import make_embed_step, resize_bilinear
from fr_tpu_torch.train.task import FaceRecognitionTask
from fr_tpu_torch.train.trainer import Trainer
from fr_tpu_torch.utils.jax_import import load_encoder_npz

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("n,d,levels", [(400, 64, (3, 9)), (1000, 512, (1, 6))])
def test_pair_metrics_equal_fr_tpu(n, d, levels):
    """Scores, histograms, ROC text and accuracy are exactly fr_tpu's."""
    rng = np.random.default_rng(n)
    e1 = rng.standard_normal((n, d)).astype(np.float32)
    e2 = (e1 + 0.9 * rng.standard_normal((n, d))).astype(np.float32)
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 /= np.linalg.norm(e2, axis=1, keepdims=True)
    labels = rng.integers(0, 2, n).astype(bool)
    e2[~labels] = np.roll(e2, 1, axis=0)[~labels]

    ours = verification.pair_score(e1, e2, labels)
    ref = jax_verification.pair_score(e1, e2, labels)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    roc, th = verification.performance_roc(ours[0], ours[1], *levels)
    assert (roc, th) == jax_verification.performance_roc(ref[0], ref[1],
                                                         *levels)
    assert verification.performance_acc(ours[2], labels, th) == \
        jax_verification.performance_acc(ref[2], labels, th)


def test_synthetic_data_equals_fr_tpu():
    from fr_tpu.data import synthetic as jax_synthetic
    for a, b in zip(synthetic_pairs(6, 4, 8), jax_synthetic.synthetic_pairs(
            6, 4, 8)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(synthetic_corpus(3, 2, 8),
                    jax_synthetic.synthetic_corpus(3, 2, 8)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("src,dst", [(64, 96), (128, 96), (100, 96)])
def test_resize_matches_jax_image_resize(src, dst):
    """Half-pixel centres; antialias when downscaling. The weights are
    jax's bit for bit; 5e-5 covers the two contractions' f32 summation
    order at |x| ≤ 5."""
    x = np.random.default_rng(src).standard_normal(
        (2, src, src + 4, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst + 2, 3),
                                      "bilinear"))
    out = resize_bilinear(torch.from_numpy(x), dst, dst + 2).numpy()
    assert np.abs(out - ref).max() <= 5e-5


def test_npz_snapshot_loads_into_port(tmp_path):
    """fr_tpu's encoder snapshot (.npz) → load_encoder_npz → strict load;
    embeddings agree with fr_tpu's to 2e-4 (ResNet18, 32 px, emd 64)."""
    from fr_tpu.parallel import make_mesh
    from fr_tpu.train.step import make_embed_step as jax_make_embed_step

    x = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    enc = JaxResNet(layers=(2, 2, 2, 2), emd_size=64)
    variables = jax.jit(lambda k, v: enc.init(k, v, train=False))(
        jax.random.key(0), jnp.asarray(x))
    path = tmp_path / "1_epoch_encoder.npz"
    export_encoder(str(path), jax.tree.map(np.asarray, variables["params"]),
                   jax.tree.map(np.asarray, variables["batch_stats"]), 1,
                   "ResNet18")
    model = ResNet((2, 2, 2, 2), emd_size=64, img_size=32)
    model.load_state_dict(load_encoder_npz(str(path), "ResNet18"),
                          strict=True)
    conf = Config(img_size=32)
    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    ref = np.asarray(jax_make_embed_step(conf, mesh, enc)(
        variables["params"], variables["batch_stats"], jnp.asarray(x)))
    out = make_embed_step(conf, model, "cpu")(x).numpy()
    assert np.abs(out - ref).max() <= 2e-4


def test_task_and_trainer_print_the_roc_report(tmp_path, capsys):
    """Trainer.test through the port's task: 16 synthetic pairs, AlterNet50
    at 96 px in f32 on the CPU."""
    conf = load_config("ms1m_arcface_122", network="AlterNet50")
    conf.img_size = 96
    conf.mixed_precision = False
    conf.test_dataset = ["synthetic"]
    conf.test_b = 8
    task = FaceRecognitionTask(conf, stage="test", device="cpu")
    pairs, same = synthetic_pairs(16, 4, 96)
    msg = Trainer(conf, tmp_path, "test").test(
        task, {"synthetic": ArrayPairDataset(pairs, same)})
    out = capsys.readouterr().out
    assert '[Test with "synthetic"]' in out and "- EER" in out
    assert "- Total count = 16" in out
    e1, e2 = msg["synthetic"].embeddings
    assert e1.shape == e2.shape == (16, 512)
    np.testing.assert_allclose(np.linalg.norm(e1, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("argv,match", [
    (["--mode", "test", "--synthetic", "--mesh_data", "2"], "multi-GPU"),
])
def test_cli_unported_paths_raise(argv, match, tmp_path):
    """A two-device mesh outside torchrun raises (the mesh runs one process
    per device, tests/test_torch_multigpu_cli.py)."""
    with pytest.raises(ValueError, match=match):
        main(argv + ["--device", "cpu", "--save_root", str(tmp_path)])


_SMALL = ["--network", "ResNet18", "--img_size", "16", "--batch", "8",
          "--synthetic_classes", "8", "--test_b", "16", "--device", "cpu"]


@pytest.mark.parametrize("argv", [
    ["--mode", "train"],
    ["--mode", "test", "--test_type", "cross", "--synthetic"],
    ["--mode", "test"],
])
def test_cli_paths_do_what_fr_tpu_does(argv, tmp_path, monkeypatch, capsys):
    """The paths that raised before the loaders were ported, with the
    config's dataset roots at an empty directory: training raises
    FileNotFoundError for the missing train_dataset_dir (fr_tpu's
    ImageFolderIndex does), the test mode skips every missing test set with
    a message, and the synthetic cross test (8 classes × 4 images) prints
    its report."""
    from fr_tpu_torch.configs import lfw
    monkeypatch.setattr(lfw, "DATA_DIR", str(tmp_path / "FR"))
    run = argv + _SMALL + ["--save_root", str(tmp_path / "save")]
    if argv == ["--mode", "train"]:
        with pytest.raises(FileNotFoundError):
            main(run)
        return
    msg = main(run)
    out = capsys.readouterr().out
    if "--synthetic" in argv:
        assert list(msg) == ["synthetic"] and "- EER" in out
        assert "- Total count = 496" in out   # 32 · 31 / 2 pairs
        assert msg["synthetic"].embeddings.shape == (32, 512)
    else:
        assert msg == {}
        for name in ("lfw", "agedb_30", "cfp_fp", "cfp_ff", "calfw",
                     "cplfw"):
            assert f"skipping test dataset {name}: no pair data" in out


def test_cli_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--mode", "test", "--synthetic", "--save_root",
              str(tmp_path)])


_NO_JAX_SCRIPT = """
import sys
import fr_tpu_torch, fr_tpu_torch.ops._build, fr_tpu_torch.utils.golden
import fr_tpu_torch.utils.jax_import, fr_tpu_torch.models
from fr_tpu_torch.cli.main import main
msg = main(["--config", "ms1m_arcface_122", "--mode", "test",
            "--network", "ResNet18", "--img_size", "32", "--synthetic",
            "--test_b", "128", "--device", "cpu", "--save_root", sys.argv[1]])
assert "EER" in msg["synthetic"].roc
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax"))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_runs_the_cli_without_importing_jax(tmp_path):
    """A fresh interpreter imports the whole slice and runs the CLI's test
    mode end to end (ResNet18, 32 px, on the CPU); no jax module loads."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT,
                           str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert '[Test with "synthetic"]' in proc.stdout
