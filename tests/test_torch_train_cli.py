"""The port's training entry points: the CLI's --mode train on synthetic
data (a small network on the CPU: the plumbing is under test here, AlterNet
is covered by test_torch_train_step.py), the library path through the
task, the encoder snapshot in fr_tpu's layout, block-aligned sampling
(--sample_block), --resume into the previous run's directory, the paths that
still raise, a missing training directory, and that the package never
imports jax."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fr_tpu.ckpt import load_encoder
from fr_tpu.configs import load_config
from fr_tpu_torch.cli.main import main
from fr_tpu_torch.data.synthetic import synthetic_corpus
from fr_tpu_torch.models.resnet import ResNet
from fr_tpu_torch.train.task import FaceRecognitionTask
from fr_tpu_torch.utils.jax_import import load_encoder_npz
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
CLI = ["--config", "ms1m_arcface_122", "--mode", "train", "--network",
       "ResNet18", "--img_size", "32", "--batch", "8", "--synthetic",
       "--synthetic_classes", "16", "--sample_rate", "1.0", "--device", "cpu"]


def test_cli_trains_six_epochs_and_writes_a_snapshot(tmp_path, capsys):
    task = main(CLI + ["--num_epoch", "6", "--save_root", str(tmp_path)])
    out = capsys.readouterr().out
    losses = [h["train_loss"] for h in task.history]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert "- Epoch 6/6" in out and '[Validation with "synthetic"]' in out
    assert "- EER" in out and task.history[4]["val_acc"] is not None
    # the epoch-5 snapshot, read by the port and by fr_tpu
    (snap,) = tmp_path.glob("*/5_epoch_encoder.npz")
    model = ResNet((2, 2, 2, 2), emd_size=512, img_size=32)
    model.load_state_dict(load_encoder_npz(str(snap), "ResNet18"),
                          strict=True)
    assert all(torch.isfinite(t).all() for t in model.state_dict().values())
    params, stats, meta = load_encoder(str(snap), "ResNet18")
    assert meta == {"epoch": 5, "name": "ResNet18"}
    np.testing.assert_array_equal(
        np.transpose(params["Conv_0"]["Conv_0"]["kernel"], (3, 2, 0, 1)),
        model.conv1.weight.detach().numpy())
    np.testing.assert_array_equal(stats["BatchNorm_2"]["BatchNorm_0"]["var"],
                                  model.bn3.running_var.numpy())


@pytest.mark.parametrize("use_fused", [False, True])
def test_library_training_step(use_fused):
    """FaceRecognitionTask(stage="train").training_step on uint8 batches,
    augmentation on, sampling 0.3 of 40 classes; use_fused from conf."""
    conf = load_config("ms1m_arcface_122", network="ResNet18")
    conf.update(img_size=32, b=8, n_classes=40, use_fused=use_fused,
                mixed_precision=False, sample_rate=0.3)
    task = FaceRecognitionTask(conf, stage="train", device="cpu")
    assert task.pfc_cfg.use_fused is use_fused
    assert task.pfc_cfg.num_sample == 12
    imgs, labels = synthetic_corpus(40, 1, 32)
    before = task.state.pfc.weight.clone()
    outs = [task.training_step((imgs[i:i + 8], labels[i:i + 8]))
            for i in range(0, 16, 8)]
    assert all(torch.isfinite(o["loss"]) for o in outs)
    assert task.state.step == 2 == task.state.pfc.count
    changed = (task.state.pfc.weight != before).any(dim=1)
    assert 0 < int(changed.sum()) <= 2 * 12
    res = task.training_epoch_end(outs, running_t=1.0)
    assert res["train_loss"] == pytest.approx(
        float(torch.stack([o["loss"] for o in outs]).mean()))


def test_cli_resume_continues_in_the_previous_run_dir(tmp_path, capsys):
    """7 epochs with --sample_block 4 in one run (8 classes in 2 groups, one
    drawn per step), then the same command with --resume: it reuses the run
    directory, restores the epoch-5 save, runs epochs 6 and 7 again, and
    ends with the encoder and head of the uninterrupted run, bit for bit."""
    # a flag given twice takes its last value
    cli = CLI + ["--synthetic_classes", "8", "--sample_rate", "0.5",
                 "--sample_block", "4", "--num_epoch", "7", "--save_root",
                 str(tmp_path)]
    whole = main(cli)
    assert whole.pfc_cfg.sample_block == 4 and whole.pfc_cfg.sampling
    assert len(whole.history) == 7
    (run_dir,) = tmp_path.iterdir()
    assert [p.name for p in (run_dir / "state").iterdir()] == ["5.pt"]
    capsys.readouterr()
    again = main(cli + ["--resume"])
    out = capsys.readouterr().out
    assert [p.name for p in tmp_path.iterdir()] == [run_dir.name]
    assert f"--resume: reusing run dir {run_dir}" in out
    assert "resumed at epoch 5" in out
    assert "6 Epoch Training" in out and "5 Epoch Training" not in out
    assert [h["train_loss"] for h in again.history] == \
        [h["train_loss"] for h in whole.history[5:]]
    assert again.state.step == whole.state.step
    assert torch.equal(again.state.pfc.weight, whole.state.pfc.weight)
    for k, v in whole.encoder.state_dict().items():
        assert torch.equal(again.encoder.state_dict()[k], v), k


def test_cli_resume_without_a_prior_run_starts_afresh(tmp_path, capsys):
    task = main(CLI + ["--synthetic_classes", "4", "--num_epoch", "6",
                       "--save_root", str(tmp_path), "--resume"])
    assert len(task.history) == 6
    assert "resumed at epoch" not in capsys.readouterr().out


@pytest.mark.parametrize("extra,match", [
    (["--mesh_data", "2"], "multi-GPU"),
    (["--mesh_model", "2"], "multi-GPU"),
    (["--distributed"], "multi-GPU"),
])
def test_cli_train_unported_paths_raise(extra, match, tmp_path):
    with pytest.raises(NotImplementedError, match=match):
        main(CLI + ["--num_epoch", "6", "--save_root", str(tmp_path)]
             + extra)


def test_cli_train_without_synthetic_raises(tmp_path, monkeypatch):
    """Without --synthetic the CLI trains from conf.train_dataset_dir, as
    fr_tpu's does; a missing directory raises FileNotFoundError from the
    folder index, before any model is built."""
    from fr_tpu_torch.configs import ms1m_arcface_122
    monkeypatch.setattr(ms1m_arcface_122, "DATA_DIR", str(tmp_path / "FR"))
    argv = [a for a in CLI if a != "--synthetic"]
    with pytest.raises(FileNotFoundError, match="train"):
        main(argv + ["--save_root", str(tmp_path / "save")])


def test_package_source_never_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax)"
                         r"\b", re.M)
    offenders = [str(p) for p in (REPO / "fr_tpu_torch").rglob("*.py")
                 if pattern.search(p.read_text())]
    assert not offenders, offenders


_NO_JAX_TRAIN = """
import sys
from pathlib import Path
from fr_tpu_torch.cli.main import main
task = main(["--config", "ms1m_arcface_122", "--mode", "train",
             "--network", "ResNet18", "--img_size", "32", "--batch", "8",
             "--synthetic", "--synthetic_classes", "4", "--num_epoch", "6",
             "--device", "cpu", "--save_root", sys.argv[1]])
assert len(task.history) == 6
assert list(Path(sys.argv[1]).glob("*/TBLog/events.out.tfevents.*"))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax"))
assert not bad, bad
print("NO_JAX_TRAIN_OK")
"""


def test_cli_training_runs_without_importing_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_TRAIN,
                           str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_TRAIN_OK" in proc.stdout
