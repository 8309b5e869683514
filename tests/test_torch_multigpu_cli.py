"""The CLI on a mesh of two CPU processes: torchrun (python -m
torch.distributed.run) launches ``fr_tpu_torch.cli.main --distributed
--mesh_model 2 --device cpu`` over gloo. Training (ResNet18 at 32 px, a
global batch of 8, 4 synthetic identities, 6 epochs: the schedule's 5
warm-up epochs need a sixth) gives finite losses, one run directory with
one log and the epoch-5 snapshot, written by rank 0, and the ROC report.
Then ``--mode test`` from that snapshot at two ranks reports what one
process reports."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fr_tpu_torch.cli.main import main
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--config", "ms1m_arcface_122", "--network", "ResNet18",
         "--img_size", "32", "--batch", "8", "--synthetic",
         "--synthetic_classes", "4", "--sample_rate", "1.0",
         "--device", "cpu"]


def _torchrun(argv, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "fr_tpu_torch.cli.main",
         "--distributed", "--mesh_model", "2"] + argv,
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def _report(log: Path):
    """The test report's lines but the timing."""
    text = log.read_text()
    body = text[text.index('[Test with "synthetic"]'):]
    return [line for line in body.splitlines() if "Time" not in line]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    out = _torchrun(SMALL + ["--mode", "train", "--num_epoch", "6",
                             "--save_root", str(root / "train")], root)
    return root, out


def test_torchrun_trains_on_two_ranks(trained):
    root, out = trained
    (run,) = (root / "train").iterdir()
    log = (run / "log.txt").read_text()
    losses = [float(x) for x in re.findall(r"- Train Loss: (\S+)", log)]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert "rank 0 of a 1 x 2 mesh" in log
    assert "on each of 2 shards" in log
    assert '[Validation with "synthetic"]' in log and "- EER" in log
    assert sorted(p.name for p in run.glob("*.npz")) == [
        "5_epoch_encoder.npz"]
    assert sorted(p.name for p in (run / "state").iterdir()) == ["5.pt"]
    # rank 1 logged nothing to the file: one mesh line, from rank 0
    assert log.count("of a 1 x 2 mesh") == 1
    assert "rank 1 of a 1 x 2 mesh" in out


def test_torchrun_test_mode_reports_what_one_process_does(trained):
    root, _ = trained
    (snap,) = (root / "train").glob("*/5_epoch_encoder.npz")
    argv = SMALL + ["--mode", "test", "--ckpt_path", str(snap),
                    "--test_b", "16"]
    _torchrun(argv + ["--save_root", str(root / "two")], root)
    msg = main(argv + ["--save_root", str(root / "one")])
    (two,) = (root / "two").glob("*/log.txt")
    (one,) = (root / "one").glob("*/log.txt")
    assert "- EER" in one.read_text() and msg["synthetic"].acc > 0
    assert _report(two) == _report(one)
