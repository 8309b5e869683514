"""The port trainer's observability against fr_tpu's: ``--profile N``
writes a torch.profiler Chrome trace of N training steps (CPU events on the
CPU), from the first epoch's second step, stopping at the epoch's end if
that comes first; the TensorBoard scalars carry fr_tpu's tags and learning
rates (fr_tpu's trainer and task on the same tiny synthetic config, built
as its CLI builds them: ResNet18 at 16 px, 3 classes, batch 8, 6 epochs)
and the port's own losses; without torch.utils.tensorboard the writer is
off and the run goes on."""

import builtins
import json

import numpy as np
import pytest

from fr_tpu import configs as jax_configs
from fr_tpu_torch import configs as port_configs
from fr_tpu_torch.cli.main import main
from fr_tpu_torch.configs import load_config
from fr_tpu_torch.data import ArrayTrainLoader, synthetic_corpus
from fr_tpu_torch.train.task import FaceRecognitionTask
from fr_tpu_torch.train.trainer import Trainer
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

ARGS = ["--config", "ms1m_arcface_122", "--mode", "train", "--network",
        "ResNet18", "--img_size", "16", "--batch", "8", "--synthetic",
        "--synthetic_classes", "3", "--sample_rate", "1.0", "--num_epoch",
        "6"]


def _no_saves(load_config):
    """The config with no epoch snapshot in 6 epochs: the runs below are
    about their logs, and fr_tpu's checkpoint writes cost seconds."""
    def load(*args, **kwargs):
        conf = load_config(*args, **kwargs)
        conf.save_epoch = 100
        return conf
    return load


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_configs, "load_config",
                   _no_saves(port_configs.load_config))
        task = main(ARGS + ["--device", "cpu", "--profile", "2",
                            "--save_root", str(root)])
    (run_dir,) = root.iterdir()
    return task, run_dir


@pytest.fixture(scope="module")
def jax_run_dir(tmp_path_factory):
    """fr_tpu's trainer over fr_tpu's task, built as its CLI builds them
    from ARGS (fr_tpu/cli/main.py:175-193), on a one-device mesh: the
    scalars do not depend on the mesh, and the CLI's mesh over every CPU
    device costs a compile of seconds more. fr_tpu's trainer never closes
    its writer, whose events reach the disk after flush_secs (120 s) or at
    exit: a subclass that keeps each writer lets the test close it after
    the run."""
    import jax
    import torch.utils.tensorboard as tb
    from fr_tpu.cli.main import _loaders, build_conf, parse_args
    from fr_tpu.parallel import make_mesh
    from fr_tpu.train.task import FaceRecognitionTask as JaxTask
    from fr_tpu.train.trainer import Trainer as JaxTrainer
    writers = []

    class Kept(tb.SummaryWriter):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            writers.append(self)

    run_dir = tmp_path_factory.mktemp("jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tb, "SummaryWriter", Kept)
        mp.setattr(jax_configs, "load_config",
                   _no_saves(jax_configs.load_config))
        args = parse_args(ARGS)
        conf = build_conf(args)
        mesh = make_mesh(devices=jax.devices()[:1])
        train, vals = _loaders(args, conf, mesh)
        task = JaxTask(conf, stage="train", mesh=mesh)
        JaxTrainer(conf, run_dir, "train").train(task, train, vals)
    assert len(writers) == 1
    writers[0].close()
    return run_dir


def _events(run_dir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    acc = EventAccumulator(str(run_dir / "TBLog"))
    acc.Reload()
    return acc


def _trace_steps(path):
    events = json.loads(path.read_text())["traceEvents"]
    steps = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("ProfilerStep#")),
                   key=lambda e: e["ts"])
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    return steps, ops


def test_profile_writes_a_trace_of_two_steps(port_run):
    task, run_dir = port_run
    steps, ops = _trace_steps(run_dir / "profile" / "trace.json")
    assert [e["name"] for e in steps] == ["ProfilerStep#0", "ProfilerStep#1"]
    for step in steps:  # each step holds the step's operators
        inside = [e for e in ops
                  if step["ts"] <= e["ts"] <= step["ts"] + step["dur"]]
        assert any(e["name"] == "aten::convolution" for e in inside)
    assert f"profile trace: {run_dir}/profile/trace.json" in \
        (run_dir / "log.txt").read_text()
    assert len(task.history) == 6


def _tiny_task(img_size=16):
    conf = load_config("ms1m_arcface_122", network="ResNet18")
    conf.update(img_size=img_size, b=8, n_classes=4, sample_rate=1.0,
                num_epoch=1, warmup_steps=0, mixed_precision=False)
    imgs, labels = synthetic_corpus(4, 8, img_size)
    return conf, FaceRecognitionTask(conf, device="cpu"), \
        ArrayTrainLoader(imgs, labels, 8)


def test_profile_stops_at_the_end_of_the_epoch(tmp_path):
    """4 steps an epoch and --profile 10: steps 2 to 4 are traced."""
    conf, task, loader = _tiny_task()
    Trainer(conf, tmp_path, tensorboard=False).train(task, loader,
                                                     profile_steps=10)
    steps, _ = _trace_steps(tmp_path / "profile" / "trace.json")
    assert len(steps) == 3
    assert not (tmp_path / "TBLog").exists()


def test_tensorboard_tags_and_learning_rates_equal_fr_tpu(port_run,
                                                          jax_run_dir):
    ours, ref = _events(port_run[1]), _events(jax_run_dir)
    tags = ours.Tags()["scalars"]
    assert sorted(tags) == sorted(ref.Tags()["scalars"])
    assert sorted(tags) == ["ms1m_arcface_122/Learning Rate",
                            "ms1m_arcface_122/Train Loss",
                            "ms1m_arcface_122/synthetic Validation ACC"]
    lr = [(e.step, e.value) for e in
          ours.Scalars("ms1m_arcface_122/Learning Rate")]
    assert lr == [(e.step, e.value) for e in
                  ref.Scalars("ms1m_arcface_122/Learning Rate")]
    assert [s for s, _ in lr] == list(range(6))
    assert [e.step for e in ours.Scalars(
        "ms1m_arcface_122/synthetic Validation ACC")] == [4]
    assert ours.Tags()["tensors"] == ref.Tags()["tensors"] == \
        ["Config/text_summary"]


def test_tensorboard_losses_are_the_runs_history(port_run):
    task, run_dir = port_run
    losses = [e.value for e in
              _events(run_dir).Scalars("ms1m_arcface_122/Train Loss")]
    np.testing.assert_array_equal(
        np.float32(losses), np.float32([h["train_loss"]
                                        for h in task.history]))
    acc = _events(run_dir).Scalars(
        "ms1m_arcface_122/synthetic Validation ACC")
    assert acc[0].value == np.float32(task.history[4]["val_acc"]["synthetic"])


def test_without_tensorboard_the_writer_is_off(tmp_path, monkeypatch,
                                               capsys):
    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("No module named 'tensorboard'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    conf, task, loader = _tiny_task()
    trainer = Trainer(conf, tmp_path)
    assert trainer.writer is None
    trainer.train(task, loader)
    out = capsys.readouterr().out
    assert out.count("TensorBoard logging is off") == 1
    assert len(task.history) == 1 and not (tmp_path / "TBLog").exists()
