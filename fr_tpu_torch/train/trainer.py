"""Training and test loops (counterpart of fr_tpu/train/trainer.py), with
the same report text.

The training loop: epochs of the loader's batches through the task's
training step (host batches copied to the device a few steps ahead by the
task's prefetch, a device-resident loader's batches as they come),
validation every ``valid_freq`` epochs, the epoch report, TensorBoard
scalars, and, every ``save_epoch`` epochs, an encoder snapshot in fr_tpu's
``.npz`` layout beside the full resumable state (ckpt/checkpoint.py).
``resume`` restores the newest state under the save directory and goes on at
its epoch; the loader's order, the schedule and the state's generators make
the resumed run the uninterrupted one, bit for bit. ``profile_steps`` records
a ``torch.profiler`` trace of that many steps of the first epoch.

On a mesh every rank runs the loops, and only rank 0 writes: the log, the
TensorBoard scalars, the snapshots and the profile trace (ROADMAP §3: fr_tpu
is one controller and needs no such gate). The full-state checkpoint is
collective, as ckpt/checkpoint.py says; the other ranks wait at a barrier
while rank 0 writes the snapshot.
"""

from __future__ import annotations

import sys
import time
import types
from pathlib import Path
from typing import Dict, List, Optional

import torch

from fr_tpu_torch.utils.logger import print_log


def _start_profile(device):
    """A started torch.profiler session: the host's activity, and the
    device's on CUDA. Each profiled step is one ``ProfilerStep#`` range."""
    from torch.profiler import ProfilerAction, ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    # a schedule that records every step makes the profiler mark the steps
    prof = profile(activities=activities,
                   schedule=lambda _: ProfilerAction.RECORD)
    prof.start()
    return prof


def _summary_writer(log_dir: str):
    """A torch.utils.tensorboard SummaryWriter on TensorBoard's own
    TensorFlow stub. TensorBoard otherwise imports TensorFlow where it is
    installed (tensorboard/compat/__init__.py), and TensorFlow brings Keras
    and its backends into the training process; the event files are the
    same either way."""
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    from torch.utils.tensorboard import SummaryWriter
    return SummaryWriter(log_dir)


class Trainer:
    def __init__(self, conf, save_dir, mode: str = "train", logger=None,
                 tensorboard: bool = True, rank: int = 0):
        assert mode in ("train", "test"), "Invalid Mode !!!"
        self.mode = mode
        self.conf = conf
        self.save_dir = Path(save_dir)
        self.writes = rank == 0
        self.logger_ = logger if self.writes else None
        self.writer = None
        if mode == "train" and tensorboard and self.writes:
            try:
                self.writer = _summary_writer(str(self.save_dir / "TBLog"))
            except ImportError as e:
                print_log(logger, f"TensorBoard logging is off: {e}")
            else:
                self.writer.add_text(
                    "Config", "".join(f"{k} : {v}  \n"
                                      for k, v in conf.items()), 0)

    def _write_scalars(self, results: Dict, epoch: int) -> None:
        """The epoch's scalars under fr_tpu's tags
        (fr_tpu/train/trainer.py:106-116)."""
        ds = self.conf.train_dataset
        self.writer.add_scalar(f"{ds}/Learning Rate", results["lr"], epoch)
        self.writer.add_scalar(f"{ds}/Train Loss", results["train_loss"],
                               epoch)
        for name, acc in (results["val_acc"] or {}).items():
            self.writer.add_scalar(f"{ds}/{name} Validation ACC", acc, epoch)
        self.writer.flush()

    def train(self, task, train_loader, val_datasets: Optional[Dict] = None,
              resume: bool = False, profile_steps: int = 0):
        """task: FaceRecognitionTask(stage="train"); train_loader: with
        .epoch(e); val_datasets: {name: pair dataset}.

        profile_steps > 0 records a torch.profiler trace of that many steps
        of the first epoch, from its second step (the first is the warm
        one), as fr_tpu does (trainer.py:72-77), into
        <save_dir>/profile/trace.json (Chrome trace format)."""
        from fr_tpu_torch.ckpt import (latest_step, restore_train_state,
                                       save_train_state)
        from fr_tpu_torch.utils.jax_import import export_encoder_npz

        conf = self.conf
        mesh = task.mesh
        profile_steps = profile_steps if self.writes else 0
        start_epoch = 0
        if resume:
            step = latest_step(self.save_dir)
            if step is not None:
                restore_train_state(self.save_dir, task.state, step, mesh)
                start_epoch = step
                task.epoch = step
                print_log(self.logger_, f"resumed at epoch {step}")

        for epoch in range(start_epoch, conf.num_epoch):
            running_t = 0.0
            train_outputs: List[Dict] = []
            print_log(self.logger_, f"{epoch + 1} Epoch Training")
            if getattr(train_loader, "device_resident", False):
                # the corpus lives on the device; batches are already there
                batches = train_loader.epoch(epoch)
            else:
                batches = task.prefetch_device_batches(
                    train_loader.epoch(epoch))
            prof = None
            try:
                for step_i, batch in enumerate(batches):
                    if profile_steps and epoch == start_epoch:
                        if step_i == 1:
                            prof = _start_profile(task.device)
                        elif prof is not None:
                            if step_i == 1 + profile_steps:
                                self._stop_profile(prof, task.device)
                                prof = None
                            else:
                                prof.step()
                    t0 = time.time()
                    train_outputs.append(task.training_step(batch))
                    running_t += time.time() - t0
            finally:
                getattr(batches, "close", lambda: None)()
                if prof is not None:
                    self._stop_profile(prof, task.device)
            # the steps run asynchronously on the device: fetch the last
            # loss inside the timed region so the epoch time is honest
            if train_outputs:
                t0 = time.time()
                float(train_outputs[-1]["loss"])
                running_t += time.time() - t0

            if (epoch + 1) % conf.valid_freq == 0 and val_datasets:
                print_log(self.logger_, f"{epoch + 1} Epoch Validation")
                for v_idx, (name, ds) in enumerate(val_datasets.items()):
                    val_outputs = [task.validation_step(b, v_idx)
                                   for b in ds.batches(conf.b)]
                    task.validation_epoch_end(val_outputs)

            results = task.training_epoch_end(train_outputs, running_t)
            if self.writer is not None:
                self._write_scalars(results, epoch)

            if (epoch + 1) % conf.save_epoch == 0:
                if self.writes:
                    export_encoder_npz(
                        str(self.save_dir / f"{epoch + 1}_epoch_encoder.npz"),
                        task.encoder, epoch + 1, conf.network, conf.img_size)
                save_train_state(self.save_dir, task.state, epoch + 1, mesh)
        return task

    def _stop_profile(self, prof, device) -> None:
        """Waits for the device, so that the last step's kernels are in the
        trace, then writes it and logs its path."""
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        path = self.save_dir / "profile" / "trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        print_log(self.logger_, f"profile trace: {path}")

    def test(self, task, test_datasets: Dict):
        """Pair or cross test (conf.test_type) over each dataset;
        conf.test_b pairs or images per batch."""
        conf = self.conf
        test_b = int(conf.get("test_b", 1) or 1)
        for t_idx, (name, ds) in enumerate(test_datasets.items()):
            print_log(self.logger_, f"{t_idx + 1}th Test Dataset")
            if conf.get("test_type", "pair") == "pair":
                outs = [task.test_step(b, t_idx) for b in ds.batches(test_b)]
                task.test_epoch_end(outs)
            else:
                outs = [task.cross_test_step(b, t_idx)
                        for b in ds.batches(test_b)]
                task.cross_test_epoch_end(outs)

        msg = "=" * 50
        for name, tm in task.test_msg.items():
            msg += "\n".join([
                f'\n\n[Test with "{name}"]',
                f"- Test Accuracy: {tm.acc:.2f}%",
                f"- Test Inference Time: {tm.infer_time:.2f}ms\n"])
            msg += tm.roc
        msg += "=" * 50 + "\n"
        print_log(self.logger_, msg)
        return task.test_msg
