"""Training and test loops (counterpart of fr_tpu/train/trainer.py), with
the same report text.

The training loop: epochs of the loader's batches through the task's
training step (host batches copied to the device a few steps ahead by the
task's prefetch, a device-resident loader's batches as they come),
validation every ``valid_freq`` epochs, the epoch report, and, every ``save_epoch`` epochs, an encoder snapshot in fr_tpu's ``.npz``
layout beside the full resumable state (ckpt/checkpoint.py). ``resume``
restores the newest state under the save directory and goes on at its
epoch; the loader's order, the schedule and the state's generators make the
resumed run the uninterrupted one, bit for bit. Not ported yet: the
profiler trace (``profile_steps``, ROADMAP §1, tools and the port's bench)
and TensorBoard scalars.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional

from fr_tpu_torch.utils.logger import print_log


class Trainer:
    def __init__(self, conf, save_dir, mode: str = "train", logger=None):
        assert mode in ("train", "test"), "Invalid Mode !!!"
        self.mode = mode
        self.conf = conf
        self.save_dir = Path(save_dir)
        self.logger_ = logger

    def train(self, task, train_loader, val_datasets: Optional[Dict] = None,
              resume: bool = False, profile_steps: int = 0):
        """task: FaceRecognitionTask(stage="train"); train_loader: with
        .epoch(e); val_datasets: {name: pair dataset}."""
        if profile_steps:
            raise NotImplementedError(
                "--profile is not ported yet: ROADMAP §1, tools and the "
                "port's bench")
        from fr_tpu_torch.ckpt import (latest_step, restore_train_state,
                                       save_train_state)
        from fr_tpu_torch.utils.jax_import import export_encoder_npz

        conf = self.conf
        start_epoch = 0
        if resume:
            step = latest_step(self.save_dir)
            if step is not None:
                restore_train_state(self.save_dir, task.state, step)
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
            try:
                for batch in batches:
                    t0 = time.time()
                    train_outputs.append(task.training_step(batch))
                    running_t += time.time() - t0
            finally:
                getattr(batches, "close", lambda: None)()
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

            task.training_epoch_end(train_outputs, running_t)

            if (epoch + 1) % conf.save_epoch == 0:
                export_encoder_npz(
                    str(self.save_dir / f"{epoch + 1}_epoch_encoder.npz"),
                    task.encoder, epoch + 1, conf.network, conf.img_size)
                save_train_state(self.save_dir, task.state, epoch + 1)
        return task

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
