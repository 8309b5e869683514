"""Task module: owns the encoder, the PartialFC head, the optimizer state,
the schedule and the evaluation logic (counterpart of fr_tpu/train/task.py),
with fr_tpu's Lightning-style hook names so the Trainer mirrors fr_tpu's
call for call.

On one device: the training hooks (training_step / training_epoch_end,
with prefetch_device_batches to copy host batches ahead of the step), the
validation_* and test_* pair hooks, and the all-pairs cross test
(cross_test_step / cross_test_epoch_end).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from fr_tpu_torch.configs.base import Config
from fr_tpu_torch.utils.logger import print_log
from fr_tpu_torch.utils.summary import model_summary
from fr_tpu_torch.data.augment import augment_cfg_from_conf
from fr_tpu_torch.eval.verification import (cross_score, pair_score,
                                            performance_acc, performance_roc)
from fr_tpu_torch.heads.partial_fc import PFCConfig
from fr_tpu_torch.models import build_encoder
from fr_tpu_torch.models.common import init_weights
from fr_tpu_torch.train.schedule import get_schedule
from fr_tpu_torch.train.state import init_train_state
from fr_tpu_torch.train.step import (embed_global_batch, make_embed_step,
                                     make_train_step, prefetch_to_device)


def pfc_config_from_conf(conf) -> PFCConfig:
    """The head's configuration; use_fused (the margin-softmax CE kernels)
    comes from conf as in fr_tpu, default off."""
    return PFCConfig(
        num_classes=conf.n_classes, embedding_size=conf.emd_size,
        sample_rate=conf.get("sample_rate", 1.0),
        margin=conf.metric, s=conf.loss_s, m=conf.loss_m,
        mixed_precision=conf.mixed_precision, optimizer=conf.optimizer_name,
        use_fused=bool(conf.get("use_fused", False)),
        easy_margin=bool(conf.get("easy_margin", False)),
        sample_block=int(conf.get("sample_block", 1)))


def load_encoder_snapshot(path, network: str, img_size=None):
    """The encoder state dict of ``--ckpt_path`` (fr_tpu's ``load_encoder``,
    ckpt/checkpoint.py:155-162): a reference ``.pth``/``.pt`` snapshot, or
    else fr_tpu's ``.npz`` layout."""
    if str(path).endswith((".pth", ".pt")):
        from fr_tpu_torch.utils.torch_import import load_encoder_pth
        return load_encoder_pth(path, network)
    from fr_tpu_torch.utils.jax_import import load_encoder_npz
    return load_encoder_npz(path, network, img_size)


def resolve_device(name) -> torch.device:
    """The device to run on; raises rather than switching when CUDA is
    asked for and absent."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but torch finds no "
                           "CUDA device; pass --device cpu to run on the CPU")
    return device


class FaceRecognitionTask:
    """Encoder (+ head, optimizer state and schedule for stage "train") and
    eval logic on one device. Training batches are uint8 images; the
    train-time augmentation runs on the device, as in fr_tpu."""

    def __init__(self, conf, logger=None, stage: str = "train",
                 device="cuda", seed: int = 0):
        if stage not in ("train", "test"):
            raise ValueError(f"stage must be 'train' or 'test', got {stage!r}")
        self.conf = conf
        self.logger_ = logger
        self.device = resolve_device(device)
        self.encoder = init_weights(build_encoder(conf), seed)
        if conf.get("ckpt_path"):
            self.encoder.load_state_dict(load_encoder_snapshot(
                conf.ckpt_path, conf.network, conf.img_size), strict=True)
        self.encoder.to(self.device).eval()
        self.pfc_cfg = pfc_config_from_conf(conf)
        # structural summary, as fr_tpu's task logs it (task.py:101-106)
        print_log(logger, model_summary(
            self.encoder,
            head_params=self.pfc_cfg.num_classes_padded * conf.emd_size))
        msg = conf.network
        if stage == "train":
            self.schedule = get_schedule(conf)
            self.epoch = 0
            self.history: List[Dict[str, Any]] = []
            self.state = init_train_state(conf, self.encoder, self.pfc_cfg,
                                          self.device, seed)
            self._train_step = make_train_step(
                conf, self.pfc_cfg, self.device,
                augment_cfg_from_conf(conf))
            msg += (f": head {self.pfc_cfg.num_classes_padded:,} x "
                    f"{conf.emd_size} ({self.pfc_cfg.num_sample:,} columns "
                    f"sampled per step)")
        print_log(logger, f"{msg} on {self.device}")
        self._embed = make_embed_step(conf, self.encoder, self.device)
        self.min_level = conf.min_level
        self.max_level = conf.max_level
        self.val_msg: Dict[str, Config] = {}
        self.test_msg: Dict[str, Config] = {}

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def training_step(self, batch) -> Dict[str, Any]:
        """One optimisation step on (images, labels) host arrays or
        tensors; the loss stays on the device."""
        images, labels = batch
        lr = self.schedule(self.epoch)
        metrics = self._train_step(self.state, images, labels, lr)
        return {"loss": metrics["loss"], "lr": lr}

    def prefetch_device_batches(self, host_iter, depth: int = 2):
        """Host batches copied to the task's device ``depth`` steps ahead,
        on a side stream (train/step.py prefetch_to_device)."""
        return prefetch_to_device(host_iter, self.device, depth)

    def training_epoch_end(self, outputs: List[Dict], running_t=None):
        """Per-epoch report (fr_tpu's text); appends the epoch's results to
        ``history``."""
        train_loss = float(torch.stack([o["loss"] for o in outputs]).mean())
        lr = self.schedule(self.epoch)
        epoch = self.epoch + 1

        msg = "=" * 50
        msg += (f'\n[Training with "{self.conf.train_dataset}"]\n'
                f"- Epoch {epoch}/{self.conf.num_epoch}\n"
                f"- Learning Rate: {lr}\n"
                f"- Train Loss: {train_loss:.4f}\n")
        if running_t is not None:
            msg += f"- Training Time per Epoch: {running_t:.2f}s\n"
            n_imgs = len(outputs) * self.conf.b
            if running_t > 0:
                msg += (f"- Throughput: {n_imgs / running_t:.1f} imgs/sec "
                        f"({n_imgs / running_t:.1f} imgs/sec/chip)\n")

        val_acc = None
        if epoch % self.conf.valid_freq == 0 and self.val_msg:
            val_acc = Config()
            for name, vm in self.val_msg.items():
                val_acc[name] = vm.acc
                msg += "\n".join([
                    f'\n\n[Validation with "{name}"]',
                    f"- Val Accuracy: {vm.acc:.2f}%",
                    f"- Val Inference Time: {vm.infer_time:.2f}ms\n"])
                msg += vm.roc
        msg += "=" * 50 + "\n"
        print_log(self.logger_, msg)
        self.epoch += 1
        results = {"lr": lr, "train_loss": train_loss, "val_acc": val_acc}
        self.history.append(results)
        return results

    # ------------------------------------------------------------------
    # Validation / pair test
    # ------------------------------------------------------------------
    def _shared_eval_step(self, batch, dataset_name: str) -> Dict[str, Any]:
        """pairs (b, 2, H, W, C) → de-interleaved embeddings + wall-clock
        inference time (ms, host-to-host)."""
        pairs, labels = batch
        flat = np.asarray(pairs).reshape((-1,) + pairs.shape[2:])
        start = time.time()
        emb = embed_global_batch(self._embed, flat)
        infer_time = (time.time() - start) * 1000.0
        return {
            f"{dataset_name}_embedding_1": emb[0::2],
            f"{dataset_name}_embedding_2": emb[1::2],
            f"{dataset_name}_infer_time": infer_time,
            f"{dataset_name}_label_list": np.asarray(labels),
            "dataset_name": dataset_name,
        }

    def validation_step(self, batch, dataset_idx: int):
        return self._shared_eval_step(batch,
                                      self.conf.val_dataset[dataset_idx])

    def _eval_epoch_end(self, outputs, sink: Dict[str, Config]):
        name = outputs[0]["dataset_name"]
        infer_time = float(np.mean(
            [o[f"{name}_infer_time"] for o in outputs]))
        labels = np.concatenate([o[f"{name}_label_list"] for o in outputs])
        e1 = np.concatenate([o[f"{name}_embedding_1"] for o in outputs])
        e2 = np.concatenate([o[f"{name}_embedding_2"] for o in outputs])
        hg, hi, scores = pair_score(e1, e2, labels)
        roc, eer_th = performance_roc(hg, hi, min_level=self.min_level,
                                      max_level=self.max_level)
        acc = performance_acc(scores, labels, eer_th)
        sink[name] = Config(acc=acc, infer_time=infer_time, roc=roc,
                            embeddings=(e1, e2))

    def validation_epoch_end(self, outputs):
        self._eval_epoch_end(outputs, self.val_msg)

    def test_step(self, batch, dataset_idx: int):
        return self._shared_eval_step(batch,
                                      self.conf.test_dataset[dataset_idx])

    def test_epoch_end(self, outputs):
        self._eval_epoch_end(outputs, self.test_msg)

    # ------------------------------------------------------------------
    # Cross test (all pairs; reference model/FR_PartialFC.py:379-427)
    # ------------------------------------------------------------------
    def cross_test_step(self, batch, dataset_idx: int) -> Dict[str, Any]:
        """images (b, H, W, C) normalised float → embeddings + wall-clock
        inference time (ms, host to host)."""
        name = self.conf.test_dataset[dataset_idx]
        images, labels = batch
        start = time.time()
        emb = embed_global_batch(self._embed, np.asarray(images))
        infer_time = (time.time() - start) * 1000.0
        return {f"{name}_embedding": emb,
                f"{name}_label_list": np.asarray(labels),
                f"{name}_infer_time": infer_time,
                "dataset_name": name}

    def cross_test_epoch_end(self, outputs):
        """Scores every pair i > j of the test set's embeddings on the host
        in f64 (cross_score), then the ROC report and the accuracy at the
        EER threshold."""
        name = outputs[0]["dataset_name"]
        infer_time = float(np.mean([o[f"{name}_infer_time"]
                                    for o in outputs]))
        labels = np.concatenate([o[f"{name}_label_list"] for o in outputs])
        emb = np.concatenate([o[f"{name}_embedding"] for o in outputs])
        hg, hi, scores, pair_labels = cross_score(emb, labels)
        roc, eer_th = performance_roc(hg, hi, min_level=self.min_level,
                                      max_level=self.max_level)
        acc = performance_acc(scores, pair_labels, eer_th)
        self.test_msg[name] = Config(acc=acc, infer_time=infer_time, roc=roc,
                                     embeddings=emb)
