"""The port's task and trainer against fr_tpu's defaults and checkpoints:
``FaceRecognitionTask(conf)`` and ``Trainer(conf, dir)`` train by default,
as fr_tpu's do (fr_tpu/train/task.py:64, fr_tpu/train/trainer.py:20), and
``--ckpt_path`` takes a reference ``.pth`` written by fr_tpu's
``export_encoder_pth``, whose embeddings are fr_tpu's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fr_tpu.configs import load_config
from fr_tpu.models import build_encoder as jax_build_encoder
from fr_tpu.parallel import make_mesh
from fr_tpu.train.step import make_embed_step as jax_make_embed_step
from fr_tpu.utils.torch_export import export_encoder_pth
from fr_tpu_torch.data.synthetic import synthetic_corpus
from fr_tpu_torch.train.step import make_embed_step
from fr_tpu_torch.train.task import FaceRecognitionTask
from fr_tpu_torch.train.trainer import Trainer
from fr_tpu_torch.utils.torch_import import load_encoder_pth
from test_torch_cpu_threads import one_torch_thread  # noqa: F401


def _tiny_resnet_conf():
    conf = load_config("ms1m_arcface_122", network="ResNet18")
    conf.update(img_size=32, b=8, n_classes=16, mixed_precision=False,
                sample_rate=1.0)
    return conf


def test_task_and_trainer_default_to_training(tmp_path):
    """Built with their defaults, both are in training mode and the task
    takes a step (ResNet18, 32 px, f32 on the CPU)."""
    conf = _tiny_resnet_conf()
    task = FaceRecognitionTask(conf, device="cpu")
    trainer = Trainer(conf, tmp_path)
    assert trainer.mode == "train" and trainer.save_dir == tmp_path
    assert task.schedule(0) > 0
    imgs, labels = synthetic_corpus(16, 1, 32)
    out = task.training_step((imgs[:8], labels[:8]))
    assert torch.isfinite(out["loss"]) and task.state.step == 1


def _seeded_stats(tree, rng):
    """BN statistics away from their init, so that a mix-up shows."""
    def leaf(path, x):
        x = np.asarray(x)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        return rng.normal(0.0, 0.1, x.shape).astype(x.dtype)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.mark.parametrize("network,img_size,ddp", [
    ("ResNet18", 32, False), ("ResNet18", 32, True),
    ("AlterNet50", 96, False)])
def test_pth_snapshot_loads_through_ckpt_path(tmp_path, network, img_size,
                                               ddp):
    """fr_tpu's export_encoder_pth from seeded flax weights → the port's
    task with ckpt_path → embeddings equal fr_tpu's embed step on the same
    images. f32 on both sides; max-abs ≤ 1e-4 covers the two frameworks'
    f32 summation orders through the encoder. ``ddp`` wraps the state dict
    the way DDP saves it (``module.`` prefixes, no model_state_dict)."""
    conf = load_config("ms1m_arcface_122", network=network)
    conf.update(img_size=img_size, mixed_precision=False)
    x = np.random.default_rng(7).standard_normal(
        (2, img_size, img_size, 3)).astype(np.float32)
    enc = jax_build_encoder(conf)
    variables = jax.jit(lambda k, v: enc.init(k, v, train=False))(
        jax.random.key(3), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = _seeded_stats(variables["batch_stats"],
                          np.random.default_rng(11))
    path = tmp_path / "1_epoch_encoder.pth"
    export_encoder_pth(str(path), params, stats, network, epoch=1,
                       img_size=img_size)
    if ddp:
        sd = torch.load(path, weights_only=True)["model_state_dict"]
        path = tmp_path / "ddp_encoder.pt"
        torch.save({f"module.{k}": v for k, v in sd.items()}, path)

    conf.ckpt_path = str(path)
    task = FaceRecognitionTask(conf, stage="test", device="cpu")
    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    ref = np.asarray(jax_make_embed_step(conf, mesh, enc)(
        params, stats, jnp.asarray(x)))
    out = make_embed_step(conf, task.encoder, "cpu")(x).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-4


@pytest.mark.parametrize("network", ["AlterNetV1_50", "AlterNetSep50"])
def test_pth_of_networks_without_a_naming_raises(tmp_path, network):
    """fr_tpu has no .pth naming for AlterNetV1 or AlterNetSep; the port
    raises naming the network before it reads the file."""
    with pytest.raises(NotImplementedError, match=network):
        load_encoder_pth(str(tmp_path / "missing.pth"), network)
