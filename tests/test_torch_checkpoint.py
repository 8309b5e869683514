"""Full-state checkpoints of the port (fr_tpu_torch/ckpt/checkpoint.py;
counterpart of tests/test_checkpoint.py for fr_tpu's): exact resume with the
port's own random streams on, ``latest_step``, the padding migration across
``sample_block`` settings in both directions, the mismatches that must
raise, and a fr_tpu state with a padded head crossing into the port.

Exact means bitwise: three steps, a save, and two more steps against a
restore into a differently initialised state and the same two steps. The
step draws its negatives (per row or in groups), its augmentation and its
dropout masks from the state's three generators, so the comparison fails
unless the checkpoint restores all three."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from fr_tpu.heads import partial_fc as jax_pfc
from fr_tpu.models import resnet as jax_resnet
from fr_tpu.train.optim import init_slots as jax_init_slots
from fr_tpu.train.state import TrainState as JaxTrainState
from fr_tpu_torch.ckpt import (latest_step, restore_train_state,
                               save_train_state)
from fr_tpu_torch.ckpt.checkpoint import _migrate_pfc_padding, _tree
from fr_tpu_torch.configs import load_config
from fr_tpu_torch.data.augment import augment_cfg_from_conf
from fr_tpu_torch.heads.partial_fc import PFCConfig
from fr_tpu_torch.models import resnet
from fr_tpu_torch.models.common import (BatchNorm2d, Conv, Dense, dropout,
                                        init_weights)
from fr_tpu_torch.train.state import init_train_state
from fr_tpu_torch.train.step import make_train_step
from fr_tpu_torch.utils.jax_import import train_state_from_jax
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

IMG, EMB, NCLS, BATCH = 16, 16, 37, 8


class TinyEncoder(nn.Module):
    """conv → BN → ReLU → dropout 0.3 → dense: small, and it draws from the
    dropout generator in training."""

    def __init__(self):
        super().__init__()
        self.conv = Conv(3, 8, 3, 2, torch.float32)
        self.bn = BatchNorm2d(8)
        self.fc = Dense(8 * (IMG // 2) ** 2, EMB)

    def forward(self, x, generator=None):
        x = F.relu(self.bn(self.conv(x.permute(0, 3, 1, 2))))
        if self.training:
            x = dropout(x, 0.3, generator)
        return self.fc(x.flatten(1))


def _conf(optimizer):
    conf = load_config("ms1m_arcface_122", optimizer=optimizer)
    conf.update(n_classes=NCLS, emd_size=EMB, mixed_precision=False)
    return conf


def _cfg(conf, block):
    return PFCConfig(NCLS, EMB, sample_rate=0.5, margin="ArcFace", s=30.0,
                     m=0.35, mixed_precision=False,
                     optimizer=conf.optimizer_name, sample_block=block)


def _fresh(conf, cfg, seed):
    """A state and its step with augmentation on, from ``seed``."""
    state = init_train_state(conf, init_weights(TinyEncoder(), seed), cfg,
                             "cpu", seed)
    return state, make_train_step(conf, cfg, "cpu",
                                  augment_cfg_from_conf(conf))


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (BATCH, IMG, IMG, 3)).astype(np.uint8),
             rng.integers(0, NCLS, BATCH).astype(np.int32))
            for _ in range(n)]


def _tensors(tree, path=""):
    """Every tensor and counter of a state's tree, flat."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tensors(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _assert_states_equal(a, b):
    ta, tb = _tensors(_tree(a)), _tensors(_tree(b))
    assert set(ta) == set(tb)
    for k in ta:
        if isinstance(ta[k], torch.Tensor):
            assert torch.equal(ta[k], tb[k]), k
        else:
            assert ta[k] == tb[k], k


@pytest.mark.parametrize("block", [1, 4], ids=["per-row", "block4"])
@pytest.mark.parametrize("optimizer", ["SGD", "AdamW"])
def test_resume_is_bitwise_exact(tmp_path, optimizer, block):
    conf = _conf(optimizer)
    cfg = _cfg(conf, block)
    assert cfg.sampling
    batches = _batches(5)
    state, step = _fresh(conf, cfg, seed=0)
    for images, labels in batches[:3]:
        step(state, images, labels, 0.05)
    save_train_state(tmp_path, state, 3)
    assert latest_step(tmp_path) == 3
    direct = [step(state, images, labels, 0.05)["loss"].item()
              for images, labels in batches[3:]]

    # another initialisation and other generator states: the restore must
    # replace every tensor, both counters and all three generators
    other, other_step = _fresh(conf, cfg, seed=7)
    other_step(other, *batches[0], 0.05)
    assert restore_train_state(tmp_path, other) is other
    assert other.step == 3 == other.pfc.count
    resumed = [other_step(other, images, labels, 0.05)["loss"].item()
               for images, labels in batches[3:]]
    assert resumed == direct
    _assert_states_equal(other, state)
    assert state.step == 5 == state.pfc.count


def test_resume_needs_the_generators(tmp_path):
    """The check above can see a generator that was not restored: with the
    saved sampling stream replaced, the resumed steps differ."""
    conf = _conf("SGD")
    cfg = _cfg(conf, 4)
    batches = _batches(5)
    state, step = _fresh(conf, cfg, seed=0)
    for images, labels in batches[:3]:
        step(state, images, labels, 0.05)
    save_train_state(tmp_path, state, 3)
    direct = [step(state, images, labels, 0.05)["loss"].item()
              for images, labels in batches[3:]]
    other, other_step = _fresh(conf, cfg, seed=7)
    restore_train_state(tmp_path, other)
    other.generators["dropout"].manual_seed(123)
    resumed = [other_step(other, images, labels, 0.05)["loss"].item()
               for images, labels in batches[3:]]
    assert resumed != direct


def test_latest_step_and_explicit_step(tmp_path):
    assert latest_step(tmp_path) is None
    conf = _conf("SGD")
    cfg = _cfg(conf, 1)
    with pytest.raises(FileNotFoundError):
        restore_train_state(tmp_path, _fresh(conf, cfg, 0)[0])
    state, step = _fresh(conf, cfg, seed=0)
    saved = {}
    for i, (images, labels) in enumerate(_batches(3), start=1):
        step(state, images, labels, 0.05)
        save_train_state(tmp_path, state, i * 5)
        saved[i * 5] = state.pfc.weight.clone()
    assert sorted(p.name for p in (tmp_path / "state").iterdir()) == \
        ["10.pt", "15.pt", "5.pt"]
    assert latest_step(tmp_path) == 15
    target, _ = _fresh(conf, cfg, seed=3)
    restore_train_state(tmp_path, target, 10)
    assert target.step == 2 and torch.equal(target.pfc.weight, saved[10])
    restore_train_state(tmp_path, target)
    assert target.step == 3 and torch.equal(target.pfc.weight, saved[15])


def test_restore_migrates_sample_block_padding(tmp_path):
    """Saved under sample_block 1 (37 rows), restored under 4 (40 rows) and
    back: the real rows survive bit for bit, the new tail is zero, the
    migrated state trains, and nothing but the head's class axis may
    differ."""
    conf = _conf("SGD")
    cfg1, cfg4 = _cfg(conf, 1), _cfg(conf, 4)
    assert (cfg1.num_classes_padded, cfg4.num_classes_padded) == (37, 40)
    state1, step1 = _fresh(conf, cfg1, seed=0)
    batches = _batches(4)
    for images, labels in batches[:3]:
        step1(state1, images, labels, 0.05)
    save_train_state(tmp_path, state1, 3)

    state4, step4 = _fresh(conf, cfg4, seed=9)
    restore_train_state(tmp_path, state4)
    assert state4.pfc.weight.shape == (40, EMB)
    for ours, ref in ((state4.pfc.weight, state1.pfc.weight),
                      (state4.pfc.slots["momentum"],
                       state1.pfc.slots["momentum"])):
        assert torch.equal(ours[:NCLS], ref)
        assert (ours[NCLS:] == 0).all()
    for k, v in state1.encoder.state_dict().items():
        assert torch.equal(state4.encoder.state_dict()[k], v), k
    m = step4(state4, *batches[3], 0.05)
    assert torch.isfinite(m["loss"]) and state4.step == 4

    # truncation: the block-4 state back into a block-1 one
    save_train_state(tmp_path / "b4", state4, 4)
    back, _ = _fresh(conf, cfg1, seed=3)
    restore_train_state(tmp_path / "b4", back)
    assert back.pfc.weight.shape == (37, EMB)
    assert torch.equal(back.pfc.weight, state4.pfc.weight[:NCLS])

    # any other mismatch raises
    raw = _tree(state1)
    bad = dict(raw, encoder=dict(raw["encoder"]))
    bad["encoder"]["fc.weight"] = torch.zeros(EMB + 1, 8 * (IMG // 2) ** 2)
    with pytest.raises(ValueError, match="shape mismatch"):
        _migrate_pfc_padding(bad, raw)
    wide = dict(raw, pfc=dict(raw["pfc"], weight=torch.zeros(37, EMB + 1)))
    with pytest.raises(ValueError, match="shape mismatch"):
        _migrate_pfc_padding(wide, raw)
    adam, _ = _fresh(_conf("AdamW"), dataclasses.replace(
        cfg1, optimizer="AdamW"), seed=0)
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_train_state(tmp_path, adam)


def test_fr_tpu_state_with_a_padded_head_crosses(tmp_path):
    """train_state_from_jax on a fr_tpu state built with sample_block 4: the
    head arrays are copied as they are, so their padded shape must be the
    port's; the state then saves, restores and takes a grouped step."""
    layers, n_classes = (1, 1, 1, 1), 298
    enc = jax_resnet.ResNet(layers=layers, emd_size=EMB)
    variables = jax.jit(lambda k: enc.init(
        k, jnp.zeros((1, 32, 32, 3), jnp.float32), train=True))(
        jax.random.key(0))
    jcfg = jax_pfc.PFCConfig(n_classes, EMB, 1, 0.5, "ArcFace", 30.0, 0.35,
                             False, "AdamW", sample_block=4)
    jstate = JaxTrainState(
        step=jnp.asarray(6, jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_slots=jax_init_slots("AdamW", variables["params"]),
        pfc=jax_pfc.init_pfc_state(jax.random.key(1), jcfg).replace(
            count=jnp.asarray(6, jnp.int32)))
    cfg = PFCConfig(n_classes, EMB, sample_rate=0.5, margin="ArcFace",
                    s=30.0, m=0.35, mixed_precision=False, optimizer="AdamW",
                    sample_block=4)
    state = train_state_from_jax(
        jstate, resnet.ResNet(layers, emd_size=EMB, img_size=32), "ResNet",
        plan=layers)
    assert state.pfc.weight.shape == (300, EMB) == \
        (cfg.num_classes_padded, EMB)
    assert {k: v.shape for k, v in state.pfc.slots.items()} == {
        "exp_avg": (300, EMB), "exp_avg_sq": (300, EMB)}
    assert (state.step, state.pfc.count) == (6, 6)
    np.testing.assert_array_equal(state.pfc.weight.numpy(),
                                  np.asarray(jstate.pfc.weight))

    conf = _conf("AdamW")
    conf.update(n_classes=n_classes)
    step = make_train_step(conf, cfg, "cpu")
    rng = np.random.default_rng(1)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, n_classes, 4)
    m = step(state, images, labels, 1e-3)
    assert torch.isfinite(m["loss"]) and state.pfc.count == 7
    save_train_state(tmp_path, state, 7)
    fresh = init_train_state(conf, resnet.ResNet(layers, emd_size=EMB,
                                                 img_size=32), cfg, "cpu", 5)
    restore_train_state(tmp_path, fresh)
    _assert_states_equal(fresh, state)


def test_state_saved_before_its_first_step_restores(tmp_path):
    """Every state carries its three generators from the start, so a save
    made before any step restores, and the steps after it are the direct
    run's."""
    conf = _conf("SGD")
    cfg = _cfg(conf, 4)
    batches = _batches(2)
    state, step = _fresh(conf, cfg, seed=0)
    assert set(state.generators) == {"sample", "augment", "dropout"}
    save_train_state(tmp_path, state, 0)
    direct = [step(state, images, labels, 0.05)["loss"].item()
              for images, labels in batches]
    other, other_step = _fresh(conf, cfg, seed=7)
    restore_train_state(tmp_path, other)
    assert other.step == 0
    resumed = [other_step(other, images, labels, 0.05)["loss"].item()
               for images, labels in batches]
    assert resumed == direct
    _assert_states_equal(other, state)


@pytest.mark.parametrize("block", [1, 4], ids=["per-row", "block4"])
def test_step_marks_the_head_for_a_profile(block):
    """Each step runs the head's four parts inside ``pfc_head:*`` ranges,
    once each and in this order; a profile of the step reads the head's
    share of the device time from them."""
    from torch.profiler import ProfilerActivity, profile

    conf = _conf("SGD")
    state, step = _fresh(conf, _cfg(conf, block), seed=0)
    batches = _batches(2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for images, labels in batches:
            step(state, images, labels, 0.05)
    ranges = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.name.startswith("pfc_head:"))
    assert [name for _, name in ranges] == [
        "pfc_head:rows", "pfc_head:loss", "pfc_head:backward",
        "pfc_head:update"] * 2
