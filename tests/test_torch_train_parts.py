"""The training slice's parts in the port against fr_tpu's: BatchNorm's
training update, the optimizers and the clip, the schedules, the
augmentation (apply under fr_tpu's own draws, and the draw's
distribution), the in-memory loader, dropout and DropPath under explicit
generators.

Inputs come from numpy seeds; tolerances are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fr_tpu.configs import load_config
from fr_tpu.configs.base import Config
from fr_tpu.data import augment as jax_augment
from fr_tpu.data.folder import ArrayTrainLoader as JaxArrayTrainLoader
from fr_tpu.models.common import BatchNorm as JaxBatchNorm
from fr_tpu.train import optim as jax_optim
from fr_tpu.train import schedule as jax_schedule
from fr_tpu_torch.data import augment
from fr_tpu_torch.data.synthetic import ArrayTrainLoader, synthetic_corpus
from fr_tpu_torch.models.common import BatchNorm1d, BatchNorm2d, dropout
from fr_tpu_torch.models.swin_common import DropPath
from fr_tpu_torch.ops import sparse_rows
from fr_tpu_torch.train import optim, schedule
from test_torch_cpu_threads import one_torch_thread  # noqa: F401


def _flax_bn_step(x_nhwc, mean0, var0):
    """One training-mode call of fr_tpu's BatchNorm → (y, mean, var)."""
    bn = JaxBatchNorm()
    c = x_nhwc.shape[-1]
    variables = {"params": {"BatchNorm_0": {"scale": jnp.ones(c),
                                            "bias": jnp.zeros(c)}},
                 "batch_stats": {"BatchNorm_0": {"mean": jnp.asarray(mean0),
                                                 "var": jnp.asarray(var0)}}}
    y, upd = bn.apply(variables, jnp.asarray(x_nhwc),
                      use_running_average=False, mutable=["batch_stats"])
    s = upd["batch_stats"]["BatchNorm_0"]
    return np.asarray(y), np.asarray(s["mean"]), np.asarray(s["var"])


@pytest.mark.parametrize("shape", [(4, 64), (4, 3, 3, 16)],
                         ids=["bn1d-batch4", "bn2d-3x3"])
def test_batchnorm_training_update_matches_flax(shape):
    """running_mean and running_var after one training step equal flax's to
    1e-6: flax updates with the biased batch variance, torch's own
    BatchNorm with the unbiased one (a third larger over 4 samples)."""
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    c = shape[-1]
    mean0 = rng.uniform(-0.1, 0.1, c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    y_ref, mean_ref, var_ref = _flax_bn_step(x, mean0, var0)

    bn = BatchNorm1d(c) if len(shape) == 2 else BatchNorm2d(c)
    bn.running_mean.copy_(torch.from_numpy(mean0))
    bn.running_var.copy_(torch.from_numpy(var0))
    bn.train()
    xt = torch.from_numpy(x if len(shape) == 2 else
                          np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    y = bn(xt).detach().numpy()
    if len(shape) == 4:
        y = y.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(bn.running_mean.numpy(), mean_ref, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), var_ref, atol=1e-6)
    np.testing.assert_allclose(y, y_ref, atol=1e-5)

    # the fault the port repairs: torch's stock update is far off
    stock = (torch.nn.BatchNorm1d(c) if len(shape) == 2
             else torch.nn.BatchNorm2d(c))
    stock.running_var.copy_(torch.from_numpy(var0))
    stock.train()(xt)
    assert np.abs(stock.running_var.detach().numpy() - var_ref).max() > 1e-2


def _tree(rng, shapes):
    return {f"p{i}": rng.standard_normal(s).astype(np.float32)
            for i, s in enumerate(shapes)}


@pytest.mark.parametrize("opt", ["SGD", "AdamW"])
def test_encoder_updates_and_clip_match_fr_tpu(opt):
    """Two clipped updates of three tensors: f32 rtol 1e-6."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = _tree(rng, shapes)
    conf = Config(wd=5e-4, mom=0.9, betas=(0.9, 0.999), eps=1e-8)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jslots = jax_optim.init_slots(opt, jp)
    tp = [torch.from_numpy(v.copy()) for v in params.values()]
    tslots = optim.init_slots(opt, tp)
    for count in (1, 2):
        grads = _tree(rng, shapes)
        grads["p0"] *= 10.0   # a global norm above 5: the clip acts
        jg, jnorm = jax_optim.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in grads.items()}, 5.0)
        jp, jslots = jax_optim.encoder_update(opt, conf, jp, jg, jslots,
                                              jnp.float32(0.05),
                                              jnp.int32(count))
        tg, tnorm = optim.clip_by_global_norm(
            [torch.from_numpy(v) for v in grads.values()], 5.0)
        optim.encoder_update(opt, conf, tp, tg, tslots, 0.05, count)
        np.testing.assert_allclose(tnorm.item(), float(jnorm), rtol=1e-6)
    for (k, ref), ours in zip(jp.items(), tp):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    for name, ref in jslots.items():
        for (k, r), ours in zip(ref.items(), tslots[name]):
            np.testing.assert_allclose(ours.numpy(), np.asarray(r),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("opt", ["SGD", "AdamW"])
def test_head_row_updates_match_fr_tpu(opt, sampled):
    """The sampled-row update touches the sampled rows only: rtol 1e-6."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((20, 8)).astype(np.float32)
    idx = np.array([1, 4, 5, 11, 19]) if sampled else None
    conf = Config(wd=5e-4, mom=0.9, betas=(0.9, 0.999), eps=1e-8)
    names = (("momentum",) if opt == "SGD" else ("exp_avg", "exp_avg_sq"))
    slots = {n: np.abs(rng.standard_normal(w.shape)).astype(np.float32) * 0.1
             for n in names}
    jw, js = jnp.asarray(w), {k: jnp.asarray(v) for k, v in slots.items()}
    tw = torch.from_numpy(w.copy())
    ts = {k: torch.from_numpy(v.copy()) for k, v in slots.items()}
    for count in (1, 2):
        g = rng.standard_normal((len(idx) if sampled else 20, 8)).astype(
            np.float32)
        jw, js = jax_optim.pfc_row_update(
            opt, conf, jw, js, None if idx is None else jnp.asarray(idx),
            jnp.asarray(g), jnp.float32(0.1), jnp.int32(count))
        optim.pfc_row_update(opt, conf, tw, ts,
                             None if idx is None else torch.from_numpy(idx),
                             torch.from_numpy(g), 0.1, count)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    for k in names:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-6, atol=1e-7)
    if sampled:
        untouched = np.setdiff1d(np.arange(20), idx)
        np.testing.assert_array_equal(tw.numpy()[untouched], w[untouched])


def test_block_sampled_head_update_raises():
    """With the drawn groups (gidx, block > 1) pfc_row_update takes the
    grouped update, which equals the per-row one on the expanded index and
    raises on rows that do not match the groups; without gidx it is the
    per-row path, as in fr_tpu."""
    conf = Config(wd=5e-4, mom=0.9)
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((8, 2)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32))
    gidx = torch.tensor([1, 3])
    idx = torch.tensor([2, 3, 6, 7])
    grouped, per_row = w.clone(), w.clone()
    gs, ps = ({"momentum": torch.zeros(8, 2)} for _ in range(2))
    optim.pfc_row_update("SGD", conf, grouped, gs, idx, g, 0.1, 1,
                         gidx=gidx, block=2)
    optim.pfc_row_update("SGD", conf, per_row, ps, idx, g, 0.1, 1, block=2)
    assert torch.equal(grouped, per_row)
    assert torch.equal(gs["momentum"], ps["momentum"])
    assert not torch.equal(grouped, w)
    with pytest.raises(ValueError, match="grad_rows must be"):
        optim.pfc_row_update("SGD", conf, grouped, gs, idx, g[:3], 0.1, 1,
                             gidx=gidx, block=2)


@pytest.mark.parametrize("name", ["CosineAnnealingWarmupRestarts",
                                  "CosineAnnealingLR", "MultiStep", "StepLR"])
def test_schedules_equal_fr_tpu(name):
    conf = load_config("ms1m_arcface_122")
    conf.lr_scheduler = name
    conf.update({"warmup_steps": 5, "min_lr": conf.lr / 1000,
                 "lr_decay_epoch": [8, 12], "lr_decay_ratio": 0.5,
                 "lr_decay_epoch_size": 3})
    ours, ref = schedule.get_schedule(conf), jax_schedule.get_schedule(conf)
    assert [ours(e) for e in range(40)] == [ref(e) for e in range(40)]


def _jax_draws(key, B, H, W, cfg):
    """fr_tpu's augment_impl draws, recomputed from its key splits
    (fr_tpu/data/augment.py:137-176), in the port's draw layout."""
    (g_lo, g_hi, _, _, cs_lo, cs_hi, in_lo, in_hi, _, _, _, emax_h,
     emax_w) = cfg
    keys = jax.random.split(key, 12)
    k_angle, k_size = jax.random.split(keys[3])
    k_pois, k_col = jax.random.split(keys[8])
    ke = jax.random.split(keys[7], 5)
    u = lambda k, shape, lo=0.0, hi=1.0: np.asarray(  # noqa: E731
        jax.random.uniform(k, shape, minval=lo, maxval=hi)).reshape(B)
    d = {"gamma": u(keys[0], (B, 1, 1, 1), g_lo, g_hi) / 100.0,
         "gamma_u": u(keys[1], (B, 1, 1, 1)),
         "blur_u": u(keys[2], (B, 1, 1, 1)),
         "blur_angle": u(k_angle, (B, 1, 1), 0.0, np.pi),
         "blur_size": np.asarray(jax.random.randint(k_size, (B,), 0, 3)),
         "color_shift": u(keys[4], (B,), cs_lo, cs_hi),
         "intensity": u(keys[5], (B,), in_lo, in_hi),
         "lum_noise": np.asarray(jax.random.normal(k_pois, (B, H, W))),
         "hue_noise": np.asarray(jax.random.normal(k_col, (B, H, W))),
         "iso_u": u(keys[9], (B, 1, 1, 1)),
         "flip_u": u(keys[6], (B, 1, 1, 1)),
         "erase_y0": np.asarray(jax.random.randint(
             ke[2], (B, 1, 1), 0, max(H - emax_h, 1))).reshape(B),
         "erase_x0": np.asarray(jax.random.randint(
             ke[3], (B, 1, 1), 0, max(W - emax_w, 1))).reshape(B),
         "erase_u": u(ke[4], (B, 1, 1))}
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("probs", ["config", "all-on"])
def test_augment_apply_matches_augment_impl(probs):
    """Under fr_tpu's own draws the port's apply equals augment_impl: 2e-5
    (f32 HLS round trips and a 7×7 blur). "all-on" forces every branch."""
    conf = load_config("ms1m_arcface_122")
    cfg = augment.augment_cfg_from_conf(conf)
    assert cfg == jax_augment.augment_cfg_from_conf(conf)
    if probs == "all-on":
        cfg = cfg[:2] + (1.0, 1.0) + cfg[4:8] + (1.0, 1.0, 1.0) + cfg[11:]
    B, H, W = 8, 40, 40
    images = np.random.default_rng(7).integers(0, 256, (B, H, W, 3)).astype(
        np.uint8)
    key = jax.random.key(11)
    ref = np.asarray(jax_augment.augment_impl(key, jnp.asarray(images), cfg))
    draws = _jax_draws(key, B, H, W, cfg)
    ours = augment.apply_augment(torch.from_numpy(images), draws, cfg)
    assert ours.dtype == torch.float32 and ours.shape == (B, H, W, 3)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5)


def test_augment_draw_gates_follow_their_probabilities():
    """4096 samples: every gate's share lies within 3σ of its p; draws come
    from the generator alone (same seed, same draws)."""
    conf = load_config("ms1m_arcface_122")
    cfg = augment.augment_cfg_from_conf(conf)
    n = 4096
    d = augment.draw_augment(cfg, (n, 24, 24, 3),
                             torch.Generator().manual_seed(0), "cpu")
    gates = {"gamma_u": cfg[2], "blur_u": cfg[3], "iso_u": cfg[8],
             "flip_u": cfg[9], "erase_u": cfg[10]}
    for name, p in gates.items():
        share = float((d[name] < p).float().mean())
        assert abs(share - p) <= 3 * np.sqrt(p * (1 - p) / n), (name, share)
    assert float(d["gamma"].min()) >= 0.8 and float(d["gamma"].max()) < 1.2
    assert set(d["blur_size"].tolist()) == {0, 1, 2}
    again = augment.draw_augment(cfg, (n, 24, 24, 3),
                                 torch.Generator().manual_seed(0), "cpu")
    for k in d:
        assert torch.equal(d[k], again[k]), k
    out = augment.augment(torch.zeros((4, 24, 24, 3), dtype=torch.uint8),
                          cfg, torch.Generator().manual_seed(1))
    assert out.shape == (4, 24, 24, 3) and torch.isfinite(out).all()


def test_array_train_loader_equals_fr_tpu():
    imgs, labels = synthetic_corpus(5, 3, 8)
    ours = ArrayTrainLoader(imgs, labels, 4, seed=2)
    ref = JaxArrayTrainLoader(imgs, labels, 4, seed=2)
    assert ours.steps_per_epoch() == ref.steps_per_epoch() == 3
    for epoch in (0, 1):
        for (a, la), (b, lb) in zip(ours.epoch(epoch), ref.epoch(epoch)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(la, lb)


def test_dropout_and_drop_path_use_only_their_generator():
    x = torch.ones((64, 4, 3, 3))
    dp = DropPath(0.25).train()
    a = dp(x, torch.Generator().manual_seed(3))
    b = dp(x, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    per_sample = a.flatten(1)
    assert set(torch.unique(per_sample).tolist()) <= {0.0,
                                                      float(np.float32(1 / 0.75))}
    assert torch.all(per_sample.min(1).values == per_sample.max(1).values)
    with pytest.raises(ValueError, match="Generator"):
        dp(x)
    assert torch.equal(dp.eval()(x), x)
    y = dropout(torch.ones(10000), 0.5, torch.Generator().manual_seed(0))
    assert abs(float((y == 0).float().mean()) - 0.5) < 0.03
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    with pytest.raises(ValueError, match="Generator"):
        dropout(torch.ones(3), 0.5, None)


def test_ops_import_nothing_of_the_training_layer():
    """fr_tpu_torch/ops lies below fr_tpu_torch/train: the per-row update
    rules live in ops/sparse_rows.py and train/optim.py takes them from
    there, never the other way round."""
    import ast
    from pathlib import Path

    import fr_tpu_torch.ops as ops_pkg

    files = sorted(Path(ops_pkg.__file__).parent.glob("*.py"))
    assert files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            assert not any(n.startswith("fr_tpu_torch.train") for n in names), \
                f"{path.name} imports {names}"
    assert optim.row_sgd_update is sparse_rows.row_sgd_update
    assert optim.bias_corrections is sparse_rows.bias_corrections
