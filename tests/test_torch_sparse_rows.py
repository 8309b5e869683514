"""The grouped sparse-row functions and block-aligned sampling of the port
against fr_tpu (fr_tpu/ops/sparse_rows.py, fr_tpu/heads/partial_fc.py).

On the CPU the port's wrappers take their plain PyTorch versions; these are
held against fr_tpu's Pallas kernels run in interpret mode, on inputs from a
numpy seed. The gather is a copy and must be equal. The updates hold to
rtol 1e-5 / atol 1e-6, the tolerance of fr_tpu's own
tests/test_sparse_rows.py: the interpreter and torch contract mom·buf + g
into a fused multiply-add differently (~2e-7). Rows outside the sampled
groups must keep their bits. The Hopper kernels are held against the same
plain versions on the card (tests/test_torch_sparse_rows_cuda.py)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fr_tpu.configs.base import Config
from fr_tpu.heads import partial_fc as jax_pfc
from fr_tpu.ops import sparse_rows as jax_rows
from fr_tpu_torch.heads import partial_fc as pfc
from fr_tpu_torch.ops import sparse_rows as rows
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

D, C, NG = 128, 64, 5


def _conf(optimizer):
    return Config(optimizer_name=optimizer, wd=5e-4, mom=0.9,
                  betas=(0.9, 0.999), eps=1e-8)


def _problem(optimizer, block, seed=1):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    w = f32(C, D)
    if optimizer == "SGD":
        slots = {"momentum": f32(C, D)}
    else:
        slots = {"exp_avg": f32(C, D), "exp_avg_sq": np.abs(f32(C, D))}
    gidx = np.sort(rng.choice(C // block, NG, replace=False))
    return w, slots, gidx, f32(NG * block, D)


@pytest.mark.parametrize("block", [4, 8])
def test_expand_and_gather_equal_fr_tpu_interpret(block):
    w, _, gidx, _ = _problem("SGD", block, seed=0)
    ref = jax_rows.grouped_gather(jnp.asarray(w),
                                  jnp.asarray(gidx.astype(np.int32)), block,
                                  interpret=True)
    t_gidx = torch.from_numpy(gidx)
    np.testing.assert_array_equal(
        rows.expand_group_index(t_gidx, block).numpy(),
        np.asarray(jax_rows.expand_group_index(jnp.asarray(gidx), block)))
    before = rows.grouped_gather.launches
    got = rows.grouped_gather(torch.from_numpy(w), t_gidx, block)
    assert rows.grouped_gather.launches == before   # no kernel on the CPU
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("optimizer", ["SGD", "AdamW"])
@pytest.mark.parametrize("block", [4, 8])
def test_grouped_update_matches_fr_tpu_interpret(optimizer, block):
    conf = _conf(optimizer)
    w, slots, gidx, g = _problem(optimizer, block)
    lr, count = 0.05, 3
    w_ref, slots_ref = jax_rows.grouped_update(
        optimizer, conf, jnp.asarray(w),
        {k: jnp.asarray(v) for k, v in slots.items()},
        jnp.asarray(gidx.astype(np.int32)), jnp.asarray(g), jnp.float32(lr),
        jnp.asarray(count, jnp.int32), block, interpret=True)

    tw = torch.from_numpy(w.copy())
    tslots = {k: torch.from_numpy(v.copy()) for k, v in slots.items()}
    out = rows.grouped_update(optimizer, conf, tw, tslots,
                              torch.from_numpy(gidx), torch.from_numpy(g),
                              lr, count, block)
    assert out is None   # in place
    touched = np.zeros(C, bool)
    touched[rows.expand_group_index(torch.from_numpy(gidx), block)] = True
    for name, ours, ref, start in [("weight", tw, w_ref, w)] + [
            (k, tslots[k], slots_ref[k], slots[k]) for k in slots]:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(ours.numpy()[~touched],
                                      start[~touched], err_msg=name)
        assert (ours.numpy()[touched] != start[touched]).any(), name


def test_wrappers_reject_what_the_kernels_do_not_take():
    w, slots, gidx, g = _problem("SGD", 4)
    tw, tg = torch.from_numpy(w), torch.from_numpy(g)
    tslots = {"momentum": torch.from_numpy(slots["momentum"])}
    tgidx = torch.from_numpy(gidx)
    with pytest.raises(ValueError, match="int64"):
        rows.grouped_gather(tw, tgidx.int(), 4)
    with pytest.raises(ValueError, match="C % block"):
        rows.grouped_gather(tw[:62], tgidx, 4)
    with pytest.raises(ValueError, match="non-empty"):
        rows.grouped_gather(tw, tgidx[:0], 4)
    with pytest.raises(ValueError, match="grad_rows must be"):
        rows.grouped_update_sgd(tw, tslots, tgidx, tg[:-1], 0.1, 0.0, 0.9, 4)
    with pytest.raises(ValueError, match="grad_rows must be"):
        rows.grouped_update_sgd(tw, tslots, tgidx, tg.double(), 0.1, 0.0,
                                0.9, 4)
    with pytest.raises(ValueError, match="momentum must be"):
        rows.grouped_update_sgd(tw, {"momentum": tslots["momentum"][:60]},
                                tgidx, tg, 0.1, 0.0, 0.9, 4)
    with pytest.raises(ValueError, match="contiguous"):
        rows.grouped_gather(torch.from_numpy(np.tile(w, 2))[:, ::2], tgidx, 4)
    with pytest.raises(ValueError):
        rows.grouped_update("Lion", _conf("Lion"), tw, tslots, tgidx, tg,
                            0.1, 1, 4)


# ---------------------------------------------------------------------------
# Block-aligned sampling
# ---------------------------------------------------------------------------

GRID = list(itertools.product((100, 1000, 85742, 2059906), (1, 4, 8, 64),
                              (1.0, 0.5, 0.3, 0.1)))


@pytest.mark.parametrize("n_classes,block,rate", GRID)
def test_pfc_config_properties_equal_fr_tpu(n_classes, block, rate):
    ours = pfc.PFCConfig(n_classes, 512, sample_rate=rate,
                         sample_block=block)
    ref = jax_pfc.PFCConfig(n_classes, 512, 1, rate, "ArcFace", 64.0, 0.5,
                            True, "SGD", sample_block=block)
    for prop in ("num_classes_padded", "num_local", "num_sample",
                 "num_sample_groups", "sampling"):
        assert getattr(ours, prop) == getattr(ref, prop), prop


def test_pfc_config_at_webface42m():
    cfg = pfc.PFCConfig(2059906, 512, sample_rate=0.1, sample_block=64)
    assert (cfg.num_classes_padded, cfg.num_sample, cfg.num_sample_groups) \
        == (2059968, 205952, 3218)


def _masks(cfg, labels):
    t = torch.from_numpy(labels).long()
    return pfc.shard_group_masks(cfg, 0, t, (t >= 0) & (t < cfg.num_local))


@pytest.mark.parametrize("n_classes,block", [(100, 8), (97, 4), (1000, 64)])
def test_group_masks_equal_fr_tpu(n_classes, block):
    cfg = pfc.PFCConfig(n_classes, D, sample_rate=0.5, sample_block=block)
    jcfg = jax_pfc.PFCConfig(n_classes, D, 1, 0.5, "ArcFace", 30.0, 0.35,
                             False, "SGD", sample_block=block)
    rng = np.random.default_rng(2)
    # some labels outside the shard: not owned, must set no group
    labels = np.concatenate([rng.integers(0, n_classes, 12),
                             [-1, n_classes - 1, cfg.num_local + 5]]
                            ).astype(np.int32)
    gpos, gvalid = _masks(cfg, labels)
    loc = jnp.asarray(labels)
    jpos, jvalid = jax_pfc.shard_group_masks(
        jcfg, jnp.int32(0), loc, (loc >= 0) & (loc < jcfg.num_local))
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(jvalid))
    # and their row-granular definitions
    valid_rows = np.arange(cfg.num_local) < n_classes
    np.testing.assert_array_equal(gvalid.numpy(),
                                  valid_rows.reshape(-1, block).any(1))


def test_sample_groups_properties():
    """Sorted unique ids, the positives' groups in, groups of padding only
    never drawn, a whole number of groups, and another draw on the next
    call of one generator."""
    cfg = pfc.PFCConfig(100, D, sample_rate=0.5, sample_block=8)
    assert cfg.num_classes_padded == 104 and cfg.num_sample == 48
    labels = np.array([0, 17, 55, 99], np.int32)
    gpos, gvalid = _masks(cfg, labels)
    gen = torch.Generator().manual_seed(0)
    draws = [pfc.sample_groups(cfg, gen, gpos, gvalid) for _ in range(5)]
    for gidx in draws:
        assert gidx.dtype == torch.int64
        g = gidx.numpy()
        assert g.shape == (cfg.num_sample_groups,) == (6,)
        assert (np.diff(g) > 0).all()
        assert all(lab // 8 in g for lab in labels)
        assert gvalid.numpy()[g].all()
    assert len({tuple(d.tolist()) for d in draws}) > 1
    # a head whose last groups are padding only: 33 classes, block 8, padded
    # to 40; group 4 holds one real class and stays drawable
    tail = pfc.PFCConfig(33, D, sample_rate=0.99, sample_block=8)
    assert tail.num_classes_padded == 40 and tail.num_sample_groups == 4
    gpos, gvalid = _masks(tail, np.array([32], np.int32))
    assert gvalid.tolist() == [True] * 5
    assert 4 in pfc.sample_groups(tail, gen, gpos, gvalid).tolist()


def test_sample_columns_serves_the_per_row_path_only():
    """The step never calls sample_columns under sample_block > 1; at block 1
    it draws as before."""
    cfg = pfc.PFCConfig(40, D, sample_rate=0.5)
    pos = torch.zeros(40, dtype=torch.bool)
    pos[[3, 9]] = True
    idx = pfc.sample_columns(cfg, torch.Generator().manual_seed(0), pos,
                             pfc.shard_valid_mask(cfg, 0))
    assert idx.shape == (20,) and {3, 9} <= set(idx.tolist())
