"""Swin in the PyTorch port against fr_tpu: the architecture of every named
plan, a small plan on carried weights in f32 and bf16, the weight import
both ways and the .npz round trip, and the full-width Swin50 golden.

The helpers below the constants (fr_tpu flax init with perturbed
statistics, embeddings through both frameworks, the architecture check
against fr_tpu's parameter shapes, the weight and .npz round trips, the
golden checks) serve test_torch_effialternet.py too.

Inputs come from numpy seeds. Tolerances: f32 embeddings max-abs 1e-4;
bf16 per-row cosine 0.999 (both sides round to bf16 at their own places);
the golden f32 1e-3 (full depth)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fr_tpu.ckpt.checkpoint import export_encoder, load_encoder
from fr_tpu.configs.base import Config
from fr_tpu.models import swinv2 as jax_swinv2
from fr_tpu.parallel import make_mesh
from fr_tpu.train.step import make_embed_step as jax_make_embed_step
from fr_tpu_torch.models import swinv2
from fr_tpu_torch.train.step import make_embed_step
from fr_tpu_torch.utils import jax_import
from fr_tpu_torch.utils.golden import (golden_encoder, golden_images,
                                       seeded_state_dict)
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

# tests/test_backbones.py's small plan: stage 3 at 14 px (8 heads, 4
# windows per image), stage 4 at 7 px (16 heads of 4 channels), both on the
# per-head attention entry
SMALL = ((0, 0, 1, 1), (2, 4, 8, 16))
DTYPES = {"f32": (np.float32, torch.float32), "bf16": ("bfloat16",
                                                      torch.bfloat16)}
DATA = Path(__file__).parent / "data"


def perturbed_init(enc, x, seed):
    """Flax init, with BN statistics, every bias, BN scale, logit scale and
    CP temperature moved off their init values so that each mapping is
    exercised."""
    variables = jax.jit(lambda k, v: enc.init(k, v, train=False))(
        jax.random.key(seed), jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def jitter(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("mean", "bias", "q_bias", "v_bias"):
            return rng.uniform(-0.1, 0.1, leaf.shape).astype(np.float32)
        if name in ("scale", "temperature"):
            return rng.uniform(0.8, 1.2, leaf.shape).astype(np.float32)
        if name == "logit_scale":
            return np.log(rng.uniform(5.0, 20.0, leaf.shape)).astype(
                np.float32)
        return leaf

    params = jax.tree_util.tree_map_with_path(jitter, variables["params"])
    stats = jax.tree_util.tree_map_with_path(jitter,
                                             variables["batch_stats"])
    return params, stats


def jax_embed(enc, img_size, params, stats, images):
    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    return np.asarray(jax_make_embed_step(Config(img_size=img_size), mesh,
                                          enc)(params, stats,
                                               jnp.asarray(images)))


def port_embed(model, img_size, images):
    return make_embed_step(Config(img_size=img_size), model, "cpu")(
        images).numpy()


def row_cosine(a, b):
    return np.sum(a * b, axis=-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))


def assert_encoder_matches(enc, model, network, img_size, plan, dtype,
                           seed):
    """Carried weights, 2 images: f32 max-abs ≤ 1e-4; bf16 per-row cosine
    ≥ 0.999."""
    x = np.random.default_rng(seed).standard_normal(
        (2, img_size, img_size, 3)).astype(np.float32)
    params, stats = perturbed_init(enc, x, seed)
    model.load_state_dict(jax_import.encoder_state_dict_from_jax(
        params, stats, network, img_size, plan), strict=True)
    ref = jax_embed(enc, img_size, params, stats, x)
    out = port_embed(model, img_size, x)
    if dtype == "f32":
        assert np.abs(out - ref).max() <= 1e-4, np.abs(out - ref).max()
    else:
        assert row_cosine(out, ref).min() >= 0.999, row_cosine(out, ref)


def assert_architecture_matches(enc, model, network, img_size, plan=None):
    """fr_tpu's parameter and statistics shapes (jax.eval_shape, nothing
    computed) map one to one onto the port's state dict through the weight
    table, with the layout change of each entry."""
    shapes = jax.eval_shape(lambda v: enc.init(jax.random.key(0), v,
                                               train=False),
                            jax.ShapeDtypeStruct((1, img_size, img_size, 3),
                                                 jnp.float32))
    table = jax_import._table(network, img_size, plan)
    sd = model.state_dict()
    assert set(sd) == {e.key for e in table.entries} | set(table.fixed)
    n_flax = 0
    for e in table.entries:
        shape = jax_import._get(shapes[e.tree], e.path).shape
        perm = jax_import._TO_TORCH.get(e.kind)
        want = tuple(shape[i] for i in perm) if perm else tuple(shape)
        assert tuple(sd[e.key].shape) == want, (e.key, want)
        n_flax += 1
    leaves = jax.tree.leaves({k: shapes[k] for k in ("params",
                                                     "batch_stats")})
    assert n_flax == len(leaves)
    for key, value in table.fixed.items():
        assert tuple(sd[key].shape) == tuple(value.shape), key


def assert_weight_round_trips(model, network, img_size, plan, tmp_path,
                              seed):
    """The port's state dict → fr_tpu's trees → back is the identity; the
    .npz the port writes is read by fr_tpu's own load_encoder, and an
    fr_tpu-written .npz by the port's load_encoder_npz."""
    sd = seeded_state_dict(model, seed)
    model.load_state_dict(sd, strict=True)
    params, stats = jax_import.encoder_trees_from_state_dict(
        sd, network, img_size, plan)
    back = jax_import.encoder_state_dict_from_jax(params, stats, network,
                                                  img_size, plan)
    assert set(back) == set(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)

    ours = tmp_path / "port.npz"
    jax_import.export_encoder_npz(str(ours), model, 3, network, img_size,
                                  plan)
    p2, s2, meta = load_encoder(str(ours), network)
    assert meta == {"epoch": 3, "name": network}
    for t1, t2 in ((params, p2), (stats, s2)):
        assert jax.tree.structure(t1) == jax.tree.structure(t2)
        for a, b in zip(jax.tree.leaves(t1), jax.tree.leaves(t2)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    theirs = tmp_path / "fr_tpu.npz"
    export_encoder(str(theirs), params, stats, 3, network)
    loaded = jax_import.load_encoder_npz(str(theirs), network, img_size,
                                         plan)
    for k in sd:
        torch.testing.assert_close(loaded[k], sd[k], rtol=0, atol=0)


def golden_check(network):
    """Full width on the CPU, 4 images: f32 within 1e-3 of the committed
    fr_tpu embeddings (tests/data/<network>_golden.npz)."""
    path = DATA / f"{network.lower()}_golden.npz"
    golden = np.load(path)
    seed = int(golden["seed"])
    model = golden_encoder(network)
    model.load_state_dict(seeded_state_dict(model, seed), strict=True)
    out = port_embed(model, 112, golden_images(seed, img_size=112))
    assert out.shape == golden["embeddings"].shape == (4, 512)
    assert np.abs(out - golden["embeddings"]).max() <= 1e-3


def golden_regenerates(network, from_fr_tpu):
    """Recomputes a golden with jax: writes tests/data/<network>_golden.npz
    when it is missing (delete it to regenerate), otherwise checks that the
    committed file is what fr_tpu computes. ``from_fr_tpu(state_dict)``
    returns fr_tpu's (encoder, params, stats) through its own importer."""
    seed = 0
    path = DATA / f"{network.lower()}_golden.npz"
    sd = seeded_state_dict(golden_encoder(network), seed)
    enc, params, stats = from_fr_tpu(sd)
    emb = jax_embed(enc, 112, params, stats,
                    golden_images(seed, img_size=112))
    if not path.exists():
        np.savez(path, seed=np.int64(seed), embeddings=emb)
    golden = np.load(path)
    assert int(golden["seed"]) == seed
    np.testing.assert_allclose(golden["embeddings"], emb, atol=1e-6)


def _pair(dtype, emd=64):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    enc = jax_swinv2.Swin(num_blocks=SMALL[0], heads=SMALL[1], emd_size=emd,
                          dtype=jdt)
    model = swinv2.Swin(*SMALL, emd_size=emd, compute_dtype=DTYPES[dtype][1])
    return enc, model


@pytest.mark.parametrize("network", sorted(swinv2.SWIN_PLANS))
def test_named_plans_match_fr_tpu_architecture(network):
    """build_encoder's Swin18–200 against fr_tpu's parameter shapes (on the
    meta device: nothing allocated)."""
    from fr_tpu_torch.models import build_encoder
    from fr_tpu.models import build_encoder as jax_build_encoder

    conf = Config(network=network, img_size=112, emd_size=512,
                  mixed_precision=True)
    with torch.device("meta"):
        model = build_encoder(conf)
    assert isinstance(model, swinv2.Swin)
    assert_architecture_matches(jax_build_encoder(conf), model, network, 112)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_small_swin_matches_fr_tpu(dtype):
    enc, model = _pair(dtype)
    assert_encoder_matches(enc, model, "Swin", 112, SMALL[0], dtype,
                           seed=11 if dtype == "f32" else 12)


def test_weights_and_npz_round_trip(tmp_path):
    _, model = _pair("f32")
    assert_weight_round_trips(model, "Swin", 112, SMALL[0], tmp_path, seed=5)


def test_swin50_port_matches_golden_f32():
    golden_check("Swin50")


def _fr_tpu_swin50(sd):
    from fr_tpu.utils.torch_import import swin_from_torch

    params, stats = swin_from_torch(sd, "Swin50")
    enc = jax_swinv2.build_swin(Config(network="Swin50", emd_size=512,
                                       mixed_precision=False))
    return enc, params, stats


@pytest.mark.slow
def test_swin50_golden_regenerates_with_jax():
    golden_regenerates("Swin50", _fr_tpu_swin50)
