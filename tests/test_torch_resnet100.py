"""Full-width IR-ResNet100 (112 px, emd 512) in the port against fr_tpu's
goldens: the f32 embeddings of the seeded weights
(tests/data/resnet100_golden.npz) and two SGD steps under a block-sampled
head (tests/data/resnet100_train_golden.npz: 1,000 classes in groups of 4,
125 groups per step, the groups fr_tpu drew stored in the file). The port's
CPU runs are held against them here; chip_smoke.py holds the card's.

Tolerances, those of the other families' goldens: embeddings max-abs 1e-3
(measured 9.8e-7 on the CPU, at a largest element of 0.15); losses and
gradient norms rel 1e-3 (measured 2.5e-6 and 2.4e-5); update norms rel 5e-2
(measured 8.2e-3; tests/test_torch_train_step.py states why deep gradients
spread at f32 resolution)."""

from pathlib import Path

import numpy as np
import pytest

from fr_tpu_torch.configs.base import Config
from fr_tpu_torch.train.step import make_embed_step
from fr_tpu_torch.utils.golden import (golden_encoder, golden_images,
                                       run_train_golden, seeded_state_dict)
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

DATA = Path(__file__).parent / "data"
GOLDEN = DATA / "resnet100_golden.npz"
TRAIN_GOLDEN = DATA / "resnet100_train_golden.npz"


def test_resnet100_port_matches_golden_f32():
    golden = np.load(GOLDEN)
    seed = int(golden["seed"])
    model = golden_encoder("ResNet100")
    model.load_state_dict(seeded_state_dict(model, seed), strict=True)
    out = make_embed_step(Config(img_size=112), model, "cpu")(
        golden_images(seed, img_size=112)).numpy()
    assert out.shape == golden["embeddings"].shape == (4, 512)
    assert np.abs(out - golden["embeddings"]).max() <= 1e-3


def test_port_cpu_training_matches_resnet100_golden():
    golden = np.load(TRAIN_GOLDEN)
    gidx = golden["gidx"]
    assert gidx.shape == (2, 125) and (np.diff(gidx, axis=1) > 0).all()
    ours = run_train_golden(int(golden["seed"]), "cpu", "ResNet100", gidx)
    assert np.isfinite(ours["losses"]).all()
    assert list(ours["update_names"]) == list(golden["update_names"])
    np.testing.assert_allclose(ours["losses"], golden["losses"], rtol=1e-3)
    np.testing.assert_allclose(ours["grad_norms"], golden["grad_norms"],
                               rtol=1e-3)
    np.testing.assert_allclose(ours["update_norms"], golden["update_norms"],
                               rtol=5e-2)


def test_the_sampled_golden_needs_its_groups():
    with pytest.raises(ValueError, match="groups stored in the golden"):
        run_train_golden(0, "cpu", "ResNet100")


def _fr_tpu_resnet100(seed):
    """fr_tpu's ResNet100 and the seeded weights through its own import."""
    import jax
    import jax.numpy as jnp

    from fr_tpu.models import resnet as jax_resnet
    from fr_tpu.utils.torch_import import resnet_from_torch

    port = golden_encoder("ResNet100")
    params, stats = resnet_from_torch(seeded_state_dict(port, seed),
                                      "ResNet100")
    enc = jax_resnet.ResNet(layers=jax_resnet.RESNET_LAYERS["ResNet100"],
                            emd_size=512)
    return (port, enc, jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, stats))


def golden_from_fr_tpu(seed: int) -> np.ndarray:
    import jax
    import jax.numpy as jnp

    from fr_tpu.parallel import make_mesh
    from fr_tpu.train.step import make_embed_step as jax_make_embed_step

    _, enc, params, stats = _fr_tpu_resnet100(seed)
    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    return np.asarray(jax_make_embed_step(Config(img_size=112), mesh, enc)(
        params, stats, jnp.asarray(golden_images(seed, img_size=112))))


def train_golden_from_fr_tpu(seed: int):
    """fr_tpu's two steps (sample_block 4) on the same seeded weights, head
    and batches, and the groups each step drew."""
    import jax
    import jax.numpy as jnp

    from fr_tpu.heads.partial_fc import (PFCConfig, PFCState, sample_groups,
                                         shard_group_masks)
    from fr_tpu.parallel import make_mesh
    from fr_tpu.train.optim import init_slots
    from fr_tpu.train.state import TrainState
    from fr_tpu.train.step import (STREAM_SAMPLE, make_train_step,
                                   stream_key)
    from fr_tpu_torch.utils.golden import (TRAIN_GOLDEN as SPEC,
                                           train_golden_batches,
                                           train_golden_conf,
                                           train_golden_head)
    from fr_tpu_torch.utils.jax_import import encoder_state_dict_from_jax

    conf = train_golden_conf("ResNet100")
    port, enc, params, stats = _fr_tpu_resnet100(seed)
    head = jnp.asarray(train_golden_head(seed))
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_slots=init_slots("SGD", params),
        pfc=PFCState(weight=head, slots={"momentum": jnp.zeros_like(head)},
                     count=jnp.zeros((), jnp.int32)))
    cfg = PFCConfig(conf.n_classes, conf.emd_size, 1, conf.sample_rate,
                    "ArcFace", 30.0, 0.35, False, "SGD",
                    sample_block=conf.sample_block)
    assert cfg.num_classes_padded == conf.n_classes
    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    step = make_train_step(conf, mesh, enc, cfg, donate=False)
    key = jax.random.key(0)
    losses, norms, drawn = [], [], []
    for images, labels in train_golden_batches(seed, conf.img_size):
        loc = jnp.asarray(labels)
        gpos, gvalid = shard_group_masks(cfg, 0, loc,
                                         (loc >= 0) & (loc < cfg.num_local))
        drawn.append(np.asarray(sample_groups(
            cfg, stream_key(key, STREAM_SAMPLE, state.step, 0), gpos,
            gvalid)))
        state, m = step(state, jnp.asarray(images), loc, SPEC["lr"], key)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    before = encoder_state_dict_from_jax(host(params), host(stats),
                                         "ResNet100")
    after = encoder_state_dict_from_jax(host(state.params),
                                        host(state.batch_stats), "ResNet100")
    names = [n for n, _ in port.named_parameters()] + ["head"]
    updates = [float(np.linalg.norm((after[n] - before[n]).numpy()))
               for n in names[:-1]]
    updates.append(float(np.linalg.norm(np.asarray(state.pfc.weight - head))))
    return {"losses": np.array(losses), "grad_norms": np.array(norms),
            "update_names": np.array(names), "update_norms":
            np.array(updates), "gidx": np.stack(drawn).astype(np.int64)}


@pytest.mark.slow
def test_resnet100_golden_regenerates_with_jax():
    """Recomputes the embedding golden with jax. Writes the file when it is
    missing (delete it to regenerate); otherwise checks that the committed
    file is what fr_tpu computes."""
    seed = 0
    emb = golden_from_fr_tpu(seed)
    if not GOLDEN.exists():
        np.savez(GOLDEN, seed=np.int64(seed), embeddings=emb)
    golden = np.load(GOLDEN)
    assert int(golden["seed"]) == seed
    np.testing.assert_allclose(golden["embeddings"], emb, atol=1e-6)


@pytest.mark.slow
def test_resnet100_train_golden_regenerates_with_jax():
    """The same for the training golden, drawn groups included."""
    seed = 0
    ref = train_golden_from_fr_tpu(seed)
    if not TRAIN_GOLDEN.exists():
        np.savez_compressed(TRAIN_GOLDEN, seed=np.int64(seed), **ref)
    golden = np.load(TRAIN_GOLDEN)
    assert int(golden["seed"]) == seed
    assert list(golden["update_names"]) == list(ref["update_names"])
    np.testing.assert_array_equal(golden["gidx"], ref["gidx"])
    for key in ("losses", "grad_norms", "update_norms"):
        np.testing.assert_allclose(golden[key], ref[key], rtol=1e-6)
