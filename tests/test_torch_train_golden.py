"""The full-width AlterNet50 training golden: two SGD steps of fr_tpu on the
seeded AlterNet50 (192 px, emd 512, f32, drop rates 0, 1,000 classes, every
class active, 4 images per step), stored in
tests/data/alternet50_train_golden.npz as losses, gradient norms and the
norm of every tensor's update. The port's CPU run is held against it here;
chip_smoke.py holds the card's run against it.

Tolerances: losses and gradient norms rel 1e-3; update norms rel 5e-2.
Measured on the CPU: losses within 3e-6, gradient norms within 1.2e-4,
update norms within 1.1e-2 except the 4-element logit_scale of layer2.2
(4.0e-2), whose two steps' gradients largely cancel; fr_tpu's own update
norms move by up to 3e-3 when the images move by 1e-7 relative.
tests/test_torch_train_step.py states why deep gradients spread so."""

from pathlib import Path

import numpy as np
import pytest

from fr_tpu_torch.utils.golden import run_train_golden
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "data" / "alternet50_train_golden.npz"


def _compare(ours, golden):
    assert list(ours["update_names"]) == list(golden["update_names"])
    np.testing.assert_allclose(ours["losses"], golden["losses"], rtol=1e-3)
    np.testing.assert_allclose(ours["grad_norms"], golden["grad_norms"],
                               rtol=1e-3)
    np.testing.assert_allclose(ours["update_norms"], golden["update_norms"],
                               rtol=5e-2)


def test_port_cpu_training_matches_golden():
    golden = np.load(GOLDEN)
    ours = run_train_golden(int(golden["seed"]), "cpu")
    assert np.isfinite(ours["losses"]).all()
    _compare(ours, golden)


def train_golden_from_fr_tpu(seed: int):
    """fr_tpu's two steps on the same seeded weights, head and batches."""
    import jax
    import jax.numpy as jnp

    from fr_tpu.heads.partial_fc import PFCConfig, PFCState
    from fr_tpu.models import alternet as jax_alternet
    from fr_tpu.parallel import make_mesh
    from fr_tpu.train.optim import init_slots
    from fr_tpu.train.state import TrainState
    from fr_tpu.train.step import make_train_step
    from fr_tpu.utils.torch_import import alternet_from_torch
    from fr_tpu_torch.models.alternet import ALTERNET_PLANS, AlterNet
    from fr_tpu_torch.utils.golden import (TRAIN_GOLDEN, seeded_state_dict,
                                           train_golden_batches,
                                           train_golden_conf,
                                           train_golden_head)
    from fr_tpu_torch.utils.jax_import import encoder_state_dict_from_jax

    conf = train_golden_conf()
    port = AlterNet(*ALTERNET_PLANS["AlterNet50"], img_size=conf.img_size,
                    emd_size=conf.emd_size)
    params, stats = alternet_from_torch(seeded_state_dict(port, seed),
                                        "AlterNet50")
    enc = jax_alternet.AlterNet(*ALTERNET_PLANS["AlterNet50"],
                                img_size=conf.img_size,
                                emd_size=conf.emd_size, drop_path_rate=0.0,
                                head_drop=0.0)
    params = jax.tree.map(jnp.asarray, params)
    head = jnp.asarray(train_golden_head(seed))
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, stats),
        opt_slots=init_slots("SGD", params),
        pfc=PFCState(weight=head, slots={"momentum": jnp.zeros_like(head)},
                     count=jnp.zeros((), jnp.int32)))
    cfg = PFCConfig(conf.n_classes, conf.emd_size, 1, 1.0, "ArcFace", 30.0,
                    0.35, False, "SGD")
    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    step = make_train_step(conf, mesh, enc, cfg, donate=False)
    losses, norms = [], []
    for images, labels in train_golden_batches(seed):
        state, m = step(state, jnp.asarray(images), jnp.asarray(labels),
                        TRAIN_GOLDEN["lr"], jax.random.key(0))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    before = encoder_state_dict_from_jax(host(params), host(stats),
                                         "AlterNet50", conf.img_size)
    after = encoder_state_dict_from_jax(host(state.params),
                                        host(state.batch_stats),
                                        "AlterNet50", conf.img_size)
    names = [n for n, _ in port.named_parameters()] + ["head"]
    updates = [float(np.linalg.norm((after[n] - before[n]).numpy()))
               for n in names[:-1]]
    updates.append(float(np.linalg.norm(np.asarray(state.pfc.weight - head))))
    return {"losses": np.array(losses), "grad_norms": np.array(norms),
            "update_names": np.array(names), "update_norms":
            np.array(updates)}


@pytest.mark.slow
def test_train_golden_regenerates_with_jax():
    """Recomputes the golden with jax. Writes the file when it is missing
    (delete it to regenerate); otherwise checks that the committed file is
    what fr_tpu computes."""
    seed = 0
    ref = train_golden_from_fr_tpu(seed)
    if not GOLDEN.exists():
        GOLDEN.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(GOLDEN, seed=np.int64(seed), **ref)
    golden = np.load(GOLDEN)
    assert int(golden["seed"]) == seed
    assert list(golden["update_names"]) == list(ref["update_names"])
    for key in ("losses", "grad_norms", "update_norms"):
        np.testing.assert_allclose(golden[key], ref[key], rtol=1e-6)
