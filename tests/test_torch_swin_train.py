"""The port's training step on Swin against fr_tpu's: two steps of fr_tpu's
make_train_step on a (1, 1) CPU mesh and two of the port's, from the same
weights (fr_tpu's flax init carried over by train_state_from_jax) on the
same images, with the port's attention on its recompute arm and on its
stored-stats arm (FR_ATTN_STORED_STATS=0 and 1). Swin's small plan
(0, 0, 1, 1) at 112 px, emd 64 (both attention stages on the per-head
entry), batch 4, 300 classes, f32, SGD at lr 1e-3, sample_rate 1.0, no
augmentation. fr_tpu's Swin hard-codes its head dropout at 0.5; its
module's ``nn`` is swapped here for one whose Dropout is the identity, and
the port's Swin is built with head_drop 0. Then the full-width Swin50
training golden (tests/data/swin50_train_golden.npz) on the CPU.

Tolerances as tests/test_torch_train_step.py states them (deep gradients
at init are chaotic at f32 resolution): grad_norm 1e-3 (measured 4.5e-4 at
step 1; fr_tpu's own moves by 7.5e-5 when the images move by 1e-7
relative); loss rtol 3e-5 at step 1 (measured 2.6e-6) and 1e-4 at step 2,
after updates that may differ by the 3e-2 below (measured 5.8e-5); each
state tensor norm-wise, parameters and head 2e-4, BN statistics 1e-3,
updates and momenta 3e-2 after step 1 and 1e-1 after step 2. The golden:
losses and gradient norms rel 1e-3, update norms rel 5e-2 plus 1e-3 of the
largest update: a tensor whose gradient the next BatchNorm cancels (the v
bias shifts every output of its head alike, and the batch mean removes a
shift) moves by rounding noise alone (measured: 1.5e-7 against a largest
update of 4e-4)."""

import types
from pathlib import Path

import flax.linen as linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fr_tpu.configs.base import Config
from fr_tpu.heads import partial_fc as jax_pfc
from fr_tpu.heads.partial_fc import init_pfc_state
from fr_tpu.models import swinv2 as jax_swinv2
from fr_tpu.parallel import make_mesh
from fr_tpu.train.optim import init_slots
from fr_tpu.train.state import TrainState as JaxTrainState
from fr_tpu.train.step import make_train_step as jax_make_train_step
from fr_tpu_torch.heads.partial_fc import PFCConfig
from fr_tpu_torch.models import swinv2
from fr_tpu_torch.ops import fused_window_attn as F
from fr_tpu_torch.train.step import make_train_step
from fr_tpu_torch.utils.jax_import import (train_state_from_jax,
                                           train_state_to_jax_layout)
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

SMALL = ((0, 0, 1, 1), (2, 4, 8, 16))
IMG, EMB, NCLS, BATCH, LR = 112, 64, 300, 4, 1e-3
GOLDEN = Path(__file__).parent / "data" / "swin50_train_golden.npz"


def _conf():
    return Config(network="Swin", emd_size=EMB, n_classes=NCLS,
                  metric="ArcFace", loss_s=30.0, loss_m=0.35,
                  optimizer_name="SGD", optimizer="SGD", wd=5e-4, mom=0.9,
                  eps=1e-8, betas=(0.9, 0.999), mixed_precision=False,
                  sample_rate=1.0, use_fused=False)


def without_head_dropout(monkeypatch):
    """fr_tpu's swinv2 module sees a linen whose Dropout is the identity."""
    shim = types.ModuleType("linen_without_dropout")
    shim.__dict__.update(vars(linen))
    shim.Dropout = lambda *a, **kw: (lambda x: x)
    monkeypatch.setattr(jax_swinv2, "nn", shim)


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    templates = rng.standard_normal((8, IMG, IMG, 3))
    out = []
    for _ in range(2):
        ident = rng.integers(0, 8, BATCH)
        images = templates[ident] + 0.3 * rng.standard_normal(
            (BATCH, IMG, IMG, 3))
        out.append((images.astype(np.float32),
                    (ident * 37 % NCLS).astype(np.int32)))
    return out


@pytest.fixture(scope="module")
def fr_tpu_run():
    """fr_tpu's initial state and its states and metrics after each of two
    steps, once."""
    mp = pytest.MonkeyPatch()
    without_head_dropout(mp)
    try:
        enc = jax_swinv2.Swin(num_blocks=SMALL[0], heads=SMALL[1],
                              emd_size=EMB)
        variables = jax.jit(lambda k: enc.init(
            k, jnp.zeros((1, IMG, IMG, 3), jnp.float32), train=True))(
            jax.random.key(0))
        jcfg = jax_pfc.PFCConfig(NCLS, EMB, 1, 1.0, "ArcFace", 30.0, 0.35,
                                 False, "SGD")
        params = variables["params"]
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=variables["batch_stats"],
                              opt_slots=init_slots("SGD", params),
                              pfc=init_pfc_state(jax.random.key(1), jcfg))
        mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
        step = jax_make_train_step(_conf(), mesh, enc, jcfg, donate=False)
        runs = [state]
        metrics = []
        for images, labels in _batches():
            state, m = step(state, jnp.asarray(images), jnp.asarray(labels),
                            LR, jax.random.key(3))
            runs.append(state)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    finally:
        mp.undo()
    return runs, metrics


def _assert_close(ours, ref, rtol, path):
    if isinstance(ref, dict):
        assert set(ours) == set(ref), path
        for k in ref:
            _assert_close(ours[k], ref[k], rtol, f"{path}/{k}")
        return
    a = np.asarray(ours, np.float64)
    b = np.asarray(ref, np.float64)
    assert a.shape == b.shape, path
    err = np.linalg.norm(a - b)
    assert err <= rtol * np.linalg.norm(b) + 2e-6 * np.sqrt(b.size), \
        (path, err, np.linalg.norm(b))


@pytest.mark.parametrize("stats", ["0", "1"], ids=["recompute", "stats"])
def test_two_swin_steps_match_fr_tpu(fr_tpu_run, monkeypatch, stats):
    monkeypatch.setenv("FR_ATTN_STORED_STATS", stats)
    runs, metrics = fr_tpu_run
    model = swinv2.Swin(*SMALL, emd_size=EMB, head_drop=0.0)
    state = train_state_from_jax(runs[0], model, "Swin", IMG, SMALL[0])
    cfg = PFCConfig(NCLS, EMB, margin="ArcFace", s=30.0, m=0.35,
                    mixed_precision=False)
    step = make_train_step(_conf(), cfg, "cpu")
    params0 = jax.tree.map(np.asarray, runs[0].params)
    seen = []
    real = F.window_attention_backward_stats_reference

    def spy(*a, **kw):
        seen.append("stats")
        return real(*a, **kw)
    monkeypatch.setattr(F, "window_attention_backward_stats_reference", spy)
    for i, (images, labels) in enumerate(_batches()):
        m = step(state, images, labels, LR)
        np.testing.assert_allclose(m["loss"].item(), metrics[i][0],
                                   rtol=(3e-5, 1e-4)[i])
        np.testing.assert_allclose(m["grad_norm"].item(), metrics[i][1],
                                   rtol=1e-3)
        ours = train_state_to_jax_layout(state, "Swin", IMG, SMALL[0])
        jstate = runs[i + 1]
        ref = jax.tree.map(np.asarray, {
            "params": jstate.params, "batch_stats": jstate.batch_stats,
            "opt_slots": jstate.opt_slots, "weight": jstate.pfc.weight,
            "slots": jstate.pfc.slots})
        _assert_close(ours["params"], ref["params"], 2e-4, "params")
        _assert_close(ours["pfc"]["weight"], ref["weight"], 2e-4, "head")
        _assert_close(ours["batch_stats"], ref["batch_stats"], 1e-3, "bn")
        rtol = (3e-2, 1e-1)[i]
        delta = lambda p: jax.tree.map(np.subtract, p, params0)  # noqa: E731
        _assert_close(delta(ours["params"]), delta(ref["params"]), rtol,
                      "update")
        _assert_close(ours["opt_slots"], ref["opt_slots"], rtol, "momentum")
        _assert_close(ours["pfc"]["slots"], ref["slots"], rtol, "head_slots")
    # two attention sites, two steps
    assert len(seen) == (4 if stats == "1" else 0)


def _compare_golden(ours, golden):
    assert list(ours["update_names"]) == list(golden["update_names"])
    np.testing.assert_allclose(ours["losses"], golden["losses"], rtol=1e-3)
    np.testing.assert_allclose(ours["grad_norms"], golden["grad_norms"],
                               rtol=1e-3)
    np.testing.assert_allclose(ours["update_norms"], golden["update_norms"],
                               rtol=5e-2,
                               atol=1e-3 * golden["update_norms"].max())


def test_port_cpu_training_matches_swin50_golden():
    from fr_tpu_torch.utils.golden import run_train_golden

    golden = np.load(GOLDEN)
    ours = run_train_golden(int(golden["seed"]), "cpu", "Swin50")
    assert np.isfinite(ours["losses"]).all()
    _compare_golden(ours, golden)


def swin50_train_golden_from_fr_tpu(seed: int):
    """fr_tpu's two steps of full-width Swin50 (head dropout off) on the
    seeded weights, head and batches."""
    from fr_tpu.heads.partial_fc import PFCState
    from fr_tpu.utils.torch_import import swin_from_torch
    from fr_tpu_torch.utils.golden import (TRAIN_GOLDEN, golden_encoder,
                                           seeded_state_dict,
                                           train_golden_batches,
                                           train_golden_conf,
                                           train_golden_head)
    from fr_tpu_torch.utils.jax_import import encoder_state_dict_from_jax

    conf = train_golden_conf("Swin50")
    port = golden_encoder("Swin50", train=True)
    params, stats = swin_from_torch(seeded_state_dict(port, seed), "Swin50")
    enc = jax_swinv2.Swin(*jax_swinv2.SWIN_PLANS["Swin50"], emd_size=512)
    params = jax.tree.map(jnp.asarray, params)
    head = jnp.asarray(train_golden_head(seed))
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, stats),
        opt_slots=init_slots("SGD", params),
        pfc=PFCState(weight=head, slots={"momentum": jnp.zeros_like(head)},
                     count=jnp.zeros((), jnp.int32)))
    cfg = jax_pfc.PFCConfig(conf.n_classes, conf.emd_size, 1, 1.0, "ArcFace",
                            30.0, 0.35, False, "SGD")
    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    step = jax_make_train_step(conf, mesh, enc, cfg, donate=False)
    losses, norms = [], []
    for images, labels in train_golden_batches(seed, conf.img_size):
        state, m = step(state, jnp.asarray(images), jnp.asarray(labels),
                        TRAIN_GOLDEN["lr"], jax.random.key(0))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    before = encoder_state_dict_from_jax(host(params), host(stats), "Swin50")
    after = encoder_state_dict_from_jax(host(state.params),
                                        host(state.batch_stats), "Swin50")
    names = [n for n, _ in port.named_parameters()] + ["head"]
    updates = [float(np.linalg.norm((after[n] - before[n]).numpy()))
               for n in names[:-1]]
    updates.append(float(np.linalg.norm(np.asarray(state.pfc.weight - head))))
    return {"losses": np.array(losses), "grad_norms": np.array(norms),
            "update_names": np.array(names), "update_norms":
            np.array(updates)}


@pytest.mark.slow
def test_swin50_train_golden_regenerates_with_jax(monkeypatch):
    """Recomputes the golden with jax. Writes the file when it is missing
    (delete it to regenerate); otherwise checks that the committed file is
    what fr_tpu computes."""
    without_head_dropout(monkeypatch)
    seed = 0
    ref = swin50_train_golden_from_fr_tpu(seed)
    if not GOLDEN.exists():
        np.savez_compressed(GOLDEN, seed=np.int64(seed), **ref)
    golden = np.load(GOLDEN)
    assert int(golden["seed"]) == seed
    assert list(golden["update_names"]) == list(ref["update_names"])
    for key in ("losses", "grad_norms", "update_norms"):
        np.testing.assert_allclose(golden[key], ref[key], rtol=1e-6)
