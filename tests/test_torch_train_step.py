"""The port's training step against fr_tpu's: two steps of fr_tpu's
make_train_step on a (1, 1) CPU mesh and two of the port's, from the same
weights (fr_tpu's flax init carried over by train_state_from_jax) on the
same images. AlterNet with a small stage plan (96 px, emd 64), batch 4, 300
classes, f32, SGD at lr 1e-3, drop rates 0, no augmentation; sample_rate
1.0, and 0.5 with fr_tpu's sampled columns fed in; the margin-softmax CE
plain (XLA in fr_tpu) and fused (fr_tpu's custom_vjp, the port's autograd
Function). The images are synthetic identities (template + noise).

Tolerances, and why. Deep gradients of AlterNet at init are chaotic at f32
resolution: the port's own gradients move by up to 8.8e-3 of their norm
between one and eight torch threads (summation order alone), fr_tpu's
stem-conv momentum by 6e-4 when the images move by 1e-7 relative, and a
ReLU of the position-bias MLP can flip between the two frameworks at step 2
(measured).
- loss rtol 3e-5 at each step (measured up to 1.2e-5: the embeddings'
  f32 differences pass through logits ×30 and the exponential);
- grad_norm rtol 1e-3 (measured up to 5.2e-4);
- each tensor of the state after each step, norm-wise,
  ‖ours − ref‖ ≤ rtol·‖ref‖ + 2e-6·√size: encoder parameters and the head
  weight rtol 2e-4; BN running statistics rtol 1e-3 (measured 2.1e-4);
  the updates (parameters after − before), encoder momentum and head
  momentum rtol 3e-2 after step 1 and 1e-1 after step 2 (measured up to
  1.0e-2 and 4.1e-2, the latter in a position-bias MLP). The optimizer's
  rules themselves are held to fr_tpu's at 1e-6 in
  test_torch_train_parts.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fr_tpu.configs.base import Config
from fr_tpu.heads import partial_fc as jax_pfc
from fr_tpu.heads.partial_fc import init_pfc_state
from fr_tpu.models import alternet as jax_alternet
from fr_tpu.parallel import make_mesh
from fr_tpu.train.optim import init_slots
from fr_tpu.train.state import TrainState as JaxTrainState
from fr_tpu.train.step import STREAM_SAMPLE, stream_key
from fr_tpu.train.step import make_train_step as jax_make_train_step
from fr_tpu_torch.heads.partial_fc import PFCConfig
from fr_tpu_torch.models import alternet
from fr_tpu_torch.train.step import make_train_step
from fr_tpu_torch.utils.jax_import import (train_state_from_jax,
                                           train_state_to_jax_layout)
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

SMALL_PLAN = ((3, 3, 3, 3), (0, 1, 1, 1), (2, 4, 8, 16))
IMG, EMB, NCLS, BATCH, LR = 96, 64, 300, 4, 1e-3


def _conf(sample_rate, use_fused):
    return Config(network="AlterNet", emd_size=EMB, n_classes=NCLS,
                  metric="ArcFace", loss_s=30.0, loss_m=0.35,
                  optimizer_name="SGD", optimizer="SGD", wd=5e-4, mom=0.9,
                  eps=1e-8, betas=(0.9, 0.999), mixed_precision=False,
                  sample_rate=sample_rate, use_fused=use_fused)


@pytest.fixture(scope="module")
def flax_variables():
    """fr_tpu's flax init of the small AlterNet (drop rates 0), once."""
    enc = jax_alternet.AlterNet(*SMALL_PLAN, img_size=IMG, emd_size=EMB,
                                drop_path_rate=0.0, head_drop=0.0)
    variables = jax.jit(lambda k: enc.init(
        k, jnp.zeros((1, IMG, IMG, 3), jnp.float32), train=True))(
        jax.random.key(0))
    return enc, variables


def _jax_state(variables, jcfg):
    """fr_tpu's init_train_state around given flax variables."""
    params = variables["params"]
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=variables["batch_stats"],
                         opt_slots=init_slots("SGD", params),
                         pfc=init_pfc_state(jax.random.key(1), jcfg))


def _batches(seed=0):
    """Two batches of 4 images of 8 synthetic identities."""
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


@pytest.mark.parametrize("use_fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("sample_rate", [1.0, 0.5])
def test_two_steps_match_fr_tpu(flax_variables, sample_rate, use_fused):
    enc, variables = flax_variables
    conf = _conf(sample_rate, use_fused)
    jcfg = jax_pfc.PFCConfig(NCLS, EMB, 1, sample_rate, "ArcFace", 30.0,
                             0.35, False, "SGD", use_fused=use_fused)
    jstate = _jax_state(variables, jcfg)
    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    jstep = jax_make_train_step(conf, mesh, enc, jcfg, donate=False)
    params0 = jax.tree.map(np.asarray, jstate.params)

    model = alternet.AlterNet(*SMALL_PLAN, img_size=IMG, emd_size=EMB,
                              drop_path_rate=0.0, head_drop=0.0)
    state = train_state_from_jax(jstate, model, "AlterNet", IMG,
                                 SMALL_PLAN[:2])
    cfg = PFCConfig(NCLS, EMB, sample_rate=sample_rate, margin="ArcFace",
                    s=30.0, m=0.35, mixed_precision=False,
                    use_fused=use_fused)
    assert cfg.sampling == (sample_rate < 1.0)
    step = make_train_step(conf, cfg, "cpu")

    key = jax.random.key(3)
    for i, (images, labels) in enumerate(_batches()):
        idx = None
        if cfg.sampling:
            # the columns fr_tpu's step draws (train/step.py:121-147)
            pos = np.zeros(cfg.num_local, bool)
            pos[labels] = True
            idx = np.array(jax_pfc.sample_columns(
                jcfg, stream_key(key, STREAM_SAMPLE, jstate.step, 0),
                jnp.asarray(pos), jnp.arange(cfg.num_local) < NCLS))
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels),
                           LR, key)
        m = step(state, images, labels, LR, sample_idx=idx)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=3e-5)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-3)

        ours = train_state_to_jax_layout(state, "AlterNet", IMG,
                                         SMALL_PLAN[:2])
        ref = jax.tree.map(np.asarray, {
            "params": jstate.params, "batch_stats": jstate.batch_stats,
            "opt_slots": jstate.opt_slots, "weight": jstate.pfc.weight,
            "slots": jstate.pfc.slots})
        assert ours["step"] == int(jstate.step) == i + 1
        assert ours["pfc"]["count"] == int(jstate.pfc.count) == i + 1
        _assert_close(ours["params"], ref["params"], 2e-4, "params")
        _assert_close(ours["pfc"]["weight"], ref["weight"], 2e-4, "head")
        _assert_close(ours["batch_stats"], ref["batch_stats"], 1e-3, "bn")
        rtol = (3e-2, 1e-1)[i]
        delta = lambda p: jax.tree.map(np.subtract, p, params0)  # noqa: E731
        _assert_close(delta(ours["params"]), delta(ref["params"]), rtol,
                      "update")
        _assert_close(ours["opt_slots"], ref["opt_slots"], rtol, "momentum")
        _assert_close(ours["pfc"]["slots"], ref["slots"], rtol, "head_slots")
