"""The port's PartialFC head against fr_tpu's: margins, the plain versions of
the margin-softmax CE kernels against ``_stats_jnp`` / ``_bwd_jnp``, the
fused autograd Function against the port's own plain CE, the plain CE
against fr_tpu's ``shard_softmax_ce``, sampling and label remap, and the
wrappers' routing. The Hopper kernels themselves are checked on the card by
test_torch_pfc_cuda.py.

Inputs come from numpy seeds. Tolerances are those of
tests/test_fused_pfc.py: statistics and losses rtol 1e-5, gradients rtol
2e-4 / atol 1e-6 (f32)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fr_tpu.heads import margins as jax_margins
from fr_tpu.heads import partial_fc as jax_pfc
from fr_tpu.ops import fused_pfc as jax_fused
from fr_tpu_torch.heads import margins, partial_fc
from fr_tpu_torch.models.common import l2_normalize
from fr_tpu_torch.ops import fused_pfc
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

D = 16


def _cfg(margin="ArcFace", mixed=False, use_fused=False, easy=False,
         num_classes=300, sample_rate=1.0):
    return partial_fc.PFCConfig(
        num_classes=num_classes, embedding_size=D, sample_rate=sample_rate,
        margin=margin, s=30.0, m=0.35, mixed_precision=mixed,
        use_fused=use_fused, easy_margin=easy)


def _jax_cfg(cfg):
    return jax_pfc.PFCConfig(model_size=1, **dataclasses.asdict(cfg))


def _problem(n, k, seed):
    """Normalised embeddings and centres, labels with −1 rows, the last 3
    columns masked."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    w = rng.standard_normal((k, D)).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    labels = rng.integers(-1, k - 3, n).astype(np.int32)
    labels[:2] = -1
    col_valid = np.arange(k) < k - 3
    g = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return emb, w, labels, col_valid, g


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


CASES = [("ArcFace", 16, 300), ("CosFace", 16, 300), ("ArcFace", 10, 131),
         ("CosFace", 10, 131)]


@pytest.mark.parametrize("margin,n,k", CASES,
                         ids=[f"{m}-{n}x{k}" for m, n, k in CASES])
def test_stats_reference_matches_stats_jnp(margin, n, k):
    emb, w, labels, col_valid, _ = _problem(n, k, seed=k)
    cfg = _cfg(margin)
    ref = jax_fused._stats_jnp(*_j(emb, w, labels, col_valid), _jax_cfg(cfg))
    ours = fused_pfc.margin_ce_stats_reference(*_t(emb, w, labels, col_valid),
                                               cfg)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=0)


@pytest.mark.parametrize("margin,n,k", CASES,
                         ids=[f"{m}-{n}x{k}" for m, n, k in CASES])
def test_backward_reference_matches_bwd_jnp(margin, n, k):
    emb, w, labels, col_valid, g = _problem(n, k, seed=k + 1)
    cfg = _cfg(margin)
    jcfg = _jax_cfg(cfg)
    m, d, _ = jax_fused._stats_jnp(*_j(emb, w, labels, col_valid), jcfg)
    ref = jax_fused._bwd_jnp(*_j(emb, w, labels, col_valid), m, d,
                             jnp.asarray(g), jcfg)
    ours = fused_pfc.margin_ce_backward_reference(
        *_t(emb, w, labels, col_valid, m, d, g), cfg)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=1e-6)


def test_bf16_backward_reference_matches_bwd_jnp():
    """bf16 operands (mixed precision): the coeff and operands round to bf16
    at the same points; the products accumulate in f32 on both sides."""
    emb, w, labels, col_valid, g = _problem(16, 300, seed=5)
    cfg = _cfg("ArcFace", mixed=True)
    jcfg = _jax_cfg(cfg)
    je, jw = jnp.asarray(emb, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    m, d, t = jax_fused._stats_jnp(je, jw, *_j(labels, col_valid), jcfg)
    te = torch.from_numpy(emb).bfloat16()
    tw = torch.from_numpy(w).bfloat16()
    ours = fused_pfc.margin_ce_stats_reference(te, tw,
                                               *_t(labels, col_valid), cfg)
    for a, b in zip(ours, (m, d, t)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    ref = jax_fused._bwd_jnp(je, jw, *_j(labels, col_valid), m, d,
                             jnp.asarray(g), jcfg)
    ours = fused_pfc.margin_ce_backward_reference(
        te, tw, *_t(labels, col_valid, m, d, g), cfg)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("margin", ["ArcFace", "CosFace"])
def test_fused_function_matches_plain_ce_under_autograd(margin):
    """The port's fused Function (plain versions on the CPU) against its own
    shard_softmax_ce with use_fused off: mean loss and both gradients."""
    emb, w, labels, col_valid, _ = _problem(16, 300, seed=9)
    results = []
    for fused in (False, True):
        cfg = _cfg(margin, use_fused=fused)
        te = torch.from_numpy(emb).requires_grad_(True)
        tw = torch.from_numpy(0.05 * w).requires_grad_(True)
        loss = partial_fc.shard_softmax_ce(
            cfg, te, torch.from_numpy(labels).long(), tw,
            torch.from_numpy(col_valid)).mean()
        loss.backward()
        results.append((loss.item(), te.grad.numpy(), tw.grad.numpy()))
    (lp, gep, gwp), (lf, gef, gwf) = results
    np.testing.assert_allclose(lf, lp, rtol=1e-5)
    np.testing.assert_allclose(gef, gep, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(gwf, gwp, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "bf16"])
def test_shard_softmax_ce_matches_fr_tpu(use_fused, mixed):
    """Per-sample loss and gradients against fr_tpu's shard_softmax_ce
    (jnp path, or its fused custom_vjp with the jnp twins on the CPU)."""
    emb, w, labels, col_valid, _ = _problem(12, 200, seed=21)
    w = 0.05 * w
    cfg = _cfg("ArcFace", mixed=mixed, use_fused=use_fused, num_classes=197)
    jcfg = _jax_cfg(cfg)

    def jloss(e, ww):
        return jax_pfc.shard_softmax_ce(jcfg, e, jnp.asarray(labels), ww,
                                        jnp.asarray(col_valid), None).mean()

    jl, (jge, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(*_j(emb, w))
    te = torch.from_numpy(emb).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    loss = partial_fc.shard_softmax_ce(cfg, te,
                                       torch.from_numpy(labels).long(), tw,
                                       torch.from_numpy(col_valid)).mean()
    loss.backward()
    rtol = 1e-5 if not mixed else 1e-4
    np.testing.assert_allclose(loss.item(), float(jl), rtol=rtol)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jge), rtol=2e-4,
                               atol=1e-6 if not mixed else 2e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=2e-4,
                               atol=1e-6 if not mixed else 2e-5)


@pytest.mark.parametrize("name,kw", [("ArcFace", {}),
                                     ("ArcFace", {"easy_margin": True}),
                                     ("CosFace", {})])
def test_margins_equal_fr_tpu(name, kw):
    rng = np.random.default_rng(3)
    z = np.clip(rng.uniform(-1.1, 1.1, (8, 40)), -1, 1).astype(np.float32)
    z[0, 5], z[1, 7] = 1.0, -1.0
    labels = rng.integers(-1, 40, 8).astype(np.int32)
    labels[0], labels[1] = 5, 7
    ref = jax_margins.get_margin_fn(name, 30.0, 0.35, **kw)(*_j(z, labels))
    ours = margins.get_margin_fn(name, 30.0, 0.35, **kw)(
        *_t(z, labels.astype(np.int64)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("z", [1.0, -1.0])
def test_arcface_gradient_is_finite_at_unit_cosine(z):
    """|cosθ| = 1 is reachable after the ±1 clamp; the double where keeps
    sqrt'(0) out of the backward (plain and kernel-contract derivative)."""
    logits = torch.full((2, 4), 0.3, dtype=torch.float32)
    logits[0, 1] = z
    logits[1, 2] = z
    logits.requires_grad_(True)
    out = margins.arcface(logits, torch.tensor([1, 2]), s=30.0, m=0.35)
    out.sum().backward()
    assert torch.isfinite(logits.grad).all()
    mc = fused_pfc.margin_consts("ArcFace", 0.35)
    onehot = torch.zeros((2, 4), dtype=torch.bool)
    onehot[0, 1] = onehot[1, 2] = True
    deriv = fused_pfc.margin_deriv_tile(logits.detach(), onehot, "ArcFace",
                                        30.0, mc)
    assert torch.isfinite(deriv).all()


def test_sampling_keeps_positives_and_remap_matches_fr_tpu():
    cfg = _cfg(num_classes=97, sample_rate=0.3)
    labels = np.array([3, 50, 96, 3, 120, -1], np.int32)
    owned = (labels >= 0) & (labels < cfg.num_local)
    pos = np.zeros(cfg.num_local, bool)
    pos[labels[owned]] = True
    valid = partial_fc.shard_valid_mask(cfg)
    gen = torch.Generator().manual_seed(0)
    idx = partial_fc.sample_columns(cfg, gen, torch.from_numpy(pos), valid)
    assert idx.shape == (cfg.num_sample,) == (29,)
    assert torch.all(idx[1:] > idx[:-1])
    assert set(np.flatnonzero(pos)) <= set(idx.tolist())
    ref = jax_pfc.remap_labels(_jax_cfg(cfg), jnp.asarray(idx.numpy()),
                               *_j(labels, owned))
    ours = partial_fc.label_columns(cfg, torch.from_numpy(labels).long(), idx)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    full = partial_fc.label_columns(_cfg(num_classes=97),
                                    torch.from_numpy(labels).long(), None)
    np.testing.assert_array_equal(full.numpy(), [3, 50, 96, 3, -1, -1])


def test_dense_partial_fc_loss_matches_fr_tpu():
    emb, w, labels, _, _ = _problem(8, 64, seed=13)
    labels = np.abs(labels)
    cfg = _cfg(num_classes=60)
    ref = jax_pfc.dense_partial_fc_loss(_jax_cfg(cfg), *_j(emb, labels, w))
    ours = partial_fc.dense_partial_fc_loss(cfg, *_t(emb, labels.astype(
        np.int64), w))
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-5)


def test_cpu_tensors_take_the_plain_versions_without_launch():
    emb, w, labels, col_valid, g = _problem(10, 131, seed=2)
    cfg = _cfg()
    args = _t(emb, w, labels, col_valid)
    counts = [f.launches for f in (fused_pfc.margin_ce_stats,
                                   fused_pfc.margin_ce_grad_emb,
                                   fused_pfc.margin_ce_grad_w)]
    m, d, t = fused_pfc.margin_ce_stats(*args, cfg)
    ge = fused_pfc.margin_ce_grad_emb(*args, m, d, torch.from_numpy(g), cfg)
    gw = fused_pfc.margin_ce_grad_w(*args, m, d, torch.from_numpy(g), cfg)
    assert [f.launches for f in (fused_pfc.margin_ce_stats,
                                 fused_pfc.margin_ce_grad_emb,
                                 fused_pfc.margin_ce_grad_w)] == counts
    rge, rgw = fused_pfc.margin_ce_backward_reference(
        *args, m, d, torch.from_numpy(g), cfg)
    torch.testing.assert_close(ge, rge, rtol=0, atol=0)
    torch.testing.assert_close(gw, rgw, rtol=0, atol=0)


def test_margin_ce_on_other_devices_raises():
    emb = torch.empty((4, D), device="meta")
    with pytest.raises(ValueError, match="no margin-CE kernel"):
        fused_pfc.margin_ce_stats(emb, torch.empty((8, D), device="meta"),
                                  torch.zeros(4, dtype=torch.long),
                                  torch.ones(8, dtype=torch.bool), _cfg())


def test_l2_normalize_matches_fr_tpu_with_zero_rows():
    from fr_tpu.models.common import l2_normalize as jax_l2
    x = np.random.default_rng(4).standard_normal((5, D)).astype(np.float32)
    x[2] = 0.0
    np.testing.assert_allclose(l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_l2(jnp.asarray(x))), rtol=1e-6)
