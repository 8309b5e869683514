"""combined_margin (fr_tpu_torch/heads/margins.py) against fr_tpu's on
seeded f32 cosine logits, B = 16, C = 40, some rows labelled -1: the
ArcFace form (1, 0.5, 0) and the CosFace form (1, 0, 0.35), each with no
inter-class filtering and with a threshold of 0.2, at s = 64. Values within
1e-5 absolute; gradients of (out·g).sum() for a seeded g within 1e-5
absolute and relative (a gradient is about s·g, in the hundreds, where
one f32 ulp is 1.5e-5); logits at exactly ±1 give
finite gradients in both packages; the unsupported (0.9, 0.4, 0) raises in
both; get_margin_fn does not route to it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fr_tpu.heads import margins as jax_margins
from fr_tpu_torch.heads import margins
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

B, C, S = 16, 40, 64.0
FORMS = {"arcface": (1.0, 0.5, 0.0), "cosface": (1.0, 0.0, 0.35)}
CASES = [(f, t) for f in FORMS for t in (0.0, 0.2)]


def _inputs(seed, edge=False):
    rng = np.random.default_rng(seed)
    logits = rng.uniform(-1, 1, (B, C)).astype(np.float32)
    labels = rng.integers(0, C, B).astype(np.int32)
    labels[[1, 6, 11]] = -1
    if edge:  # the targets and a few others at exactly ±1
        rows = np.arange(B)[labels >= 0]
        logits[rows, labels[rows]] = np.where(rows % 2, 1.0, -1.0)
        logits[[0, 1, 2], [3, 4, 5]] = [1.0, -1.0, 1.0]
    g = rng.standard_normal((B, C)).astype(np.float32)
    return logits, labels, g


def _both(logits, labels, g, form, threshold):
    """(value, gradient) of the port's and of fr_tpu's combined margin."""
    m1, m2, m3 = FORMS[form]
    x = torch.tensor(logits, requires_grad=True)
    out = margins.combined_margin(x, torch.tensor(labels).long(), S, m1, m2,
                                  m3, threshold)
    (out * torch.tensor(g)).sum().backward()

    def ref(z):
        return jax_margins.combined_margin(z, jnp.asarray(labels), S, m1,
                                           m2, m3, threshold)

    want = np.asarray(ref(jnp.asarray(logits)))
    want_grad = np.asarray(jax.grad(
        lambda z: (ref(z) * jnp.asarray(g)).sum())(jnp.asarray(logits)))
    return (out.detach().numpy(), x.grad.numpy()), (want, want_grad)


@pytest.mark.parametrize("form,threshold", CASES)
def test_combined_margin_values_equal_fr_tpu(form, threshold):
    (got, _), (want, _) = _both(*_inputs(0), form, threshold)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if threshold:  # the filter zeroed something it should have
        logits, labels, _ = _inputs(0)
        plain, _ = _both(logits, labels, np.ones_like(logits), form, 0.0)
        assert (plain[0] != got).any()


@pytest.mark.parametrize("form,threshold", CASES)
def test_combined_margin_gradients_equal_fr_tpu(form, threshold):
    (_, got), (_, want) = _both(*_inputs(1), form, threshold)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form,threshold", CASES)
def test_combined_margin_at_unit_cosine_has_finite_gradients(form,
                                                             threshold):
    (out, grad), (want, want_grad) = _both(*_inputs(2, edge=True), form,
                                           threshold)
    assert np.isfinite(grad).all() and np.isfinite(want_grad).all()
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(grad, want_grad, rtol=1e-5, atol=1e-5)


def test_combined_margin_refuses_what_fr_tpu_refuses():
    logits, labels, _ = _inputs(3)
    with pytest.raises(ValueError, match="Unsupported combined margin"):
        margins.combined_margin(torch.tensor(logits),
                                torch.tensor(labels).long(), S, 0.9, 0.4, 0.)
    with pytest.raises(ValueError, match="Unsupported combined margin"):
        jax_margins.combined_margin(jnp.asarray(logits), jnp.asarray(labels),
                                    S, 0.9, 0.4, 0.)


@pytest.mark.parametrize("name", ["Combined", "CombinedMargin"])
def test_get_margin_fn_does_not_route_to_combined_margin(name):
    with pytest.raises(ValueError, match="Unknown margin"):
        margins.get_margin_fn(name, S, 0.5)
    with pytest.raises(ValueError, match="Unknown margin"):
        jax_margins.get_margin_fn(name, S, 0.5)
