"""The port's window-attention backward against fr_tpu's: the plain PyTorch
version against the per-head jnp contract ``_bwd_jnp`` and against jax.vjp
of the packed op with the recompute Pallas kernel ``_pk_bwd_pallas`` run by
the Pallas interpreter; the autograd Function's plumbing; the wrapper's
routing. The Hopper kernel itself is checked on the card by
test_torch_window_attn_bwd_cuda.py.

Inputs come from numpy seeds. f32 tolerances are 1e-5 of max(|ref|, 1);
bf16 ones two bf16 ulps of the largest |ref| (dqkv is rounded to bf16 on
both sides, and one ulp flips where the two sides' f32 sums round
differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fr_tpu.ops.fused_window_attn import _bwd_jnp
from fr_tpu.ops.fused_window_attn import \
    fused_window_attention_packed as jax_packed
from fr_tpu_torch.models.swin_common import shifted_window_mask
from fr_tpu_torch.ops.fused_window_attn import (
    fused_window_attention_packed, window_attention_backward,
    window_attention_backward_reference, window_attention_reference)
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

HD = 32
# (N, heads, spatial resolution, window): AlterNet's stage-2 and stage-4
# window shapes
SHAPES = [(36, 4, 12, 6), (9, 16, 6, 3)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(N, heads, res, ws, masked, seed, n_img=2, scale_range=(5, 20)):
    rng = np.random.default_rng(seed)
    nW = (res // ws) ** 2 if masked else 1
    C = heads * HD
    qkv = rng.standard_normal((n_img * nW, N, 3 * C)).astype(np.float32)
    scale = rng.uniform(*scale_range, heads).astype(np.float32)
    bias16 = (16.0 / (1.0 + np.exp(-rng.standard_normal((heads, N, N))))
              ).astype(np.float32)
    g = rng.standard_normal((n_img * nW, N, C)).astype(np.float32)
    mask = shifted_window_mask(res, res, ws, ws // 2) if masked else None
    return qkv, scale, bias16, g, mask, nW


def _tol(dtype, ref):
    mag = float(np.abs(ref).max())
    if dtype == "f32":
        return 1e-5 * max(mag, 1.0)
    return 2.0 * 2.0 ** (np.floor(np.log2(mag)) - 7)   # two bf16 ulps


def _assert_grads(ours, ref, dtype):
    for name, a, b in zip(("dqkv", "dscale", "dbias"), ours, ref):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, name
        err = np.abs(a - b).max()
        assert err <= _tol(dtype, b), (name, err, _tol(dtype, b))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"N{s[0]}h{s[1]}")
def test_backward_reference_matches_bwd_jnp(shape, masked, dtype):
    N, heads, res, ws = shape
    jdt, tdt = DTYPES[dtype]
    qkv, scale, bias16, g, mask, _ = _inputs(N, heads, res, ws, masked,
                                             seed=N + heads)
    ref = _bwd_jnp(jnp.asarray(qkv).astype(jdt), jnp.asarray(scale),
                   jnp.asarray(bias16),
                   None if mask is None else jnp.asarray(mask),
                   jnp.asarray(g), heads)
    ours = window_attention_backward_reference(
        torch.from_numpy(qkv).to(tdt), torch.from_numpy(scale),
        torch.from_numpy(bias16), torch.from_numpy(g), heads,
        None if mask is None else torch.from_numpy(mask))
    assert ours[0].dtype == tdt
    assert ours[1].dtype == ours[2].dtype == torch.float32
    _assert_grads([t.float().numpy() for t in ours],
                  [np.asarray(r.astype(jnp.float32)) for r in ref], dtype)


@pytest.mark.parametrize("shape,masked,dtype", [
    (SHAPES[0], False, "f32"), (SHAPES[0], True, "bf16"),
    (SHAPES[1], True, "f32"), (SHAPES[1], False, "bf16")],
    ids=["N36h4-f32", "N36h4-mask-bf16", "N9h16-mask-f32", "N9h16-bf16"])
def test_backward_matches_interpreted_pk_bwd_pallas(shape, masked, dtype):
    """jax.vjp of the packed op with stored_stats=False runs the recompute
    kernel _pk_bwd_pallas in the Pallas interpreter; the port's backward
    (through its autograd Function, on the CPU) agrees with it. Scale 10:
    the packed kernel's shared row max needs scores within ~88 of each
    other (ROADMAP §3)."""
    N, heads, res, ws = shape
    jdt, tdt = DTYPES[dtype]
    qkv, scale, bias16, g, mask, nW = _inputs(N, heads, res, ws, masked,
                                              seed=200 + N,
                                              scale_range=(10, 10))
    jmask = None if mask is None else jnp.asarray(mask)

    def f(q, s, b):
        return jax_packed(q, s, b, heads, nW, jmask, 1024, True, jdt,
                          stored_stats=False)

    _, vjp = jax.vjp(f, jnp.asarray(qkv).astype(jdt), jnp.asarray(scale),
                     jnp.asarray(bias16))
    ref = vjp(jnp.asarray(g).astype(jdt))

    tq = torch.from_numpy(qkv).to(tdt).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    tb = torch.from_numpy(bias16).requires_grad_(True)
    out = fused_window_attention_packed(
        tq, ts, tb, heads, nW, None if mask is None else
        torch.from_numpy(mask), out_dtype=tdt, stored_stats=False)
    out.backward(torch.from_numpy(g).to(tdt))
    _assert_grads([tq.grad.float().numpy(), ts.grad.numpy(),
                   tb.grad.numpy()],
                  [np.asarray(r.astype(jnp.float32)) for r in ref], dtype)


def test_function_gradients_equal_autograd_of_the_plain_forward():
    """f32: the hand-written recompute backward behind the autograd
    Function equals torch autograd through the plain forward, scale and
    bias included."""
    qkv, scale, bias16, g, mask, nW = _inputs(36, 4, 12, 6, True, seed=11)
    grads = []
    for fn in ("function", "autograd"):
        tq = torch.from_numpy(qkv).requires_grad_(True)
        ts = torch.from_numpy(scale).requires_grad_(True)
        tb = torch.from_numpy(bias16).requires_grad_(True)
        tm = torch.from_numpy(mask)
        out = (fused_window_attention_packed(tq, ts, tb, 4, nW, tm,
                                             stored_stats=False)
               if fn == "function"
               else window_attention_reference(tq, ts, tb, 4, tm))
        out.backward(torch.from_numpy(g))
        grads.append([tq.grad.numpy(), ts.grad.numpy(), tb.grad.numpy()])
    _assert_grads(grads[0], grads[1], "f32")


def test_cpu_backward_takes_plain_version_without_launch():
    qkv, scale, bias16, g, mask, nW = _inputs(9, 16, 6, 3, True, seed=3)
    args = (torch.from_numpy(qkv).bfloat16(), torch.from_numpy(scale),
            torch.from_numpy(bias16), torch.from_numpy(g).bfloat16(), 16)
    before = window_attention_backward.launches
    ours = window_attention_backward(*args, nW, torch.from_numpy(mask))
    assert window_attention_backward.launches == before
    ref = window_attention_backward_reference(*args, torch.from_numpy(mask))
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_backward_on_other_devices_raises():
    qkv = torch.empty((4, 9, 96), device="meta")
    with pytest.raises(ValueError, match="no window-attention kernel"):
        window_attention_backward(qkv, torch.ones(1), torch.ones(1, 9, 9),
                                  torch.empty((4, 9, 32), device="meta"),
                                  1, 1)
