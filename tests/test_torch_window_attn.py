"""The port's window-attention op against fr_tpu's: the plain PyTorch version
against the per-head jnp contract ``_heads_fwd`` and against the packed
Pallas kernel in interpret mode, and the wrapper's routing. The Hopper
kernel itself is checked on the card by test_torch_window_attn_cuda.py.

Inputs come from numpy seeds; tolerances are max-abs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fr_tpu.ops.fused_window_attn import _heads_fwd
from fr_tpu.ops.fused_window_attn import \
    fused_window_attention_packed as jax_packed
from fr_tpu_torch.models.swin_common import shifted_window_mask
from fr_tpu_torch.ops import _build
from fr_tpu_torch.ops import fused_window_attn as F
from fr_tpu_torch.ops.fused_window_attn import (
    fused_window_attention_packed, window_attention_reference)

HD = 32
# (N, heads, spatial resolution, window) at the AlterNet heads·N of 144/288
SHAPES = [(36, 4, 12, 6), (36, 8, 12, 6), (9, 16, 6, 3)]
F32_TOL = 1e-5
# bf16 compute: about two bf16 ulps at |x| ≤ 2
BF16_TOL = 1.5e-2
# the packed Pallas kernel also rounds the unnormalised exponentials to bf16
PACKED_BF16_TOL = 3e-2


def _inputs(N, heads, res, ws, masked, seed, n_img=2, scale_range=(5, 20)):
    rng = np.random.default_rng(seed)
    nW = (res // ws) ** 2 if masked else 1
    C = heads * HD
    qkv = rng.standard_normal((n_img * nW, N, 3 * C)).astype(np.float32)
    scale = rng.uniform(*scale_range, heads).astype(np.float32)
    bias16 = (16.0 / (1.0 + np.exp(-rng.standard_normal((heads, N, N))))
              ).astype(np.float32)
    mask = shifted_window_mask(res, res, ws, ws // 2) if masked else None
    return qkv, scale, bias16, mask, nW


def _torch(qkv, scale, bias16, mask, dtype):
    """(qkv, scale, bias16) and the mask as torch tensors."""
    return ((torch.from_numpy(qkv).to(dtype), torch.from_numpy(scale),
             torch.from_numpy(bias16)),
            None if mask is None else torch.from_numpy(mask))


DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"N{s[0]}h{s[1]}")
def test_reference_matches_heads_fwd(shape, masked, dtype):
    N, heads, res, ws = shape
    jdt, tdt, tol = DTYPES[dtype]
    qkv, scale, bias16, mask, _ = _inputs(N, heads, res, ws, masked, seed=N)
    ref = np.asarray(_heads_fwd(jnp.asarray(qkv).astype(jdt),
                                jnp.asarray(scale), jnp.asarray(bias16),
                                None if mask is None else jnp.asarray(mask),
                                heads, jdt))
    args, tmask = _torch(qkv, scale, bias16, mask, tdt)
    out = window_attention_reference(*args, heads, tmask).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol


@pytest.mark.parametrize("shape,masked,dtype", [
    (SHAPES[0], True, "f32"), (SHAPES[1], True, "bf16"),
    (SHAPES[2], False, "f32"), (SHAPES[2], True, "bf16")],
    ids=["N36h4-mask-f32", "N36h8-mask-bf16", "N9h16-f32", "N9h16-mask-bf16"])
def test_wrapper_matches_packed_pallas_interpret(shape, masked, dtype):
    """At init-range scale (10) the port agrees with the packed TPU kernel
    run by the Pallas interpreter."""
    N, heads, res, ws = shape
    jdt, tdt, _ = DTYPES[dtype]
    tol = F32_TOL if dtype == "f32" else PACKED_BF16_TOL
    qkv, scale, bias16, mask, nW = _inputs(N, heads, res, ws, masked,
                                           seed=100 + N,
                                           scale_range=(10, 10))
    ref = np.asarray(jax_packed(
        jnp.asarray(qkv).astype(jdt), jnp.asarray(scale),
        jnp.asarray(bias16), heads, nW,
        None if mask is None else jnp.asarray(mask), interpret=True))
    args, tmask = _torch(qkv, scale, bias16, mask, tdt)
    out = fused_window_attention_packed(*args, heads, nW, tmask).numpy()
    assert np.abs(out - ref).max() <= tol


def test_divergent_heads_at_scale_100_stay_finite():
    """Head 0 scores −1·100, head 1 +1·100: 200 apart. The port takes a max
    per head, like _heads_fwd, and stays finite and equal to it; the packed
    TPU kernel's shared row max leaves head 0 with no mass (ROADMAP §3)."""
    N, heads = 9, 2
    rng = np.random.default_rng(7)
    q = rng.standard_normal((4, N, heads, HD)).astype(np.float32)
    k = np.stack([-q[:, :, 0], q[:, :, 1]], axis=2)
    v = rng.standard_normal((4, N, heads, HD)).astype(np.float32)
    qkv = np.concatenate([t.reshape(4, N, heads * HD) for t in (q, k, v)],
                         axis=-1)
    scale = np.full((heads,), 100.0, np.float32)
    bias16 = np.full((heads, N, N), 8.0, np.float32)
    ref = np.asarray(_heads_fwd(jnp.asarray(qkv), jnp.asarray(scale),
                                jnp.asarray(bias16), None, heads,
                                jnp.float32))
    args, _ = _torch(qkv, scale, bias16, None, torch.float32)
    out = fused_window_attention_packed(*args, heads, 1).numpy()
    assert np.isfinite(out).all()
    assert np.abs(out - ref).max() <= F32_TOL
    packed = np.asarray(jax_packed(jnp.asarray(qkv), jnp.asarray(scale),
                                   jnp.asarray(bias16), heads, 1,
                                   interpret=True))
    assert not np.isfinite(packed).all()


def test_cpu_tensor_takes_plain_version_without_launch():
    qkv, scale, bias16, mask, nW = _inputs(36, 4, 12, 6, True, seed=3)
    args, tmask = _torch(qkv, scale, bias16, mask, torch.bfloat16)
    before = fused_window_attention_packed.launches
    out = fused_window_attention_packed(*args, 4, nW, tmask,
                                        out_dtype=torch.bfloat16)
    assert fused_window_attention_packed.launches == before
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(
        out, window_attention_reference(*args, 4, tmask, torch.bfloat16),
        rtol=0, atol=0)


def test_other_devices_raise():
    qkv = torch.empty((4, 9, 96), device="meta")
    with pytest.raises(ValueError, match="no window-attention kernel"):
        fused_window_attention_packed(qkv, torch.ones(1), torch.ones(1, 9, 9),
                                      1, 1)


def test_mask_window_count_is_checked():
    qkv, scale, bias16, mask, nW = _inputs(9, 16, 6, 3, True, seed=4)
    with pytest.raises(ValueError, match="n_win_per_img"):
        args, tmask = _torch(qkv, scale, bias16, mask, torch.float32)
        fused_window_attention_packed(*args, 16, nW + 1, tmask)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


# (windows, windows per image, heads, masked, CTAs the card holds at once):
# the main path's tensor-core calls (six or four CTAs an SM, 132 SMs) and
# small ones whose runs of windows end ragged (prime image counts, few
# slots so that the runs are long, a mask with more slices than slots)
PLANS = [(2048, 16, 4, True, 528), (2048, 16, 4, False, 792),
         (512, 4, 8, True, 528), (512, 1, 16, False, 2112),
         (512, 4, 8, False, 792), (128, 1, 16, False, 792),
         (4 * 13, 4, 8, True, 10), (37, 1, 3, False, 4),
         (16 * 3, 16, 2, True, 5), (41, 1, 8, False, 7)]


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: "-".join(map(str, p)))
def test_tensor_core_plan_covers_each_window_and_head_once(plan):
    """The tensor-core kernels' launch plan, which the wrapper computes and
    window_attn_tc.cuh walks: every (window, head) in exactly one block, at
    most the plan's windows per block, one mask slice per block when
    masked, the backward's scratch one row per block, and one wave of CTAs
    unless a block already takes a whole mask slice."""
    n_windows, nw, heads, masked, slots = plan
    wpc, ctas = F.tensor_core_plan(n_windows, nw, heads, masked, slots)
    seen = []
    for block in range(ctas * heads):
        h, windows = F.tensor_core_windows(block, n_windows, nw, heads,
                                           masked, slots)
        assert 1 <= len(windows) <= wpc
        if masked:
            assert len({w % nw for w in windows}) == 1
        seen += [(w, h) for w in windows]
    assert len(seen) == len(set(seen)) == n_windows * heads
    assert set(seen) == {(w, h) for w in range(n_windows)
                         for h in range(heads)}
    per_slice = n_windows // (nw if masked else 1)
    assert ctas * heads <= F._TC_WAVES * slots or wpc == per_slice
    # and no shorter run would have fit one wave
    if wpc > 1:
        shorter = -(-per_slice // (wpc - 1)) * (nw if masked else 1)
        assert shorter * heads > F._TC_WAVES * slots


def test_tensor_core_route_and_shared_memory():
    """bf16 with N and an even head dim up to 64 takes the tensor cores;
    f32, odd head dims and larger tiles do not. Every such tile's CTA fits
    the card's 227 KB of shared memory, masked and in the backward."""
    bf, f32 = torch.bfloat16, torch.float32
    assert F.tensor_core_route(bf, 49, 38) and F.tensor_core_route(bf, 9, 32)
    assert not F.tensor_core_route(f32, 49, 32)
    assert not F.tensor_core_route(bf, 81, 32)
    assert not F.tensor_core_route(bf, 49, 72)
    assert not F.tensor_core_route(bf, 49, 33)
    worst = max(F._tc_smem_bytes(n, hd, True, True)
                for n in range(1, 65) for hd in range(2, 65, 2))
    assert worst == F._tc_smem_bytes(64, 64, True, True) <= 227 * 1024
    # N = 49, head dim 32: bias (49, 72) f32, zero row and two stages of
    # q, k, v as (49, 40) bf16
    assert F._tc_smem_bytes(49, 32, False, False) == \
        4 * 49 * 72 + 2 * (40 + 6 * 49 * 40)


def test_tensor_core_switch_routes_every_call_to_the_cuda_cores(monkeypatch):
    """With fused_window_attn.TENSOR_CORES off, bf16 within the tile takes
    the CUDA-core kernels too (the arithmetic the stored-stats and
    entry-fused kernels share); the default is on."""
    assert F.TENSOR_CORES is True
    monkeypatch.setattr(F, "TENSOR_CORES", False)
    assert not F.tensor_core_route(torch.bfloat16, 49, 32)
    assert not F._windows_route(torch.empty(2, 49, 3 * 64,
                                            dtype=torch.bfloat16), 2)
