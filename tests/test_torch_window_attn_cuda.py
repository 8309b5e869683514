"""The Hopper window-attention forward kernels against their plain PyTorch
version, on the card: bf16 takes the tensor-core kernel (window_attn_tc.cuh)
at every tile of the models' path, f32 and bf16 shapes beyond the tile the
CUDA-core one, each counted on fused_window_attn.route_launches. Imports no
jax, so it also runs on a machine without it:

    python -m pytest tests/test_torch_window_attn_cuda.py --noconftest -q

(--noconftest: tests/conftest.py sets jax up). Without a CUDA device every
test skips with its reason."""

import numpy as np
import pytest
import torch

from fr_tpu_torch.models.swin_common import shifted_window_mask
from fr_tpu_torch.ops import fused_window_attn as F
from fr_tpu_torch.ops.fused_window_attn import (
    fused_window_attention_packed, window_attention_reference)

# AlterNet50 at 192 px, b = 128 images: (B·nW, N, heads, resolution, window)
CARD_SHAPES = [(2048, 36, 4, 24, 6), (512, 36, 8, 12, 6), (512, 9, 16, 6, 3)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: f"N{s[1]}h{s[2]}")
def test_kernel_matches_plain_version_on_card(cuda_device, shape, masked,
                                              dtype):
    """f32 ≤ 5e-5 (TF32 off in the plain version); bf16 ≤ 3.2e-2, two bf16
    ulps at |x| < 4 (p and the output round to bf16 on both sides)."""
    bw, n, heads, res, ws = shape
    dt = DTYPES[dtype]
    tol = 5e-5 if dtype == "f32" else 3.2e-2
    gen = torch.Generator(device=cuda_device).manual_seed(bw + n + heads)
    qkv = torch.randn(bw, n, 3 * heads * 32, device=cuda_device,
                      generator=gen).to(dt)
    scale = torch.empty(heads, device=cuda_device).uniform_(
        5.0, 20.0, generator=gen)
    bias16 = 16 * torch.sigmoid(torch.randn(heads, n, n, device=cuda_device,
                                            generator=gen))
    mask = None
    if masked:
        mask = torch.from_numpy(shifted_window_mask(res, res, ws, ws // 2)
                                ).to(cuda_device)
    nw = mask.shape[0] if masked else 1
    torch.backends.cuda.matmul.allow_tf32 = False
    before = fused_window_attention_packed.launches
    out = fused_window_attention_packed(qkv, scale, bias16, heads, nw, mask,
                                        out_dtype=dt)
    torch.cuda.synchronize()
    assert fused_window_attention_packed.launches == before + 1
    ref = window_attention_reference(qkv, scale, bias16, heads, mask, dt)
    assert out.dtype == dt and torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    qkv = torch.randn(4, 36, 3 * 128, device=cuda_device,
                      dtype=torch.float16)
    scale = torch.ones(4, device=cuda_device)
    bias16 = torch.zeros(4, 36, 36, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_window_attention_packed(qkv, scale, bias16, 4, 1)
    with pytest.raises(ValueError, match="bias16"):
        fused_window_attention_packed(qkv.float(), scale, bias16[:, :9], 4, 1)


def routes_moved(call):
    """Runs call(); returns (its result, {route: launches it added})."""
    before = dict(F.route_launches)
    out = call()
    return out, {k: v - before[k] for k, v in F.route_launches.items()
                 if v != before[k]}


def tc_inputs(n, hd, heads, nw, images, masked, dev, seed=0):
    """bf16 qkv (nw·images windows), scale, bias16, g and a random −100/0
    mask over nw windows (or None)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 7 * n + hd + heads)
    bw, c = nw * images, heads * hd
    qkv = torch.randn(bw, n, 3 * c, device=dev, generator=gen).to(
        torch.bfloat16)
    scale = torch.empty(heads, device=dev).uniform_(5.0, 20.0, generator=gen)
    bias16 = 16 * torch.sigmoid(torch.randn(heads, n, n, device=dev,
                                            generator=gen))
    g = torch.randn(bw, n, c, device=dev, generator=gen).to(torch.bfloat16)
    mask = None
    if masked:
        mask = torch.where(torch.rand(nw, n, n, device=dev, generator=gen)
                           < 0.3, -100.0, 0.0)
        mask[:, torch.arange(n), torch.arange(n)] = 0.0
    return qkv, scale, bias16, g, mask


# (N, head dim, heads, windows per image, images): N 9, 36, 49 pad to 16,
# 48, 64 tokens; head dim 32 takes 16-byte copies, 38 (EffiAlter_m) 4-byte
# ones; the image counts are primes, so no windows-per-CTA run divides the
# windows of a mask slice and every plan has a ragged last CTA.
TC_SHAPES = [(9, 32, 16, 4, 19), (36, 32, 8, 4, 13), (49, 32, 8, 4, 11),
             (49, 38, 8, 1, 37), (36, 38, 4, 16, 3), (9, 38, 4, 1, 41)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", TC_SHAPES,
                         ids=lambda s: f"N{s[0]}hd{s[1]}h{s[2]}")
def test_tensor_core_forward_matches_plain_version(cuda_device, shape,
                                                   masked, out_dtype):
    """bf16 takes the tensor-core kernel, once, and matches the plain
    version within 3.2e-2 (two bf16 ulps at |x| < 4; p and the output round
    to bf16 on both sides) in either output dtype."""
    n, hd, heads, nw, images = shape
    od = DTYPES[out_dtype]
    qkv, scale, bias16, _, mask = tc_inputs(n, hd, heads, nw, images, masked,
                                            cuda_device)
    out, moved = routes_moved(lambda: fused_window_attention_packed(
        qkv, scale, bias16, heads, nw, mask, out_dtype=od))
    torch.cuda.synchronize()
    assert moved == {"fwd_tensor_cores": 1}
    ref = window_attention_reference(qkv, scale, bias16, heads, mask, od)
    assert out.dtype == od and torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= 3.2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,route", [
    ("f32", 32, "fwd_cuda_cores"), ("bf16", 32, "fwd_tensor_cores"),
    ("bf16", 72, "fwd_cuda_cores"), ("bf16", 34, "fwd_tensor_cores"),
    ("bf16", 33, "fwd_cuda_cores")])
def test_forward_routes_by_dtype_and_tile(cuda_device, dtype, hd, route):
    """The route is explicit: f32 and bf16 head dims beyond the tile (> 64)
    or odd take the CUDA-core kernel, bf16 within it the tensor-core one;
    each launch counts on its route alone, and both match the plain
    version."""
    heads, n, dt = 2, 9, DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(hd)
    qkv = torch.randn(12, n, 3 * heads * hd, device=cuda_device,
                      generator=gen).to(dt)
    scale = torch.full((heads,), 10.0, device=cuda_device)
    bias16 = torch.rand(heads, n, n, device=cuda_device, generator=gen)
    out, moved = routes_moved(lambda: fused_window_attention_packed(
        qkv, scale, bias16, heads, 1, out_dtype=dt))
    torch.cuda.synchronize()
    assert moved == {route: 1}
    assert F.tensor_core_route(dt, n, hd) == (route == "fwd_tensor_cores")
    ref = window_attention_reference(qkv, scale, bias16, heads, None, dt)
    tol = 5e-5 if dtype == "f32" else 3.2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_divergent_heads_at_scale_100_stay_finite_on_tensor_cores(
        cuda_device):
    """Head 0 scores −1·100, head 1 +1·100: 200 apart. The tensor-core
    kernel takes its max per head and per row, and stays finite and equal
    to the plain version (the packed TPU kernel's shared max does not,
    ROADMAP §3)."""
    n, heads, hd = 9, 2, 32
    rng = np.random.default_rng(7)
    q = rng.standard_normal((4, n, heads, hd)).astype(np.float32)
    k = np.stack([-q[:, :, 0], q[:, :, 1]], axis=2)
    v = rng.standard_normal((4, n, heads, hd)).astype(np.float32)
    qkv = torch.from_numpy(np.concatenate(
        [t.reshape(4, n, heads * hd) for t in (q, k, v)], axis=-1)).to(
            cuda_device, torch.bfloat16)
    scale = torch.full((heads,), 100.0, device=cuda_device)
    bias16 = torch.full((heads, n, n), 8.0, device=cuda_device)
    out, moved = routes_moved(lambda: fused_window_attention_packed(
        qkv, scale, bias16, heads, 1, out_dtype=torch.bfloat16))
    torch.cuda.synchronize()
    assert moved == {"fwd_tensor_cores": 1}
    assert torch.isfinite(out).all()
    ref = window_attention_reference(qkv, scale, bias16, heads, None,
                                     torch.bfloat16)
    assert (out.float() - ref.float()).abs().max().item() <= 3.2e-2
