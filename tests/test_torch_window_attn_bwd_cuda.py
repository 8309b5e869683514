"""The Hopper window-attention backward kernels against their plain PyTorch
version, on the card: bf16 takes the tensor-core kernel at every tile of the
models' path, f32 and bf16 shapes beyond the tile the CUDA-core one. Imports
no jax, so it also runs on a machine without it:

    python -m pytest tests/test_torch_window_attn_bwd_cuda.py --noconftest -q

(--noconftest: tests/conftest.py sets jax up). Without a CUDA device every
test skips with its reason."""

import pytest
import torch

from fr_tpu_torch.models.swin_common import shifted_window_mask
from fr_tpu_torch.ops.fused_window_attn import (
    fused_window_attention_packed, window_attention_backward,
    window_attention_backward_reference)
from test_torch_window_attn_cuda import TC_SHAPES, routes_moved, tc_inputs

# AlterNet50 at 192 px, b = 128 images: (B·nW, N, heads, resolution, window)
CARD_SHAPES = [(2048, 36, 4, 24, 6), (512, 36, 8, 12, 6), (512, 9, 16, 6, 3)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, masked, dt, dev):
    bw, n, heads, res, ws = shape
    gen = torch.Generator(device=dev).manual_seed(bw + n + heads)
    c = heads * 32
    qkv = torch.randn(bw, n, 3 * c, device=dev, generator=gen).to(dt)
    scale = torch.empty(heads, device=dev).uniform_(5.0, 20.0, generator=gen)
    bias16 = 16 * torch.sigmoid(torch.randn(heads, n, n, device=dev,
                                            generator=gen))
    g = torch.randn(bw, n, c, device=dev, generator=gen).to(dt)
    mask = None
    if masked:
        mask = torch.from_numpy(shifted_window_mask(res, res, ws, ws // 2)
                                ).to(dev)
    return qkv, scale, bias16, g, mask, (mask.shape[0] if masked else 1)


def _tol(dtype, ref):
    """f32 5e-5·max(|ref|, 1) (TF32 off in the plain version; sums in
    another order); bf16 two bf16 ulps of the largest |ref|."""
    mag = ref.abs().max().item()
    if dtype == "f32":
        return 5e-5 * max(mag, 1.0)
    return 2.0 * 2.0 ** (int(torch.tensor(mag).log2().floor()) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: f"N{s[1]}h{s[2]}")
def test_backward_kernel_matches_plain_version_on_card(cuda_device, shape,
                                                       masked, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv, scale, bias16, g, mask, nw = _inputs(shape, masked, DTYPES[dtype],
                                              cuda_device)
    heads = shape[2]
    before = window_attention_backward.launches
    ours = window_attention_backward(qkv, scale, bias16, g, heads, nw, mask)
    torch.cuda.synchronize()
    assert window_attention_backward.launches == before + 1
    ref = window_attention_backward_reference(qkv, scale, bias16, g, heads,
                                              mask)
    assert ours[0].dtype == DTYPES[dtype]
    for name, a, b in zip(("dqkv", "dscale", "dbias"), ours, ref):
        assert torch.isfinite(a).all(), name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= _tol(dtype, b.float()), (name, err)


@pytest.mark.cuda
def test_backward_sums_are_deterministic(cuda_device):
    """dscale and dbias come from a fixed-order reduction: bit for bit the
    same on every run."""
    qkv, scale, bias16, g, mask, nw = _inputs(CARD_SHAPES[0], True,
                                              torch.bfloat16, cuda_device)
    first = window_attention_backward(qkv, scale, bias16, g, 4, nw, mask)
    for _ in range(3):
        again = window_attention_backward(qkv, scale, bias16, g, 4, nw, mask)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_autograd_runs_both_kernels(cuda_device):
    qkv, scale, bias16, g, mask, nw = _inputs(CARD_SHAPES[2], True,
                                              torch.bfloat16, cuda_device)
    qkv.requires_grad_(True)
    scale.requires_grad_(True)
    fwd = fused_window_attention_packed.launches
    bwd = window_attention_backward.launches
    out = fused_window_attention_packed(qkv, scale, bias16, 16, nw, mask,
                                        out_dtype=torch.bfloat16,
                                        stored_stats=False)
    out.backward(g)
    torch.cuda.synchronize()
    assert fused_window_attention_packed.launches == fwd + 1
    assert window_attention_backward.launches == bwd + 1
    assert qkv.grad.dtype == torch.bfloat16 and scale.grad.shape == (16,)
    assert torch.isfinite(qkv.grad.float()).all()


@pytest.mark.cuda
def test_backward_kernel_rejects_what_it_does_not_take(cuda_device):
    qkv = torch.randn(4, 36, 3 * 128, device=cuda_device,
                      dtype=torch.float16)
    scale = torch.ones(4, device=cuda_device)
    bias16 = torch.zeros(4, 36, 36, device=cuda_device)
    g = torch.zeros(4, 36, 128, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        window_attention_backward(qkv, scale, bias16, g, 4, 1)
    with pytest.raises(ValueError, match="g must be"):
        window_attention_backward(qkv.float(), scale, bias16, g[:, :9], 4, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", TC_SHAPES,
                         ids=lambda s: f"N{s[0]}hd{s[1]}h{s[2]}")
def test_tensor_core_backward_matches_plain_version(cuda_device, shape,
                                                    masked):
    """bf16 takes the tensor-core backward, once; dqkv, dscale and dbias
    within two bf16 ulps of the plain version's largest value, and the sums
    (one partial per CTA, added in a fixed order) bit for bit the same on a
    second run. The image counts leave every plan a ragged last CTA."""
    n, hd, heads, nw, images = shape
    qkv, scale, bias16, g, mask = tc_inputs(n, hd, heads, nw, images, masked,
                                            cuda_device, seed=1)
    ours, moved = routes_moved(lambda: window_attention_backward(
        qkv, scale, bias16, g, heads, nw, mask))
    torch.cuda.synchronize()
    assert moved == {"bwd_tensor_cores": 1}
    ref = window_attention_backward_reference(qkv, scale, bias16, g, heads,
                                              mask)
    assert ours[0].dtype == torch.bfloat16
    for name, a, b in zip(("dqkv", "dscale", "dbias"), ours, ref):
        assert torch.isfinite(a.float()).all(), name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= _tol("bf16", b.float()), (name, err)
    again = window_attention_backward(qkv, scale, bias16, g, heads, nw, mask)
    for a, b in zip(ours, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,route", [
    ("f32", 32, "bwd_cuda_cores"), ("bf16", 32, "bwd_tensor_cores"),
    ("bf16", 72, "bwd_cuda_cores"), ("bf16", 33, "bwd_cuda_cores")])
def test_backward_routes_by_dtype_and_tile(cuda_device, dtype, hd, route):
    """f32 and bf16 head dims beyond the tile or odd take the CUDA-core
    backward, bf16 within it the tensor-core one; each counts on its
    route alone and matches the plain version."""
    heads, n, dt = 2, 9, DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(hd)
    qkv = torch.randn(12, n, 3 * heads * hd, device=cuda_device,
                      generator=gen).to(dt)
    g = torch.randn(12, n, heads * hd, device=cuda_device,
                    generator=gen).to(dt)
    scale = torch.full((heads,), 10.0, device=cuda_device)
    bias16 = torch.rand(heads, n, n, device=cuda_device, generator=gen)
    ours, moved = routes_moved(lambda: window_attention_backward(
        qkv, scale, bias16, g, heads, 1))
    torch.cuda.synchronize()
    assert moved == {route: 1}
    ref = window_attention_backward_reference(qkv, scale, bias16, g, heads)
    for name, a, b in zip(("dqkv", "dscale", "dbias"), ours, ref):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= _tol(dtype, b.float()), (name, err)
