"""The per-head window-attention entry's kernels (the forward and recompute
backward kernels, serving fr_tpu's _fwd_pallas and _bwd_pallas) against
their plain PyTorch versions, on the card, at the Swin50 and EffiAlter_m
shapes. Imports no jax, so it also runs on a machine without it:

    python -m pytest tests/test_torch_window_attn_perhead_cuda.py --noconftest -q

(--noconftest: tests/conftest.py sets jax up). Without a CUDA device every
test skips with its reason."""

import pytest
import torch

from fr_tpu_torch.models.swin_common import shifted_window_mask
from fr_tpu_torch.ops import fused_window_attn as F
from test_torch_window_attn_cuda import routes_moved

# 112 px, b = 128: (B·nW, heads, head dim, windows per image, shift-masked)
CARD_SHAPES = {"swin50_s3": (512, 8, 32, 4, False),
               "swin50_s3_masked": (512, 8, 32, 4, True),
               "swin50_s4": (128, 16, 32, 1, False),
               "effialter_m_s6": (128, 8, 38, 1, False),
               "effialter_m_s7": (128, 16, 32, 1, False)}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def attention_inputs(shape, dt, dev, seed=0):
    """qkv, scale, bias16, g, mask, nW at one of CARD_SHAPES (the mask is
    the shift-3 SW-MSA mask over 14×14)."""
    bw, heads, hd, nw, masked = shape
    gen = torch.Generator(device=dev).manual_seed(seed + bw + heads + hd)
    c = heads * hd
    qkv = torch.randn(bw, 49, 3 * c, device=dev, generator=gen).to(dt)
    scale = torch.empty(heads, device=dev).uniform_(5.0, 20.0, generator=gen)
    bias16 = 16 * torch.sigmoid(torch.randn(heads, 49, 49, device=dev,
                                            generator=gen))
    g = torch.randn(bw, 49, c, device=dev, generator=gen).to(dt)
    mask = (torch.from_numpy(shifted_window_mask(14, 14, 7, 3)).to(dev)
            if masked else None)
    return qkv, scale, bias16, g, mask, nw


def tolerance(dtype, ref):
    """f32 5e-5·max(|ref|, 1) (sums in another order); bf16 two bf16 ulps
    of the largest |ref|."""
    mag = ref.abs().max().item()
    if dtype == "f32":
        return 5e-5 * max(mag, 1.0)
    return 2.0 * 2.0 ** (int(torch.tensor(mag).log2().floor()) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_perhead_kernels_match_plain_versions_on_card(cuda_device, shape,
                                                      dtype):
    dt = DTYPES[dtype]
    qkv, scale, bias16, g, mask, nw = attention_inputs(CARD_SHAPES[shape],
                                                       dt, cuda_device)
    heads = scale.shape[0]
    counts = (F.fused_window_attention.launches,
              F.fused_window_attention.backward_launches)
    q = qkv.clone().requires_grad_(True)
    s = scale.clone().requires_grad_(True)
    b = bias16.clone().requires_grad_(True)
    out = F.fused_window_attention(q, s, b, heads, nw, mask, out_dtype=dt)
    out.backward(g)
    torch.cuda.synchronize()
    assert (F.fused_window_attention.launches,
            F.fused_window_attention.backward_launches) == \
        (counts[0] + 1, counts[1] + 1)
    ref = F.window_attention_reference(qkv, scale, bias16, heads, mask, dt)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= \
        tolerance(dtype, ref.float())
    ref_grads = F.window_attention_backward_reference(qkv, scale, bias16, g,
                                                      heads, mask)
    for name, a, r in zip(("dqkv", "dscale", "dbias"),
                          (q.grad, s.grad, b.grad), ref_grads):
        assert torch.isfinite(a.float()).all(), name
        err = (a.float() - r.float()).abs().max().item()
        assert err <= tolerance(dtype, r.float()), (name, err)


@pytest.mark.cuda
def test_no_grad_call_runs_the_forward_alone(cuda_device):
    qkv, scale, bias16, _, mask, nw = attention_inputs(
        CARD_SHAPES["effialter_m_s6"], torch.bfloat16, cuda_device)
    before = (F.fused_window_attention.launches,
              F.fused_window_attention.stats_launches)
    with torch.no_grad():
        F.fused_window_attention(qkv, scale, bias16, 8, nw, mask,
                                 stored_stats=True)
    torch.cuda.synchronize()
    assert (F.fused_window_attention.launches,
            F.fused_window_attention.stats_launches) == \
        (before[0] + 1, before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_perhead_entry_takes_the_route_of_its_dtype(cuda_device, shape,
                                                    dtype):
    """Under autograd at the Swin50 and EffiAlter_m shapes (N 49, head dims
    32 and 38), bf16 runs the forward and the backward on the tensor cores
    and f32 on the CUDA cores: one launch each on that route's counters,
    none on the other's."""
    dt = DTYPES[dtype]
    qkv, scale, bias16, g, mask, nw = attention_inputs(CARD_SHAPES[shape],
                                                       dt, cuda_device, 1)
    body = "tensor_cores" if dtype == "bf16" else "cuda_cores"
    q = qkv.clone().requires_grad_(True)
    _, moved = routes_moved(lambda: F.fused_window_attention(
        q, scale, bias16, scale.shape[0], nw, mask, out_dtype=dt).backward(g))
    torch.cuda.synchronize()
    assert moved == {f"fwd_{body}": 1, f"bwd_{body}": 1}
    assert torch.isfinite(q.grad.float()).all()
