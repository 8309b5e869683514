"""The stored-stats window-attention kernels (csrc/window_attn_stats.cu,
serving fr_tpu's _fwd_stats_pallas / _bwd_stats_pallas and
_pk_fwd_stats_pallas / _pk_bwd_stats_pallas) on the card: against their
plain PyTorch versions and against the recompute kernels' outputs, at the
Swin50 / EffiAlter_m shapes and the AlterNet50 packed shapes; their sums are
the same bit for bit on every run; both entries' stats arms launch them.
Imports no jax:

    python -m pytest tests/test_torch_window_attn_stats_cuda.py --noconftest -q

Without a CUDA device every test skips with its reason."""

import pytest
import torch

from fr_tpu_torch.models.swin_common import shifted_window_mask
from fr_tpu_torch.ops import fused_window_attn as F
from test_torch_window_attn_perhead_cuda import (CARD_SHAPES, DTYPES,
                                                 attention_inputs, tolerance)

# AlterNet50 at 192 px, b = 128: (B·nW, N, heads, resolution, window)
PACKED_SHAPES = {"alternet50_s2": (2048, 36, 4, 24, 6),
                 "alternet50_s3": (512, 36, 8, 12, 6),
                 "alternet50_s4": (512, 9, 16, 6, 3)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _packed_inputs(shape, dt, dev):
    bw, n, heads, res, ws = shape
    gen = torch.Generator(device=dev).manual_seed(bw + n)
    c = heads * 32
    qkv = torch.randn(bw, n, 3 * c, device=dev, generator=gen).to(dt)
    scale = torch.empty(heads, device=dev).uniform_(5.0, 20.0, generator=gen)
    bias16 = 16 * torch.sigmoid(torch.randn(heads, n, n, device=dev,
                                            generator=gen))
    g = torch.randn(bw, n, c, device=dev, generator=gen).to(dt)
    mask = torch.from_numpy(shifted_window_mask(res, res, ws, ws // 2)
                            ).to(dev)
    return qkv, scale, bias16, g, mask, mask.shape[0]


def _inputs(name, dt, dev):
    if name in CARD_SHAPES:
        return attention_inputs(CARD_SHAPES[name], dt, dev, seed=1)
    return _packed_inputs(PACKED_SHAPES[name], dt, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(CARD_SHAPES) + list(PACKED_SHAPES))
def test_stats_kernels_match_plain_and_recompute(cuda_device, shape, dtype):
    dt = DTYPES[dtype]
    qkv, scale, bias16, g, mask, nw = _inputs(shape, dt, cuda_device)
    heads = scale.shape[0]
    counters = [(F.window_attention_forward_stats, "launches"),
                (F.window_attention_backward_stats, "launches"),
                (F.fused_window_attention, "stats_launches"),
                (F.fused_window_attention_packed, "stats_launches")]
    before = [getattr(f, a) for f, a in counters]
    out, p = F.window_attention_forward_stats(qkv, scale, bias16, heads, nw,
                                              mask, out_dtype=dt)
    grads = F.window_attention_backward_stats(qkv, scale, p, g, heads)
    torch.cuda.synchronize()
    # direct calls count on the wrappers' own counters, not the entries'
    assert [getattr(f, a) - b for (f, a), b in zip(counters, before)] == \
        [1, 1, 0, 0]
    ref_out, ref_p = F.window_attention_forward_stats_reference(
        qkv, scale, bias16, heads, mask, dt)
    assert (out.float() - ref_out.float()).abs().max().item() <= \
        tolerance(dtype, ref_out.float())
    assert_p_close(p, ref_p, dtype)
    plain = F.window_attention_backward_stats_reference(qkv, scale, ref_p,
                                                        g, heads)
    recompute = F.window_attention_backward(qkv, scale, bias16, g, heads,
                                            nw, mask)
    torch.cuda.synchronize()
    for name, a, r, k in zip(("dqkv", "dscale", "dbias"), grads, plain,
                             recompute):
        assert torch.isfinite(a.float()).all(), name
        for other in (r, k):
            assert_grad_close(name, a, other, dtype)


def assert_p_close(p, ref, dtype):
    """f32 max-abs 1e-5; bf16 norm-wise 1e-3: where the card's rsqrt and
    the plain version's differ in the last f32 digit, q̂ or k̂ can round to
    the neighbouring bf16 value and move a score by up to scale·2⁻⁸
    (measured up to 3.0e-3 max-abs over 10⁷ probabilities)."""
    if dtype == "f32":
        assert (p - ref).abs().max().item() <= 1e-5
    else:
        assert ((p - ref).norm() / ref.norm()).item() <= 1e-3


def assert_grad_close(name, a, ref, dtype):
    """f32: max-abs tolerance(); bf16: norm-wise 1e-2, and dscale max-abs
    3e-2·max(|ref|, 1) as fr_tpu's own stored-stats test holds it: the
    row-sum identity takes dscale from bf16-rounded ds·scale, a sum whose
    rows cancel (Σ_c ds = 0)."""
    a, ref = a.float(), ref.float()
    if dtype == "f32":
        err = (a - ref).abs().max().item()
        assert err <= tolerance(dtype, ref), (name, err)
    elif name == "dscale":
        err = (a - ref).abs().max().item()
        assert err <= 3e-2 * max(ref.abs().max().item(), 1.0), (name, err)
    else:
        rel = ((a - ref).norm() / ref.norm()).item()
        assert rel <= 1e-2, (name, rel)


@pytest.mark.cuda
def test_stats_backward_sums_are_deterministic(cuda_device):
    qkv, scale, bias16, g, mask, nw = _inputs("swin50_s3_masked",
                                              torch.bfloat16, cuda_device)
    _, p = F.window_attention_forward_stats(qkv, scale, bias16, 8, nw, mask)
    first = F.window_attention_backward_stats(qkv, scale, p, g, 8)
    for _ in range(3):
        again = F.window_attention_backward_stats(qkv, scale, p, g, 8)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("entry,shape", [
    (F.fused_window_attention, "swin50_s4"),
    (F.fused_window_attention_packed, "alternet50_s4")],
    ids=["per_head", "packed"])
def test_both_entries_stats_arms_launch_the_stats_kernels(cuda_device,
                                                          entry, shape):
    qkv, scale, bias16, g, mask, nw = _inputs(shape, torch.bfloat16,
                                              cuda_device)
    qkv.requires_grad_(True)
    before = (entry.stats_launches, entry.stats_backward_launches)
    out = entry(qkv, scale, bias16, scale.shape[0], nw, mask,
                out_dtype=torch.bfloat16, stored_stats=True)
    out.backward(g)
    torch.cuda.synchronize()
    assert (entry.stats_launches, entry.stats_backward_launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.isfinite(qkv.grad.float()).all()
