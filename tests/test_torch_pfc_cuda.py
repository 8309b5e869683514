"""The Hopper margin-softmax CE kernels against their plain PyTorch versions,
on the card. Imports no jax, so it also runs on a machine without it:

    python -m pytest tests/test_torch_pfc_cuda.py --noconftest -q

Without a CUDA device every test skips with its reason.

Tolerances: the plain version computes the logits as an f32 cuBLAS product
of the same rounded operands (TF32 off) and sums in another order, so the
logits differ by f32 rounding, which ×s = 30 and the exponential turn into
~1e-5 relative differences. Statistics rtol 1e-4; gradients, norm-wise,
‖kernel − plain‖ ≤ 1e-4·‖plain‖ in f32 and 1e-2 in bf16 (there coeff is
rounded to bf16 before the products, and a rounding flip moves an element
by one bf16 ulp, 2⁻⁸ relative)."""

import math

import pytest
import torch

from fr_tpu_torch.heads.partial_fc import PFCConfig, shard_softmax_ce
from fr_tpu_torch.ops import fused_pfc

# ms1m_arcface_122: b = 128, emd 512, int(0.3·86,690) sampled columns
FULL = (128, 512, 26007)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(n, d, k, dt, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def unit(*shape):
        x = torch.randn(*shape, device=dev, generator=gen)
        return (x / x.norm(dim=1, keepdim=True)).to(dt)

    emb, w = unit(n, d), unit(k, d)
    labels = torch.randint(-1, k - 3, (n,), device=dev, generator=gen)
    col_valid = torch.arange(k, device=dev) < k - 3
    g = torch.rand(n, device=dev, generator=gen) + 0.5
    return emb, w, labels, col_valid, g


def _cfg(margin, dt):
    return PFCConfig(num_classes=100000, embedding_size=8, margin=margin,
                     s=30.0, m=0.35, mixed_precision=dt == torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("margin,shape,dt", [
    ("ArcFace", FULL, torch.bfloat16), ("ArcFace", FULL, torch.float32),
    ("CosFace", FULL, torch.bfloat16), ("ArcFace", (10, 40, 131),
                                        torch.float32)],
    ids=["arc-full-bf16", "arc-full-f32", "cos-full-bf16", "arc-ragged-f32"])
def test_kernels_match_plain_versions_on_card(cuda_device, margin, shape, dt):
    n, d, k = shape
    emb, w, labels, col_valid, g = _problem(n, d, k, dt, cuda_device)
    cfg = _cfg(margin, dt)
    counts = [f.launches for f in (fused_pfc.margin_ce_stats,
                                   fused_pfc.margin_ce_grad_emb,
                                   fused_pfc.margin_ce_grad_w)]
    stats = fused_pfc.margin_ce_stats(emb, w, labels, col_valid, cfg)
    ref = fused_pfc.margin_ce_stats_reference(emb, w, labels, col_valid, cfg)
    for a, b in zip(stats, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=0)
    m, dd, _ = ref
    ge = fused_pfc.margin_ce_grad_emb(emb, w, labels, col_valid, m, dd, g,
                                      cfg)
    gw = fused_pfc.margin_ce_grad_w(emb, w, labels, col_valid, m, dd, g, cfg)
    torch.cuda.synchronize()
    assert [f.launches for f in (fused_pfc.margin_ce_stats,
                                 fused_pfc.margin_ce_grad_emb,
                                 fused_pfc.margin_ce_grad_w)] == \
        [c + 1 for c in counts]
    rge, rgw = fused_pfc.margin_ce_backward_reference(
        emb, w, labels, col_valid, m, dd, g, cfg)
    tol = 1e-4 if dt == torch.float32 else 1e-2
    for name, a, b in (("grad_emb", ge, rge), ("grad_w", gw, rgw)):
        assert torch.isfinite(a).all(), name
        assert (a - b).norm() <= tol * b.norm(), (name, (a - b).norm().item(),
                                                  b.norm().item())


@pytest.mark.cuda
def test_fused_ce_under_autograd_matches_plain_ce_on_card(cuda_device):
    """bf16, the ms1m shapes: loss and both gradients of the fused path
    against the plain CE (which rounds its logits nowhere)."""
    n, d, k = FULL
    emb, w, labels, col_valid, _ = _problem(n, d, k, torch.float32,
                                            cuda_device, seed=1)
    out = []
    for fused in (False, True):
        cfg = PFCConfig(num_classes=k, embedding_size=d, margin="ArcFace",
                        s=30.0, m=0.35, mixed_precision=True,
                        use_fused=fused)
        e = emb.clone().requires_grad_(True)
        ww = (0.05 * w).requires_grad_(True)
        loss = shard_softmax_ce(cfg, e, labels, ww, col_valid).mean()
        loss.backward()
        out.append((loss.item(), e.grad, ww.grad))
    (lp, gep, gwp), (lf, gef, gwf) = out
    assert math.isclose(lf, lp, rel_tol=1e-4)
    assert (gef - gep).norm() <= 1e-2 * gep.norm()
    assert (gwf - gwp).norm() <= 1e-2 * gwp.norm()


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda_device):
    emb, w, labels, col_valid, _ = _problem(8, 16, 40, torch.float32,
                                            cuda_device)
    with pytest.raises(ValueError, match="label_cols must be"):
        fused_pfc.margin_ce_stats(emb, w, labels[:4], col_valid,
                                  _cfg("ArcFace", torch.float32))
    with pytest.raises(ValueError, match="no kernel for margin"):
        fused_pfc.margin_ce_stats(emb, w, labels, col_valid,
                                  _cfg("SphereFace", torch.float32))
