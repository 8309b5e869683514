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
by one bf16 ulp, 2⁻⁸ relative).

The plain CE (use_fused off) runs on the same kernels on the card, with the
backward's coefficient as two bf16 terms: it is held to the plain CE in
PyTorch (per-sample loss 1e-4 relative, its bf16 gradients 2⁻⁸ norm-wise),
and its two-term products to float64 products of the f32 coefficient
(1e-4 norm-wise, where one term reads about 1e-3)."""

import math

import pytest
import torch

from fr_tpu_torch.heads.partial_fc import (PFCConfig, label_columns,
                                           sample_groups, shard_group_masks,
                                           shard_softmax_ce)
from fr_tpu_torch.models.common import l2_normalize
from fr_tpu_torch.ops import fused_pfc
from fr_tpu_torch.ops.sparse_rows import expand_group_index

# ms1m_arcface_122: b = 128, emd 512, int(0.3·86,690) sampled columns
FULL = (128, 512, 26007)
# webface42m at sample_block 64: 3,218 groups of 64 drawn per step
WEBFACE = (128, 512, 205952)
CE_STATS_RTOL = 1e-4   # m, d and t elementwise, as chip_smoke.py holds them


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
def test_fused_ce_under_autograd_matches_plain_ce_on_card(cuda_device,
                                                         monkeypatch):
    """bf16, the ms1m shapes: loss and both gradients of the fused path
    against the plain CE in PyTorch (which rounds its logits nowhere;
    plain_kernel_route is patched off so that it does not take the
    kernels)."""
    n, d, k = FULL
    emb, w, labels, col_valid, _ = _problem(n, d, k, torch.float32,
                                            cuda_device, seed=1)
    monkeypatch.setattr(fused_pfc, "plain_kernel_route",
                        lambda emb, cfg: False)
    routes = dict(shard_softmax_ce.routes)
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
    assert {key: v - routes.get(key, 0)
            for key, v in shard_softmax_ce.routes.items()
            if v != routes.get(key, 0)} == {"plain_torch": 1, "fused": 1}
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


def _webface_columns(dev, gen):
    """The labels' columns and the column mask of one webface42m step, made
    as the step makes them: 128 labels over the 2,059,906 classes (one in
    the partly padded last group, so that 62 columns are masked), the
    groups drawn for them and the expanded index."""
    cfg = PFCConfig(2059906, 512, sample_rate=0.1, sample_block=64)
    labels = torch.randint(0, cfg.num_classes, (WEBFACE[0],), device=dev,
                           generator=gen)
    labels[0] = cfg.num_classes - 1
    gidx = sample_groups(cfg, gen, *shard_group_masks(cfg, 0, labels,
                                                      labels >= 0))
    idx = expand_group_index(gidx, cfg.sample_block)
    return label_columns(cfg, labels, idx), idx < cfg.num_classes


def _backward(emb, w, labels, col_valid, m, d, g, cfg, terms=1):
    """(grad_emb, grad_W) and the bodies their launches took."""
    before = dict(fused_pfc.route_launches)
    ge = fused_pfc.margin_ce_grad_emb(emb, w, labels, col_valid, m, d, g,
                                      cfg, terms)
    gw = fused_pfc.margin_ce_grad_w(emb, w, labels, col_valid, m, d, g, cfg,
                                    terms)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in fused_pfc.route_launches.items()
             if v != before[k]}
    return ge, gw, moved


def _rel(a, b):
    return ((a - b).norm() / b.norm()).item()


# (N, D, K, scale): both heads; three 64-row tiles at ragged K; D = 48 with
# logits beyond [−1, 1] (rows ×1.5); one class tile
TC_SHAPES = [(*FULL, 1.0), (*WEBFACE, 1.0), (130, 512, 131, 1.0),
             (10, 48, 300, 1.5), (128, 512, 64, 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("margin", ["ArcFace", "CosFace"])
@pytest.mark.parametrize("shape", TC_SHAPES,
                         ids=lambda c: "x".join(map(str, c[:3])))
def test_tensor_core_pair_matches_plain_version_on_card(cuda_device, shape,
                                                        margin):
    """bf16: margin_ce_grad_emb_tc and margin_ce_grad_w_tc against the
    plain versions at 1e-2 norm-wise, each call on the tensor cores; two
    calls give the same bits; the same values in f32 take the CUDA-core
    pair and pass against the f32 plain versions at 1e-4. Labels −1,
    masked columns and a zero cotangent row (at the webface42m head: the
    step's own labels and column mask)."""
    n, d, k, scale = shape
    dt = torch.bfloat16
    emb, w, labels, col_valid, g = _problem(n, d, k, torch.float32,
                                            cuda_device, seed=7)
    emb, w = (scale * emb).to(dt), (scale * w).to(dt)
    if (n, d, k) == WEBFACE:
        gen = torch.Generator(device=cuda_device).manual_seed(8)
        labels, col_valid = _webface_columns(cuda_device, gen)
    g[min(5, n - 1)] = 0.0
    cfg = _cfg(margin, dt)
    args = (emb, w, labels, col_valid)
    m, dd, _ = fused_pfc.margin_ce_stats_reference(*args, cfg)
    ge, gw, moved = _backward(*args, m, dd, g, cfg)
    assert moved == {"grad_emb_tensor_cores": 1, "grad_w_tensor_cores": 1}
    rge, rgw = fused_pfc.margin_ce_backward_reference(*args, m, dd, g, cfg)
    for name, a, b in (("grad_emb", ge, rge), ("grad_w", gw, rgw)):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= 1e-2, (name, _rel(a, b))
    ge2, gw2, _ = _backward(*args, m, dd, g, cfg)
    assert torch.equal(ge, ge2) and torch.equal(gw, gw2)
    del ge2, gw2, rge, rgw
    args = (emb.float(), w.float(), labels, col_valid)
    cfg = _cfg(margin, torch.float32)
    m, dd, _ = fused_pfc.margin_ce_stats_reference(*args, cfg)
    cge, cgw, moved = _backward(*args, m, dd, g, cfg)
    assert moved == {"grad_emb_cuda_cores": 1, "grad_w_cuda_cores": 1}
    for name, a, b in zip(("grad_emb", "grad_w"), (cge, cgw),
                          fused_pfc.margin_ce_backward_reference(
                              *args, m, dd, g, cfg)):
        assert _rel(a, b) <= 1e-4, (name, _rel(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dt,d", [(torch.float32, 512),
                                  (torch.bfloat16, 40)], ids=["f32", "d40"])
def test_cuda_core_pair_takes_f32_and_other_widths_on_card(cuda_device, dt,
                                                           d):
    """f32 (its contract is f32 products, no TF32) and bf16 at D = 40 take
    the CUDA-core pair, and pass against the plain versions (1e-4 and 1e-2
    norm-wise)."""
    n, k = 130, 300
    emb, w, labels, col_valid, g = _problem(n, d, k, dt, cuda_device, seed=9)
    cfg = _cfg("ArcFace", dt)
    args = (emb, w, labels, col_valid)
    m, dd, _ = fused_pfc.margin_ce_stats_reference(*args, cfg)
    ge, gw, moved = _backward(*args, m, dd, g, cfg)
    assert moved == {"grad_emb_cuda_cores": 1, "grad_w_cuda_cores": 1}
    tol = 1e-4 if dt == torch.float32 else 1e-2
    for a, b in zip((ge, gw), fused_pfc.margin_ce_backward_reference(
            *args, m, dd, g, cfg)):
        assert _rel(a, b) <= tol


def _stats(emb, w, labels, col_valid, cfg):
    """(m, d, t) and the bodies the stats launch took."""
    before = dict(fused_pfc.route_launches)
    out = fused_pfc.margin_ce_stats(emb, w, labels, col_valid, cfg)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in fused_pfc.route_launches.items()
             if v != before[k]}
    return out, moved


def _loss(stats):
    m, d, t = stats
    return -torch.log(torch.clamp_min(t / d, 1e-30))


def _stats_close(a, b, rtol):
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=rtol, atol=0)
    # loss = log d − log t: to first order within the two relative errors
    assert (_loss(a) - _loss(b)).abs().max().item() <= 2 * rtol


# (N, D, K, scale): both heads; three 64-row tiles at a ragged K; D = 48
# with logits beyond [−1, 1] (rows ×1.5) and a last class tile of one
# class; one class tile
STATS_SHAPES = [(*FULL, 1.0), (*WEBFACE, 1.0), (130, 512, 131, 1.0),
                (10, 48, 65, 1.5), (128, 512, 64, 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("margin", ["ArcFace", "CosFace"])
@pytest.mark.parametrize("shape", STATS_SHAPES,
                         ids=lambda c: "x".join(map(str, c[:3])))
def test_tensor_core_stats_match_plain_version_on_card(cuda_device, shape,
                                                       margin):
    """bf16: margin_ce_stats_tc's m, d and t against the plain version at
    CE_STATS_RTOL elementwise, and the loss, the call on the tensor cores;
    two calls give the same bits; the same values in f32 take the
    CUDA-core kernel and pass the same check against the f32 plain
    version. Labels −1 and masked columns (at the webface42m head: the
    step's own labels and column mask)."""
    n, d, k, scale = shape
    dt = torch.bfloat16
    emb, w, labels, col_valid, _ = _problem(n, d, k, torch.float32,
                                            cuda_device, seed=12)
    emb, w = (scale * emb).to(dt), (scale * w).to(dt)
    if (n, d, k) == WEBFACE:
        gen = torch.Generator(device=cuda_device).manual_seed(13)
        labels, col_valid = _webface_columns(cuda_device, gen)
    cfg = _cfg(margin, dt)
    args = (emb, w, labels, col_valid)
    ref = fused_pfc.margin_ce_stats_reference(*args, cfg)
    tc, moved = _stats(*args, cfg)
    assert moved == {"stats_tensor_cores": 1}
    assert all(bool(torch.isfinite(x).all()) for x in tc)
    _stats_close(tc, ref, CE_STATS_RTOL)
    again, _ = _stats(*args, cfg)
    assert all(torch.equal(a, b) for a, b in zip(tc, again))
    args = (emb.float(), w.float(), labels, col_valid)
    cfg = _cfg(margin, torch.float32)
    cc, moved = _stats(*args, cfg)
    assert moved == {"stats_cuda_cores": 1}
    _stats_close(cc, fused_pfc.margin_ce_stats_reference(*args, cfg),
                 CE_STATS_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dt,d", [(torch.float32, 512),
                                  (torch.bfloat16, 40)], ids=["f32", "d40"])
def test_cuda_core_stats_take_f32_and_other_widths_on_card(cuda_device, dt,
                                                           d):
    """f32 (its contract is f32 products, no TF32) and bf16 at D = 40 take
    margin_ce_stats_kernel, and pass against the plain version at
    CE_STATS_RTOL."""
    emb, w, labels, col_valid, _ = _problem(130, d, 300, dt, cuda_device,
                                            seed=14)
    cfg = _cfg("ArcFace", dt)
    stats, moved = _stats(emb, w, labels, col_valid, cfg)
    assert moved == {"stats_cuda_cores": 1}
    _stats_close(stats, fused_pfc.margin_ce_stats_reference(
        emb, w, labels, col_valid, cfg), CE_STATS_RTOL)


# The train cells' heads: (N, D, K, margin, s, m): vit_l_wf42m (b 384, 0.3
# of the table in 64-row groups) and r100_wf42m (b 256, 0.2) with CosFace
# s 64, m 0.4; alternet50_ms1m (b 128, int(0.3·86,690)) with ArcFace s 30,
# m 0.35
CELL_HEADS = [(384, 512, 617984, "CosFace", 64.0, 0.4),
              (256, 512, 411968, "CosFace", 64.0, 0.4),
              (128, 512, 26007, "ArcFace", 30.0, 0.35)]


def _cell_head(n, d, k, dev, seed):
    """f32 unit embeddings and table rows as the step passes them (the rows
    0.01·randn, as init_pfc_state draws them), every label among the
    columns, half the labels' rows planted at a cosine near 0.6 with their
    embedding so that their softmax peaks, the last 40 columns masked."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    emb = l2_normalize(torch.randn(n, d, device=dev, generator=gen))
    w = 0.01 * torch.randn(k, d, device=dev, generator=gen)
    labels = torch.randperm(k - 40, device=dev, generator=gen)[:n]
    half = labels[: n // 2]
    noise = l2_normalize(torch.randn(n // 2, d, device=dev, generator=gen))
    w[half] = 0.01 * l2_normalize(0.6 * emb[: n // 2] + 0.8 * noise)
    col_valid = torch.arange(k, device=dev) < k - 40
    return emb, w, labels, col_valid


@pytest.mark.cuda
@pytest.mark.parametrize("head", CELL_HEADS, ids=lambda h: f"{h[3]}-K{h[2]}")
def test_plain_route_on_kernels_matches_plain_torch_on_card(
        cuda_device, monkeypatch, head):
    """The plain CE at each train cell's head: on the kernels (the route
    shard_softmax_ce takes on the card, counted on its routes, the stats
    and the two-term pair launched once each) against the same CE in plain
    PyTorch (plain_kernel_route patched off): per-sample loss within 1e-4
    relative, both gradients within 2⁻⁸ norm-wise."""
    n, d, k, margin, s, m = head
    emb, w, labels, col_valid = _cell_head(n, d, k, cuda_device, seed=31)
    cfg = PFCConfig(num_classes=k, embedding_size=d, margin=margin, s=s,
                    m=m, mixed_precision=True)
    out = []
    for kernels in (True, False):
        if not kernels:
            monkeypatch.setattr(fused_pfc, "plain_kernel_route",
                                lambda emb, cfg: False)
        routes = dict(shard_softmax_ce.routes)
        launches = dict(fused_pfc.route_launches)
        e, ww = emb.clone().requires_grad_(True), w.clone().requires_grad_(True)
        loss = shard_softmax_ce(cfg, e, labels, ww, col_valid)
        loss.mean().backward()
        torch.cuda.synchronize()
        route = "plain_kernels" if kernels else "plain_torch"
        assert shard_softmax_ce.routes[route] == routes.get(route, 0) + 1
        moved = {key: v - launches[key]
                 for key, v in fused_pfc.route_launches.items()
                 if v != launches[key]}
        assert moved == ({"stats_tensor_cores": 1,
                          "grad_emb_tensor_cores_2term": 1,
                          "grad_w_tensor_cores_2term": 1} if kernels else {})
        out.append((loss.detach(), e.grad, ww.grad))
    (lk, gek, gwk), (lp, gep, gwp) = out
    assert bool(torch.isfinite(lk).all()) and float(lp.min()) > 0.1
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=0)
    for name, a, b in (("grad_emb", gek, gep), ("grad_w", gwk, gwp)):
        assert _rel(a, b) <= 2 ** -8, (name, _rel(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("head", CELL_HEADS, ids=lambda h: f"{h[3]}-K{h[2]}")
def test_two_term_products_match_float64_on_card(cuda_device, head):
    """The tensor-core pair's f32 outputs with two coefficient terms lie
    within 1e-4 norm-wise of float64 products of the f32 coefficient; with
    one term (the coefficient rounded to bf16) they lie beyond 3e-4 of
    them, so the second term is there. Bits repeat with two terms."""
    n, d, k, margin, s, m = head
    emb, w, labels, col_valid = _cell_head(n, d, k, cuda_device, seed=32)
    cfg = PFCConfig(num_classes=k, embedding_size=d, margin=margin, s=s,
                    m=m, mixed_precision=True)
    ne = emb.to(torch.bfloat16)
    nw = l2_normalize(w).to(torch.bfloat16)
    args = (ne, nw, labels, col_valid)
    md, dd, _ = fused_pfc.margin_ce_stats_reference(*args, cfg)
    g = torch.full((n,), 1.0 / n, device=cuda_device)
    coeff = fused_pfc.margin_ce_coeff_reference(*args, md, dd, g,
                                                cfg).double()
    ref = (coeff @ nw.double(), coeff.t() @ ne.double())
    del coeff
    err = {}
    for terms in (1, 2):
        ge, gw, moved = _backward(*args, md, dd, g, cfg, terms)
        suffix = "_2term" if terms == 2 else ""
        assert moved == {f"grad_emb_tensor_cores{suffix}": 1,
                         f"grad_w_tensor_cores{suffix}": 1}
        err[terms] = [_rel(a.double(), b) for a, b in zip((ge, gw), ref)]
        if terms == 2:
            ge2, gw2, _ = _backward(*args, md, dd, g, cfg, terms)
            assert torch.equal(ge, ge2) and torch.equal(gw, gw2)
    assert max(err[2]) <= 1e-4 and min(err[1]) >= 3e-4, err
