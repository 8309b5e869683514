"""The Hopper kernels of the attention variants against their plain PyTorch
versions, on the card: the spatial forward and backward
(csrc/window_attn_spatial.cu; in bf16 the tensor-core kernels of
window_attn_tc.cuh on the spatial row layout), the entry-fused forward
(csrc/window_attn_qkv.cu: in bf16 the tensor-core body, and the
CUDA-core one in f32 and off the tile) and all-in-kernel backward, and the
grouped route of
the packed entry (the row-1 and row-2 kernels at the grouped shapes). Imports no jax,
so it also runs on a machine without it:

    python -m pytest tests/test_torch_window_attn_variants_cuda.py \
        --noconftest -q

(--noconftest: tests/conftest.py sets jax up). Without a CUDA device every
test skips with its reason.

Tolerances: outputs f32 5e-5·max(|ref|, 1), bf16 two bf16 ulps at |x| < 4
(3.2e-2); gradients f32 5e-5·max(|ref|, 1) element-wise, and for dW and db
(sums over every token row, in another order) 1e-5 norm-wise; bf16
gradients 1e-2 norm-wise, dscale 3e-2·max(|ref|, 1): a bf16 rounding of q̂,
k̂ or of the projection's qkv flips where the kernel's f32 sums and the
plain version's differ in the last digit."""

import pytest
import torch

from fr_tpu_torch.models.swin_common import shifted_window_mask
from fr_tpu_torch.ops import fused_window_attn as F
from fr_tpu_torch.ops import fused_window_attn_variants as V
from test_torch_window_attn_cuda import routes_moved

# AlterNet50 at 192 px, b = 128 images: (resolution, window, heads)
ALTERNET50 = [(24, 6, 4), (12, 6, 8), (6, 3, 16)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(heads, N, dev, gen):
    scale = torch.empty(heads, device=dev).uniform_(5.0, 20.0, generator=gen)
    bias16 = 16 * torch.sigmoid(torch.randn(heads, N, N, device=dev,
                                            generator=gen))
    return scale, bias16


def _mask(res, ws, masked, dev):
    return (torch.from_numpy(shifted_window_mask(res, res, ws, ws // 2))
            .to(dev) if masked else None)


def _assert_out(out, ref, dtype):
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    tol = (5e-5 * max(ref.float().abs().max().item(), 1.0)
           if dtype == "f32" else 3.2e-2)
    assert err <= tol, (err, tol)


def _assert_grads(names, ours, ref, dtype, sums=("dw", "db")):
    for name, a, b in zip(names, ours, ref):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all(), name
        if dtype == "bf16" and name == "dscale":
            err = (a - b).abs().max().item()
            assert err <= 3e-2 * max(b.abs().max().item(), 1.0), (name, err)
        elif dtype == "bf16" or name in sums:
            err = ((a - b).norm() / b.norm()).item()
            assert err <= (1e-2 if dtype == "bf16" else 1e-5), (name, err)
        else:
            err = (a - b).abs().max().item()
            assert err <= 5e-5 * max(b.abs().max().item(), 1.0), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", ALTERNET50 + [(14, 7, 8)],
                         ids=lambda s: f"r{s[0]}ws{s[1]}h{s[2]}")
def test_spatial_kernels_match_plain_versions(cuda_device, shape, masked,
                                              dtype):
    """qkv (128, H, W, 3C) at the AlterNet50 shapes and a Swin50-like ws-7
    one: the forward (f32 out) and the backward, launched once each."""
    res, ws, heads = shape
    dev, dt = cuda_device, DTYPES[dtype]
    gen = torch.Generator(device=dev).manual_seed(res + heads)
    C = heads * 32
    qkv = torch.randn(128, res, res, 3 * C, device=dev, generator=gen).to(dt)
    scale, bias16 = _params(heads, ws * ws, dev, gen)
    g = torch.randn(128, res, res, C, device=dev, generator=gen)
    mask = _mask(res, ws, masked, dev)
    before = (V.fused_window_attention_spatial.launches,
              V.fused_window_attention_spatial.backward_launches)
    out = V.fused_window_attention_spatial(qkv, scale, bias16, heads, ws,
                                           mask)
    grads = V.spatial_attention_backward(qkv, scale, bias16, g, heads, ws,
                                         mask)
    torch.cuda.synchronize()
    assert (V.fused_window_attention_spatial.launches,
            V.fused_window_attention_spatial.backward_launches) == (
                before[0] + 1, before[1] + 1)
    assert out.dtype == torch.float32 and grads[0].dtype == dt
    _assert_out(out, V.window_attention_spatial_reference(
        qkv, scale, bias16, heads, ws, mask), dtype)
    _assert_grads(("dqkv", "dscale", "dbias"), grads,
                  V.window_attention_spatial_backward_reference(
                      qkv, scale, bias16, g, heads, ws, mask), dtype)


def _entry_inputs(res, ws, heads, masked, dt, dev, seed, hd=32):
    gen = torch.Generator(device=dev).manual_seed(seed)
    N, C = ws * ws, heads * hd
    nw = (res // ws) ** 2
    x = torch.randn(128 * nw, N, C, device=dev, generator=gen).to(dt)
    # qkv ~ N(0, 1), the scale rows 1/2 are held at: the bf16 tolerance is
    # two ulps at |out| < 4 (0.1·randn put out at up to 11 at C = 512,
    # where one ulp is 6.25e-2)
    w = torch.randn(3 * C, C, device=dev, generator=gen) / C ** 0.5
    b = 0.1 * torch.randn(3 * C, device=dev, generator=gen)
    scale, bias16 = _params(heads, N, dev, gen)
    g = torch.randn(128 * nw, N, C, device=dev, generator=gen).to(dt)
    mask = _mask(res, ws, masked, dev)
    return x, w, b, scale, bias16, g, mask, (nw if masked else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", ALTERNET50,
                         ids=lambda s: f"r{s[0]}ws{s[1]}h{s[2]}")
def test_entry_fused_kernels_match_plain_versions(cuda_device, shape, masked,
                                                  dtype):
    """x (B·nW, N, C) at the AlterNet50 shapes: the forward and the
    all-in-kernel backward (dx, dW, db, dscale, dbias); the backward takes
    the tensor-core body in bf16 and the CUDA-core one in f32."""
    res, ws, heads = shape
    dt = DTYPES[dtype]
    x, w, b, scale, bias16, g, mask, nw = _entry_inputs(
        res, ws, heads, masked, dt, cuda_device, seed=res + heads)
    before = (V.fused_window_attention_packed_qkv.launches,
              V.fused_window_attention_packed_qkv.backward_launches)
    out = V.fused_window_attention_packed_qkv(x, w, b, scale, bias16, heads,
                                              nw, mask, out_dtype=dt)
    grads, moved = routes_moved(lambda: V.qkv_attention_backward(
        x, w, b, scale, bias16, g, heads, nw, mask))
    torch.cuda.synchronize()
    assert moved == {"bwd_tensor_cores" if dtype == "bf16"
                     else "bwd_cuda_cores": 1}
    assert (V.fused_window_attention_packed_qkv.launches,
            V.fused_window_attention_packed_qkv.backward_launches) == (
                before[0] + 1, before[1] + 1)
    _assert_out(out, V.window_attention_qkv_reference(
        x, w, b, scale, bias16, heads, mask, dt), dtype)
    assert grads[0].dtype == dt and grads[1].shape == w.shape
    _assert_grads(("dx", "dw", "db", "dscale", "dbias"), grads,
                  V.window_attention_qkv_backward_reference(
                      x, w, b, scale, bias16, g, heads, mask), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_entry_fused_backward_at_an_odd_head_dim(cuda_device, masked):
    """Head dim 38 (N 49, C 304, 8 heads): the tensor-core backward with
    padded head columns and 4-byte copies of g, against the plain
    version."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(38)
    N, C, heads, nw = 49, 304, 8, 4
    x = torch.randn(32 * nw, N, C, device=dev, generator=gen).to(
        torch.bfloat16)
    w = torch.randn(3 * C, C, device=dev, generator=gen) / C ** 0.5
    b = 0.1 * torch.randn(3 * C, device=dev, generator=gen)
    scale, bias16 = _params(heads, N, dev, gen)
    g = torch.randn(32 * nw, N, C, device=dev, generator=gen).to(
        torch.bfloat16)
    mask = _mask(14, 7, masked, dev)
    grads, moved = routes_moved(lambda: V.qkv_attention_backward(
        x, w, b, scale, bias16, g, heads, nw if masked else 1, mask))
    torch.cuda.synchronize()
    assert moved == {"bwd_tensor_cores": 1}
    _assert_grads(("dx", "dw", "db", "dscale", "dbias"), grads,
                  V.window_attention_qkv_backward_reference(
                      x, w, b, scale, bias16, g, heads, mask), "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", ALTERNET50 + [(12, 6, 4, 18)],
                         ids=lambda s: f"r{s[0]}ws{s[1]}h{s[2]}"
                         + (f"hd{s[3]}" if len(s) > 3 else ""))
def test_entry_fused_backward_cuda_cores_bf16(cuda_device, shape, masked):
    """The bf16 all-in-kernel backward on the CUDA-core body, one launch on
    route_launches["bwd_cuda_cores"], against the plain version, off the
    tensor-core tile: at the AlterNet50 windows with an odd head dim (33),
    and at C = 72 (N 36, head dim 18: C % 16 != 0)."""
    res, ws, heads, *hd = shape
    x, w, b, scale, bias16, g, mask, nw = _entry_inputs(
        res, ws, heads, masked, torch.bfloat16, cuda_device,
        seed=3 * res + heads, hd=hd[0] if hd else 33)
    grads, moved = routes_moved(lambda: V.qkv_attention_backward(
        x, w, b, scale, bias16, g, heads, nw, mask))
    torch.cuda.synchronize()
    assert moved == {"bwd_cuda_cores": 1}
    assert grads[0].dtype == torch.bfloat16
    _assert_grads(("dx", "dw", "db", "dscale", "dbias"), grads,
                  V.window_attention_qkv_backward_reference(
                      x, w, b, scale, bias16, g, heads, mask), "bf16")


@pytest.mark.cuda
def test_entry_fused_sums_are_deterministic(cuda_device):
    """dW, db, dscale and dbias come from fixed-order reductions over chunks
    and windows: the same bits on two runs."""
    x, w, b, scale, bias16, g, mask, nw = _entry_inputs(
        24, 6, 4, True, torch.bfloat16, cuda_device, seed=5)
    first = V.qkv_attention_backward(x, w, b, scale, bias16, g, 4, nw, mask)
    again = V.qkv_attention_backward(x, w, b, scale, bias16, g, 4, nw, mask)
    for a, c in zip(first, again):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("hybrid", [True, False])
def test_entry_fused_autograd_routes(cuda_device, monkeypatch, hybrid):
    """Under autograd the backward takes the route _PKX_HYBRID_BWD names:
    the row-2 kernel (hybrid) or the all-in-kernel backward."""
    monkeypatch.setattr(V, "_PKX_HYBRID_BWD", hybrid)
    x, w, b, scale, bias16, g, mask, nw = _entry_inputs(
        6, 3, 16, True, torch.bfloat16, cuda_device, seed=6)
    leaves = [t.requires_grad_(True) for t in (x, w, b, scale, bias16)]
    counters = (F.window_attention_backward.launches,
                V.fused_window_attention_packed_qkv.backward_launches)
    V.fused_window_attention_packed_qkv(*leaves, 16, nw, mask,
                                        out_dtype=torch.bfloat16).backward(g)
    torch.cuda.synchronize()
    after = (F.window_attention_backward.launches,
             V.fused_window_attention_packed_qkv.backward_launches)
    assert after == (counters[0] + hybrid, counters[1] + (not hybrid))
    assert all(torch.isfinite(t.grad).all() for t in leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(512, 8, 4), (128, 16, 1)],
                         ids=["swin50_s3", "swin50_s4"])
def test_grouped_route_on_card(cuda_device, shape, masked):
    """The packed entry with head_group 4 at Swin50's shapes: the row-1 and
    row-2 kernels, counted as rows 15/16, against the plain versions (bf16),
    and the stats arm stays off."""
    bw, heads, nw = shape
    if masked and nw == 1:
        pytest.skip("the shift mask needs more than one window per image")
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(bw + heads)
    C = heads * 32
    qkv = torch.randn(bw, 49, 3 * C, device=dev, generator=gen).to(
        torch.bfloat16).requires_grad_(True)
    scale, bias16 = _params(heads, 49, dev, gen)
    g = torch.randn(bw, 49, C, device=dev, generator=gen).to(torch.bfloat16)
    mask = _mask(14, 7, masked, dev)
    P = F.fused_window_attention_packed
    before = (P.grouped_launches, P.grouped_backward_launches,
              P.stats_launches)
    out = P(qkv, scale, bias16, heads, nw, mask, out_dtype=torch.bfloat16,
            stored_stats=True, head_group=4)
    out.backward(g)
    torch.cuda.synchronize()
    assert (P.grouped_launches, P.grouped_backward_launches,
            P.stats_launches) == (before[0] + 1, before[1] + 1, before[2])
    q = qkv.detach()
    _assert_out(out, F.window_attention_reference(q, scale, bias16, heads,
                                                  mask, torch.bfloat16),
                "bf16")
    ref = F.window_attention_backward_reference(q, scale, bias16, g, heads,
                                                mask)
    _assert_grads(("dqkv",), (qkv.grad,), ref[:1], "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(3, 24, 6, 4, 32), (5, 12, 6, 8, 32),
                                   (7, 6, 3, 16, 32), (3, 14, 7, 8, 38)],
                         ids=lambda s: f"B{s[0]}r{s[1]}ws{s[2]}hd{s[4]}")
def test_spatial_tensor_core_route(cuda_device, shape, masked):
    """bf16 on the spatial layout takes the tensor-core kernels (N 36, 9,
    49; head dims 32 and 38; image counts that leave ragged CTAs), one
    launch each on the tensor-core counters, and matches the plain
    versions."""
    B, res, ws, heads, hd = shape
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(B + res + hd)
    C = heads * hd
    qkv = torch.randn(B, res, res, 3 * C, device=dev, generator=gen).to(
        torch.bfloat16)
    scale, bias16 = _params(heads, ws * ws, dev, gen)
    g = torch.randn(B, res, res, C, device=dev, generator=gen)
    mask = _mask(res, ws, masked and res > ws, dev)
    (out, grads), moved = routes_moved(lambda: (
        V.fused_window_attention_spatial(qkv, scale, bias16, heads, ws, mask),
        V.spatial_attention_backward(qkv, scale, bias16, g, heads, ws,
                                     mask)))
    torch.cuda.synchronize()
    assert moved == {"fwd_tensor_cores": 1, "bwd_tensor_cores": 1}
    _assert_out(out, V.window_attention_spatial_reference(
        qkv, scale, bias16, heads, ws, mask), "bf16")
    _assert_grads(("dqkv", "dscale", "dbias"), grads,
                  V.window_attention_spatial_backward_reference(
                      qkv, scale, bias16, g, heads, ws, mask), "bf16")


@pytest.mark.cuda
def test_grouped_route_runs_on_tensor_cores(cuda_device):
    """The grouped route (rows 15/16) takes the tensor-core kernels in
    bf16: one forward and one backward launch on their counters."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(3)
    heads, C = 16, 512
    qkv = torch.randn(128, 49, 3 * C, device=dev, generator=gen).to(
        torch.bfloat16).requires_grad_(True)
    scale, bias16 = _params(heads, 49, dev, gen)
    g = torch.randn(128, 49, C, device=dev, generator=gen).to(torch.bfloat16)
    _, moved = routes_moved(lambda: F.fused_window_attention_packed(
        qkv, scale, bias16, heads, 1, out_dtype=torch.bfloat16,
        head_group=4).backward(g))
    torch.cuda.synchronize()
    assert moved == {"fwd_tensor_cores": 1, "bwd_tensor_cores": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", ALTERNET50,
                         ids=lambda s: f"r{s[0]}ws{s[1]}h{s[2]}")
def test_entry_fused_forward_tensor_cores(cuda_device, shape, masked,
                                          out_dtype):
    """bf16 x at the AlterNet50 shapes takes the tensor-core forward, one
    launch on route_launches["fwd_tensor_cores"], and matches the plain
    version in bf16 and f32 output; the same windows at an odd head dim
    (33), off the tile, take the CUDA-core body (one launch on
    "fwd_cuda_cores") and match theirs."""
    res, ws, heads = shape
    dt, odt = torch.bfloat16, DTYPES[out_dtype]
    for hd, body in ((32, "fwd_tensor_cores"), (33, "fwd_cuda_cores")):
        x, w, b, scale, bias16, _, mask, nw = _entry_inputs(
            res, ws, heads, masked, dt, cuda_device, seed=2 * res + heads,
            hd=hd)
        out, moved = routes_moved(lambda: V.fused_window_attention_packed_qkv(
            x, w, b, scale, bias16, heads, nw, mask, out_dtype=odt))
        torch.cuda.synchronize()
        assert moved == {body: 1}
        assert out.dtype == odt
        _assert_out(out, V.window_attention_qkv_reference(
            x, w, b, scale, bias16, heads, mask, odt), "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(49, 8, 38, True, True),
                                  (36, 4, 18, False, False),
                                  (81, 2, 32, False, False)],
                         ids=["N49hd38-tc", "C72-cuda_cores",
                              "N81-cuda_cores"])
def test_entry_fused_forward_route_by_shape(cuda_device, case):
    """Head dim 38 at N 49 (both padded: 64 × 48 tiles) stays on the tensor
    cores; C = 72 (C % 16 != 0) and N = 81 (beyond the 64-token tile) take
    the CUDA-core kernel and count there. Each matches the plain version
    (bf16, three images of windows with the mask, one without)."""
    N, heads, hd, masked, tc = case
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(N + hd)
    C, nw = heads * hd, (4 if masked else 1)
    x = torch.randn(3 * nw, N, C, device=dev, generator=gen).to(
        torch.bfloat16)
    w = torch.randn(3 * C, C, device=dev, generator=gen) / C ** 0.5
    b = 0.1 * torch.randn(3 * C, device=dev, generator=gen)
    scale, bias16 = _params(heads, N, dev, gen)
    mask = (torch.where(torch.rand(nw, N, N, device=dev, generator=gen) < 0.3,
                        -100.0, 0.0) if masked else None)
    out, moved = routes_moved(lambda: V.fused_window_attention_packed_qkv(
        x, w, b, scale, bias16, heads, nw, mask, out_dtype=torch.bfloat16))
    torch.cuda.synchronize()
    assert moved == {"fwd_tensor_cores" if tc else "fwd_cuda_cores": 1}
    _assert_out(out, V.window_attention_qkv_reference(
        x, w, b, scale, bias16, heads, mask, torch.bfloat16), "bf16")
