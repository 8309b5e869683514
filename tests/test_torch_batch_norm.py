"""BatchNorm of the port (ops/batch_norm.py) in two parts.

On the CPU, the plain version against fr_tpu's flax BatchNorm on the same
numpy inputs: outputs, running statistics after two steps and the gradients
of x, γ and β (``jax.vjp``), in bf16 and f32, training and eval, BN2d on
channels_last and NCHW inputs and BN1d. jax is imported inside those tests
only.

On the card (``cuda`` marker; skipped without a CUDA device), the kernels
of csrc/batch_norm.cu against the plain version at every BatchNorm shape of
IR-ResNet100 at batch 256 and 112 px and of AlterNet50 at batch 128 and
192 px, and at small shapes that take the scalar path, a partial slab, a
misaligned view and an NCHW input. Imports no jax, so it also runs on a
machine without it:

    python -m pytest tests/test_torch_batch_norm.py --noconftest -q

Tolerances on the card, in the working type. The kernel's f32 statistics
(Welford and Chan) and cuDNN's differ by f32 rounding, ~1e-6 of the data's
scale, so the f32 values before the output's rounding differ by about that:
  - y and dx: |kernel − plain| ≤ rtol·|plain| + 1e-5·max|plain|, rtol 2⁻⁷
    in bf16 (an f32 difference that straddles a rounding point flips the
    output by one bf16 ulp, at most 2⁻⁷ of it) and 1e-5 in f32;
  - dγ and dβ (f32 sums over M rows in another order): within
    1e-5·Σ|term| of each channel, the f32 summation error's scale;
  - the running mean and variance: 1e-5 relative and absolute;
  - two runs of the kernels: equal bits.
"""

import numpy as np
import pytest
import torch

from fr_tpu_torch.models.common import (BatchNorm1d, BatchNorm2d,
                                        _FlaxBatchNorm)
from fr_tpu_torch.ops import batch_norm as bn_ops
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

EPS, MOMENTUM = 1e-5, 0.1

# ---------------------------------------------------------------------------
# CPU: the plain version against flax
# ---------------------------------------------------------------------------

# (shape as torch takes it, layout): BN2d channels_last, BN2d NCHW, BN1d
CPU_CASES = {"bn2d-channels_last": ((4, 16, 5, 5), "channels_last"),
             "bn2d-nchw": ((4, 16, 5, 5), "nchw"),
             "bn1d": ((8, 24), "rows")}
# outputs and dx: an f32 difference across a rounding point flips one bf16
# ulp (≤ 2⁻⁷ relative); flax takes the variance as E[x²] − E[x]², torch by
# two passes, ~1e-6 apart at this scale
CPU_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
           torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}


def _flax_bn(x_nhwc, params, stats, g, training, dtype):
    """fr_tpu's BatchNorm on x (channels last, numpy f32 cast to dtype):
    (y, dx, dγ, dβ, new mean, new var) as numpy f32."""
    import jax
    import jax.numpy as jnp

    from fr_tpu.models.common import BatchNorm as JaxBatchNorm

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    bn = JaxBatchNorm()
    batch_stats = {"BatchNorm_0": {"mean": jnp.asarray(stats[0]),
                                   "var": jnp.asarray(stats[1])}}

    def f(x, scale, bias):
        variables = {"params": {"BatchNorm_0": {"scale": scale,
                                                "bias": bias}},
                     "batch_stats": batch_stats}
        y, upd = bn.apply(variables, x, use_running_average=not training,
                          mutable=["batch_stats"])
        return y, upd.get("batch_stats", batch_stats)["BatchNorm_0"]

    y, vjp, new_stats = jax.vjp(f, jnp.asarray(x_nhwc, dtype=jdt),
                                jnp.asarray(params[0]),
                                jnp.asarray(params[1]), has_aux=True)
    dx, dscale, dbias = vjp(jnp.asarray(g, dtype=jdt))
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return (f32(y), f32(dx), f32(dscale), f32(dbias),
            f32(new_stats["mean"]), f32(new_stats["var"]))


def _to_torch(a_nhwc, dtype, layout):
    """numpy (N, H, W, C) or (N, C) → torch (N, C, H, W) in the layout."""
    t = torch.from_numpy(a_nhwc).to(dtype)
    if layout == "rows":
        return t
    t = t.permute(0, 3, 1, 2)
    return t if layout == "channels_last" else t.contiguous()


def _to_nhwc(t, layout):
    t = t.detach().float()
    return (t if layout == "rows" else t.permute(0, 2, 3, 1)).numpy()


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CPU_CASES))
def test_plain_version_matches_flax(case, dtype, training):
    """Two calls of the port's BatchNorm module, each against flax's from
    the same running statistics: y, dx, dγ and dβ of each call, and the
    running mean and biased running variance after both."""
    shape, layout = CPU_CASES[case]
    c = shape[1]
    rng = np.random.default_rng(7)
    nhwc = (shape[0], *shape[2:], c)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    stats = (rng.uniform(-0.1, 0.1, c).astype(np.float32),
             rng.uniform(0.5, 1.5, c).astype(np.float32))
    bn = BatchNorm1d(c) if layout == "rows" else BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
        bn.running_mean.copy_(torch.from_numpy(stats[0]))
        bn.running_var.copy_(torch.from_numpy(stats[1]))
    bn.train(training)
    tol = CPU_TOL[dtype]
    for step in range(2):
        # per-channel offsets and scales, so a channel mix-up shows
        x = (rng.standard_normal(nhwc) * rng.uniform(0.5, 2.0, c)
             + rng.uniform(-1.0, 1.0, c)).astype(np.float32)
        g = rng.standard_normal(nhwc).astype(np.float32)
        want = _flax_bn(x, (gamma, beta), stats, g, training, dtype)
        stats = want[4:]
        xt = _to_torch(x, dtype, layout).requires_grad_(True)
        bn.zero_grad()
        y = bn(xt)
        assert y.dtype == dtype
        y.backward(_to_torch(g, dtype, layout))
        got = (_to_nhwc(y, layout), _to_nhwc(xt.grad, layout))
        for name, a, b in zip(("y", "dx"), got, want):
            np.testing.assert_allclose(a, b, **tol, err_msg=f"{name}, "
                                       f"call {step + 1}")
        # f32 sums over the rows of products of bf16-rounded or f32 values
        np.testing.assert_allclose(bn.weight.grad.numpy(), want[2],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(bn.bias.grad.numpy(), want[3],
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bn.running_mean.numpy(), stats[0], atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats[1], atol=1e-6)
    assert int(bn.num_batches_tracked) == (2 if training else 0)


def test_cpu_takes_the_plain_version():
    """A CPU tensor launches nothing and copies no layout."""
    launches, copies = bn_ops.batch_norm.launches, \
        bn_ops.batch_norm.layout_copies
    bn = BatchNorm2d(8).train()
    bn(torch.randn(2, 8, 3, 3))
    assert (bn_ops.batch_norm.launches, bn_ops.batch_norm.layout_copies) \
        == (launches, copies)


# ---------------------------------------------------------------------------
# The card: the kernels against the plain version
# ---------------------------------------------------------------------------

# IR-ResNet100 at batch 256 and 112 px: the stem, the four layers (each
# layer's first block also normalises at the previous layer's shape), the
# final BN2d and the BN1d; AlterNet50 at batch 128 and 192 px
R100_SHAPES = [(256, 64, 112, 112), (256, 64, 56, 56), (256, 128, 28, 28),
               (256, 256, 14, 14), (256, 512, 7, 7), (256, 512)]
ALTERNET50_SHAPES = [(128, 64, 96, 96), (128, 64, 48, 48),
                     (128, 128, 24, 24), (128, 256, 12, 12),
                     (128, 512, 6, 6), (128, 512)]
# C % 8 != 0 and C % 4 != 0: the scalar path in both dtypes; C = 320 bf16
# leaves the second slab of 32 vectors a quarter full; the NCHW input is
# made channels_last once; the 2-D view starts one element into its buffer,
# so no 16-byte access is aligned
SMALL_CASES = {"scalar-c13": ((32, 13, 7, 7), "channels_last"),
               "partial-slab-c320": ((16, 320, 6, 6), "channels_last"),
               "nchw": ((16, 48, 9, 9), "nchw"),
               "misaligned-rows": ((999, 16), "misaligned")}
CARD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
CARD_CASES = ([(f"r100-{'x'.join(map(str, s))}", s, "channels_last")
               for s in R100_SHAPES]
              + [(f"alternet50-{'x'.join(map(str, s))}", s, "channels_last")
                 for s in ALTERNET50_SHAPES]
              + [(name, s, layout) for name, (s, layout)
                 in SMALL_CASES.items()])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_problem(shape, layout, dtype, dev, seed=0):
    """x with per-channel offsets and scales, dy, γ, β and running
    statistics, from a seed."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]

    def uniform(lo, hi, n):
        return torch.rand(n, device=dev, generator=gen) * (hi - lo) + lo

    rows = (shape[0], *shape[2:], c)
    x = (torch.randn(rows, device=dev, generator=gen) * uniform(0.5, 2.0, c)
         + uniform(-1.0, 1.0, c)).to(dtype)
    dy = torch.randn(rows, device=dev, generator=gen).to(dtype)
    if layout == "misaligned":
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(rows)
    elif len(shape) == 4:
        x, dy = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        if layout == "nchw":
            x = x.contiguous()
    params = {"weight": uniform(0.5, 1.5, c), "bias": uniform(-0.5, 0.5, c),
              "running_mean": uniform(-0.1, 0.1, c),
              "running_var": uniform(0.5, 1.5, c),
              "num_batches_tracked": torch.tensor(3, device=dev)}
    return x, dy, params


def _run(fn, x, dy, params, training):
    """One call with autograd: (y, dx, dγ, dβ, running mean, running var,
    num_batches_tracked)."""
    p = {k: v.clone() for k, v in params.items()}
    w = p["weight"].requires_grad_(True)
    b = p["bias"].requires_grad_(True)
    xg = x.detach().requires_grad_(True)
    y = fn(xg, p["running_mean"], p["running_var"], w, b,
           p["num_batches_tracked"], training, MOMENTUM, EPS)
    dx, dw, db = torch.autograd.grad(y, (xg, w, b), dy)
    torch.cuda.synchronize()
    return (y.detach(), dx, dw, db, p["running_mean"], p["running_var"],
            p["num_batches_tracked"])


def _assert_close(name, got, want, rtol, rows_dim=None):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = rtol * want.abs() + 1e-5 * want.abs().max()
    assert bool((err <= bound).all()), \
        f"{name}: max error {err.max().item():.3e}, worst excess " \
        f"{(err - bound).max().item():.3e}"


def _per_channel(t):
    """(C,) sums over every dim but the channel one (dim 1)."""
    return t.sum(dim=[d for d in range(t.dim()) if d != 1])


@pytest.mark.cuda
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,shape,layout", CARD_CASES,
                         ids=[c[0] for c in CARD_CASES])
def test_kernels_equal_plain_on_card(cuda_device, name, shape, layout,
                                     dtype, training):
    """y, dx, dγ, dβ and the running statistics against the plain version;
    a second run of the kernels gives the same bits; the launches are 2 + 2
    in training and 1 + 2 in eval; only an NCHW input is copied."""
    x, dy, params = _card_problem(shape, layout, dtype, cuda_device)
    plain = _run(bn_ops.batch_norm_reference, x, dy, params, training)
    launches = bn_ops.batch_norm.launches
    copies = bn_ops.batch_norm.layout_copies
    ours = _run(bn_ops.batch_norm, x, dy, params, training)
    assert bn_ops.batch_norm.launches - launches == (4 if training else 3)
    assert bn_ops.batch_norm.layout_copies - copies == \
        (1 if layout == "nchw" else 0)
    again = _run(bn_ops.batch_norm, x, dy, params, training)
    for label, a, b in zip(("y", "dx", "dgamma", "dbeta", "running_mean",
                            "running_var", "num_batches_tracked"),
                           ours, again):
        assert torch.equal(a, b), f"{label}: two runs differ"
    y, dx, dw, db, rm, rv, nbt = ours
    assert y.dtype == dx.dtype == dtype and y.shape == x.shape
    _assert_close("y", y, plain[0], CARD_RTOL[dtype])
    _assert_close("dx", dx, plain[1], CARD_RTOL[dtype])
    # f32 sums over the rows: within 1e-5 of Σ|term| per channel
    xf, dyf = x.float(), dy.float()
    if training:
        dims = [d for d in range(x.dim()) if d != 1]
        mean = xf.mean(dim=dims, keepdim=True)
        rstd = torch.rsqrt(xf.var(dim=dims, unbiased=False, keepdim=True)
                           + EPS)
    else:
        view = (1, -1) + (1,) * (x.dim() - 2)
        mean = params["running_mean"].view(view)
        rstd = torch.rsqrt(params["running_var"].view(view) + EPS)
    for label, got, want, term in (
            ("dgamma", dw, plain[2], dyf * (xf - mean) * rstd),
            ("dbeta", db, plain[3], dyf)):
        err = (got - want).abs()
        assert bool((err <= 1e-5 * _per_channel(term.abs())).all()), \
            f"{label}: max error {err.max().item():.3e}"
    for label, got, want in (("running_mean", rm, plain[4]),
                             ("running_var", rv, plain[5])):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   msg=label)
    assert int(nbt) == int(plain[6]) == (4 if training else 3)


@pytest.mark.cuda
def test_statistics_at_a_large_offset_on_card(cuda_device):
    """f32 at the stem's M (3.2 M rows a channel), mean 50 against a
    spread of 0.1: y and the running statistics against f64. Chan's
    combination keeps the variance to f32 rounding of the spread;
    E[x²] − E[x]² would lose it to the ulp of E[x²] ≈ 2500 (2.4e-4, a few
    percent of the variance 0.01) and miss the 1e-5 tolerances."""
    shape = R100_SHAPES[0]
    x, _, params = _card_problem(shape, "channels_last", torch.float32,
                                 cuda_device)
    c = shape[1]
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    offset = 50.0 + torch.rand(c, device=cuda_device, generator=gen)
    x = (x - x.mean(dim=(0, 2, 3), keepdim=True)) / x.std(
        dim=(0, 2, 3), keepdim=True) * 0.1 + offset.view(1, c, 1, 1)
    p = {k: v.clone() for k, v in params.items()}
    with torch.no_grad():
        y = bn_ops.batch_norm(x, p["running_mean"], p["running_var"],
                              p["weight"], p["bias"],
                              p["num_batches_tracked"], True, MOMENTUM, EPS)
    x64 = x.double()
    mean = x64.mean(dim=(0, 2, 3))
    var = x64.var(dim=(0, 2, 3), unbiased=False)
    view = (1, c, 1, 1)
    want = ((x64 - mean.view(view)) * torch.rsqrt(var.view(view) + EPS)
            * params["weight"].double().view(view)
            + params["bias"].double().view(view))
    _assert_close("y", y, want, CARD_RTOL[torch.float32])
    for label, got, want in (
            ("running_mean", p["running_mean"],
             (1 - MOMENTUM) * params["running_mean"].double()
             + MOMENTUM * mean),
            ("running_var", p["running_var"],
             (1 - MOMENTUM) * params["running_var"].double()
             + MOMENTUM * var)):
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5,
                                   msg=label)


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_a_training_call_invalidates_a_saved_eval_graph(device):
    """An eval-mode call under autograd saves the running statistics; a
    training call then updates them in place, and the eval graph's
    backward raises as after any in-place torch op rather than use the
    updated values (the kernels write the buffers through pointers, so the
    wrapper bumps their version counters itself)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    bn = BatchNorm2d(8).to(device).eval()
    x = torch.randn(4, 8, 3, 3, device=device).to(
        memory_format=torch.channels_last).requires_grad_(True)
    y = bn(x)
    bn.train()(x.detach())
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        y.backward(torch.ones_like(y))


@pytest.mark.cuda
def test_resnet100_step_launches_no_copy_from_a_batchnorm(cuda_device):
    """One IR-ResNet100 training step's encoder forward and backward (bf16,
    batch 8, 112 px) and one eval call, under the profiler: 4 launches a
    BatchNorm in training and 1 in eval; no layout copy in either forward;
    in the backward one, the last BN2d's gradient, which reaches it in the
    NCHW order of the flatten before the Dense (fr_tpu's order); no
    aten::copy_ under a BatchNorm but that one; no library BatchNorm."""
    from torch.profiler import ProfilerActivity, profile

    from fr_tpu_torch.configs.base import Config
    from fr_tpu_torch.models import build_encoder
    from fr_tpu_torch.models.common import init_weights

    conf = Config(network="ResNet100", emd_size=512, img_size=112,
                  mixed_precision=True)
    enc = init_weights(build_encoder(conf), 0).to(cuda_device)
    n_bn = sum(isinstance(m, _FlaxBatchNorm) for m in enc.modules())
    assert n_bn == 106
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    images = torch.rand((8, 112, 112, 3), device=cuda_device, generator=gen)
    params = [p for p in enc.parameters() if p.requires_grad]

    def step():
        emb = enc.train()(images)
        return torch.autograd.grad(emb, params, torch.ones_like(emb))

    def embed():
        with torch.inference_mode():
            return enc.eval()(images)

    step()
    embed()
    torch.cuda.synchronize()
    for run, launches, copies in ((step, 4, 1), (embed, 1, 0)):
        before = (bn_ops.batch_norm.launches,
                  bn_ops.batch_norm.layout_copies)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        assert bn_ops.batch_norm.launches - before[0] == launches * n_bn
        assert bn_ops.batch_norm.layout_copies - before[1] == copies
        names = [e.name for e in prof.events()]
        assert not any("batch_norm" in n for n in names), \
            sorted({n for n in names if "batch_norm" in n})
        under_bn = 0
        for e in prof.events():
            if e.name != "aten::copy_":
                continue
            p = e.cpu_parent
            while p is not None and "BatchNorm" not in p.name:
                p = p.cpu_parent
            under_bn += p is not None
        assert under_bn == copies
