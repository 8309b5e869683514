"""The port's remaining window-attention routes against fr_tpu's: the
grouped route of the packed entry (rows 15/16) against fr_tpu's grid-axis
grouped Pallas programs ``_pkg_fwd``/``_pkg_bwd`` run by the interpreter; the
spatial op (row 17) against fr_tpu's ``fused_window_attention_spatial`` (its
jnp twin ``_sp_jnp`` and VJP on the CPU); the entry-fused op (row 18)
against fr_tpu's ``fused_window_attention_packed_qkv`` with its real Pallas
programs interpreted, under both ``_PKX_HYBRID_BWD`` routes; and
``WindowAttention`` at rank 4 and with ``entry_fused`` against fr_tpu's
module on carried weights. The Hopper kernels themselves are checked on the
card by test_torch_window_attn_variants_cuda.py.

Inputs come from numpy seeds. Tolerances, max-abs, as the other attention
tests state them: f32 1e-5·max(|ref|, 1); bf16 1.5e-2·max(|ref|, 1), and
3e-2·max(|ref|, 1) against fr_tpu's packed Pallas programs, which also
round their unnormalised exponentials to bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fr_tpu.ops.fused_window_attn_variants as jax_variants
from fr_tpu.models import swin_common as jax_swin
from fr_tpu.ops.fused_window_attn import \
    fused_window_attention_packed as jax_packed
from fr_tpu_torch.models import swin_common
from fr_tpu_torch.models.swin_common import shifted_window_mask
from fr_tpu_torch.ops import fused_window_attn as F
from fr_tpu_torch.ops import fused_window_attn_variants as V
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype, ref, packed=False):
    mag = max(float(np.abs(ref).max()), 1.0)
    if dtype == "f32":
        return 1e-5 * mag
    return (3e-2 if packed else 1.5e-2) * mag


def _assert_close(names, ours, refs, dtype, packed=False):
    for name, a, b in zip(names, ours, refs):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = np.abs(a - b).max()
        assert err <= _tol(dtype, b, packed), (name, err, _tol(dtype, b,
                                                               packed))


def _np(t):
    return t.detach().float().numpy()


def _params(rng, heads, N):
    scale = rng.uniform(5, 20, heads).astype(np.float32)
    bias16 = (16.0 / (1.0 + np.exp(-rng.standard_normal((heads, N, N))))
              ).astype(np.float32)
    return scale, bias16


# ---------------------------------------------------------------------------
# rows 15/16: the grouped route
# ---------------------------------------------------------------------------

# (B·nW, N, C, heads, head_group, windows per image or 0 unmasked):
# ng = 2 groups of 128 channels, _pkg_use holds
GROUPED = [(4, 49, 256, 8, 4, 0), (8, 36, 256, 8, 4, 4)]


def test_grouped_route_is_fr_tpus_pkg_use():
    from fr_tpu.ops.fused_window_attn import _pkg_use
    for heads, hg, C in [(8, 4, 256), (16, 4, 512), (8, 8, 256),
                         (8, 2, 256), (4, 2, 128), (16, 0, 512)]:
        ng = heads // (hg or heads)
        assert F.grouped_route(heads, hg, C) == _pkg_use(ng, C // ng)
    with pytest.raises(ValueError, match="does not divide"):
        F.grouped_route(8, 3, 256)


@pytest.mark.parametrize("case,dtype", [(GROUPED[0], "f32"),
                                        (GROUPED[1], "bf16")],
                         ids=["N49-f32", "N36-mask-bf16"])
def test_grouped_route_matches_interpreted_pkg(case, dtype):
    """fr_tpu's packed entry with head_group 4 runs _pkg_fwd/_pkg_bwd (the
    grid-axis grouped programs) in the interpreter; the port's grouped route
    agrees in value and in the qkv, scale and bias16 gradients. Scale 10:
    the packed programs share one softmax max over a group's heads."""
    B_, N, C, heads, hg, nW = case
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(40 + N)
    qkv = rng.standard_normal((B_, N, 3 * C)).astype(np.float32)
    scale = np.full(heads, 10.0, np.float32)
    _, bias16 = _params(rng, heads, N)
    g = rng.standard_normal((B_, N, C)).astype(np.float32)
    mask = (shifted_window_mask(12, 12, 6, 3) if nW else None)
    jmask = None if mask is None else jnp.asarray(mask)

    def f(q, s, b):
        return jax_packed(q, s, b, heads, max(nW, 1), jmask, 1024, True, jdt,
                          hg)

    out_ref, vjp = jax.vjp(f, jnp.asarray(qkv).astype(jdt),
                           jnp.asarray(scale), jnp.asarray(bias16))
    grads_ref = vjp(jnp.asarray(g).astype(jdt))

    tq = torch.from_numpy(qkv).to(tdt).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    tb = torch.from_numpy(bias16).requires_grad_(True)
    before = (F.fused_window_attention_packed.grouped_launches,
              F.fused_window_attention_packed.grouped_backward_launches)
    out = F.fused_window_attention_packed(
        tq, ts, tb, heads, max(nW, 1),
        None if mask is None else torch.from_numpy(mask), out_dtype=tdt,
        head_group=hg)
    out.backward(torch.from_numpy(g).to(tdt))
    # a CPU tensor takes the plain versions: nothing launches
    assert before == (F.fused_window_attention_packed.grouped_launches,
                      F.fused_window_attention_packed.grouped_backward_launches)
    _assert_close(("out", "dqkv", "dscale", "dbias"),
                  [_np(out), _np(tq.grad), _np(ts.grad), _np(tb.grad)],
                  [out_ref, *grads_ref], dtype, packed=True)


def test_grouped_route_never_takes_the_stats_arm(monkeypatch):
    """fr_tpu's _pk_fwd_rule switches the stats arm off where _pkg_use
    holds, whatever stored_stats and FR_ATTN_STORED_STATS say; the full
    pack takes it."""
    monkeypatch.setenv("FR_ATTN_STORED_STATS", "1")
    calls = []
    plain = F._forward_stats

    def spy(*args):
        calls.append(args[-1])
        return plain(*args)

    monkeypatch.setattr(F, "_forward_stats", spy)
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 9, 768)).astype(
        np.float32)).requires_grad_(True)
    scale, bias16 = (torch.from_numpy(a) for a in _params(rng, 8, 9))
    for hg, stats in ((4, False), (0, True), (8, True)):
        calls.clear()
        F.fused_window_attention_packed(qkv, scale, bias16, 8, 1,
                                        stored_stats=True,
                                        head_group=hg).sum().backward()
        assert bool(calls) == stats, hg


# ---------------------------------------------------------------------------
# row 17: the spatial op
# ---------------------------------------------------------------------------

# (images, resolution, window, heads, head dim, shift)
SPATIAL = [(2, 12, 6, 4, 16, 3), (2, 12, 6, 4, 16, 0), (2, 6, 3, 4, 16, 1)]


def _spatial_inputs(case, seed):
    B, res, ws, heads, hd, shift = case
    rng = np.random.default_rng(seed)
    C = heads * hd
    qkv = rng.standard_normal((B, res, res, 3 * C)).astype(np.float32)
    scale, bias16 = _params(rng, heads, ws * ws)
    g = rng.standard_normal((B, res, res, C)).astype(np.float32)
    mask = shifted_window_mask(res, res, ws, shift) if shift else None
    return qkv, scale, bias16, g, mask


@pytest.mark.parametrize("case,dtype",
                         [(c, "f32") for c in SPATIAL] + [(SPATIAL[0], "bf16")],
                         ids=lambda c: (f"ws{c[2]}shift{c[5]}"
                                        if isinstance(c, tuple) else c))
def test_spatial_matches_fr_tpu(case, dtype):
    """Value and qkv/scale/bias16 VJP against fr_tpu's spatial op, which
    runs its jnp twin _sp_jnp and the interpret branch of _sp_bwd_rule on
    the CPU."""
    _, _, ws, heads, _, _ = case
    jdt, tdt = DTYPES[dtype]
    qkv, scale, bias16, g, mask = _spatial_inputs(case, seed=ws + case[5])
    jmask = None if mask is None else jnp.asarray(mask)
    out_ref, grads_ref = jax.jit(lambda q, s, b, gg: (
        lambda o, vjp: (o, vjp(gg)))(*jax.vjp(
            lambda *a: jax_variants.fused_window_attention_spatial(
                *a, heads, ws, jmask), q, s, b)))(
        jnp.asarray(qkv).astype(jdt), jnp.asarray(scale),
        jnp.asarray(bias16), jnp.asarray(g))

    tq = torch.from_numpy(qkv).to(tdt).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    tb = torch.from_numpy(bias16).requires_grad_(True)
    out = V.fused_window_attention_spatial(
        tq, ts, tb, heads, ws, None if mask is None else
        torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out_ref.dtype == jnp.float32
    out.backward(torch.from_numpy(g))
    assert tq.grad.dtype == tdt
    _assert_close(("out", "dqkv", "dscale", "dbias"),
                  [_np(out), _np(tq.grad), _np(ts.grad), _np(tb.grad)],
                  [out_ref, *grads_ref], dtype)


def test_spatial_equals_windows_route_bitwise():
    """On the CPU the spatial op is the windows API between a partition and
    its reverse, forward and backward, to the bit."""
    case = SPATIAL[0]
    B, res, ws, heads, hd, shift = case
    qkv, scale, bias16, g, mask = _spatial_inputs(case, seed=5)
    tq, ts, tb, tg, tm = (torch.from_numpy(a) for a in (qkv, scale, bias16,
                                                        g, mask))
    out = V.fused_window_attention_spatial(tq, ts, tb, heads, ws, tm)
    win = swin_common.window_reverse(F.window_attention_reference(
        swin_common.window_partition(tq, ws), ts, tb, heads, tm), ws, res,
        res)
    assert torch.equal(out, win)
    grads = V.spatial_attention_backward(tq, ts, tb, tg, heads, ws, tm)
    ref = F.window_attention_backward_reference(
        swin_common.window_partition(tq, ws), ts, tb,
        swin_common.window_partition(tg, ws), heads, tm)
    assert torch.equal(grads[0], swin_common.window_reverse(ref[0], ws, res,
                                                            res))
    assert torch.equal(grads[1], ref[1]) and torch.equal(grads[2], ref[2])


def test_spatial_shape_checks():
    q = torch.zeros((1, 7, 6, 96), device="meta")
    with pytest.raises(ValueError, match="not whole windows"):
        V._spatial_operands(q, torch.ones(2, device="meta"),
                            torch.ones(2, 9, 9, device="meta"), 2, 3, None,
                            F._smem_bytes, F._SMEM_LIMIT)
    with pytest.raises(ValueError, match="no window-attention kernel"):
        V.fused_window_attention_spatial(
            torch.zeros((1, 6, 6, 96), device="meta"), torch.ones(2),
            torch.ones(2, 9, 9), 2, 3)


# ---------------------------------------------------------------------------
# row 18: the entry-fused op
# ---------------------------------------------------------------------------

# (B·nW, N, C, heads, windows per image or 0 unmasked, dtype)
ENTRY = [(8, 36, 128, 4, 4, "f32"), (8, 9, 128, 4, 0, "bf16")]


def _entry_inputs(case, seed):
    B_, N, C, heads, nW, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B_, N, C)).astype(np.float32)
    w = (rng.standard_normal((C, 3 * C)) * 0.1).astype(np.float32)  # fr_tpu's
    b = (rng.standard_normal(3 * C) * 0.1).astype(np.float32)
    scale = np.full(heads, 10.0, np.float32)
    _, bias16 = _params(rng, heads, N)
    g = rng.standard_normal((B_, N, C)).astype(np.float32)
    res = 12 if N == 36 else 6
    mask = shifted_window_mask(res, res, int(N ** 0.5), 3 if N == 36 else 1) \
        if nW else None
    return x, w, b, scale, bias16, g, mask


@pytest.mark.parametrize("hybrid", [True, False], ids=["hybrid", "allkernel"])
@pytest.mark.parametrize("case", ENTRY,
                         ids=lambda c: f"N{c[1]}C{c[2]}nw{c[4]}-{c[5]}")
def test_entry_fused_matches_interpreted_pkx(case, hybrid, monkeypatch):
    """fr_tpu's entry-fused op with interpret=True runs _pkx_fwd and, under
    _PKX_HYBRID_BWD, either the qkv recompute + _pk_bwd_pallas + XLA dots
    or the all-in-kernel _pkx_bwd program, in the interpreter. The port,
    switched the same way, agrees in the output and in the x, w, b, scale
    and bias16 gradients (w's in fr_tpu's (C, 3C) layout)."""
    B_, N, C, heads, nW, dtype = case
    jdt, tdt = DTYPES[dtype]
    monkeypatch.setattr(jax_variants, "_PKX_HYBRID_BWD", hybrid)
    monkeypatch.setattr(V, "_PKX_HYBRID_BWD", hybrid)
    x, w, b, scale, bias16, g, mask = _entry_inputs(case, seed=N + C)
    jmask = None if mask is None else jnp.asarray(mask)

    def f(*a):
        return jax_variants.fused_window_attention_packed_qkv(
            *a, heads, max(nW, 1), jmask, 1024, True, jdt)

    out_ref, vjp = jax.vjp(f, jnp.asarray(x).astype(jdt), jnp.asarray(w),
                           jnp.asarray(b), jnp.asarray(scale),
                           jnp.asarray(bias16))
    grads_ref = vjp(jnp.asarray(g).astype(jdt))

    leaves = [torch.from_numpy(x).to(tdt), torch.from_numpy(w.T.copy()),
              torch.from_numpy(b), torch.from_numpy(scale),
              torch.from_numpy(bias16)]
    for t in leaves:
        t.requires_grad_(True)
    out = V.fused_window_attention_packed_qkv(
        *leaves, heads, max(nW, 1),
        None if mask is None else torch.from_numpy(mask), out_dtype=tdt)
    out.backward(torch.from_numpy(g).to(tdt))
    ours = [_np(out)] + [_np(t.grad) for t in leaves]
    ours[2] = ours[2].T
    assert leaves[0].grad.dtype == tdt
    _assert_close(("out", "dx", "dw", "db", "dscale", "dbias"), ours,
                  [out_ref, *grads_ref], dtype, packed=True)


def test_entry_fused_routes_differ_only_in_db_rounding():
    """bf16: the all-in-kernel backward sums the unrounded f32 dqkv into db,
    the hybrid the bf16 one (fr_tpu :641 against :799); every other
    gradient is the same function. In f32 the two routes agree to the
    bit in db too."""
    case = ENTRY[1]
    x, w, b, scale, bias16, g, _ = _entry_inputs(case, seed=3)
    heads = case[3]
    for tdt in (torch.float32, torch.bfloat16):
        args = [torch.from_numpy(x).to(tdt), torch.from_numpy(w.T.copy()),
                torch.from_numpy(b), torch.from_numpy(scale),
                torch.from_numpy(bias16), torch.from_numpy(g).to(tdt),
                heads, 1]
        hybrid = V.hybrid_backward(*args)
        allk = V.qkv_attention_backward(*args)
        for name, a, c in zip(("dx", "dw", "db", "dscale", "dbias"), hybrid,
                              allk):
            if name == "db" and tdt == torch.bfloat16:
                # a bf16 rounding (2⁻⁹ relative) per summed element
                assert not torch.equal(a, c)
                assert ((a - c).norm() / c.norm()).item() <= 1e-2
            else:
                assert torch.equal(a, c), (name, tdt)


def test_entry_fused_cpu_takes_plain_version_without_launch():
    case = ENTRY[0]
    x, w, b, scale, bias16, g, mask = _entry_inputs(case, seed=4)
    args = [torch.from_numpy(a) for a in (x, w.T.copy(), b, scale, bias16)]
    before = V.fused_window_attention_packed_qkv.launches
    out = V.fused_window_attention_packed_qkv(*args, 4, 4,
                                              torch.from_numpy(mask))
    assert V.fused_window_attention_packed_qkv.launches == before
    assert torch.equal(out, V.window_attention_qkv_reference(
        *args, 4, torch.from_numpy(mask)))
    with pytest.raises(ValueError, match="does not divide"):
        V.fused_window_attention_packed_qkv(*args, 4, 4, head_group=3)
    with pytest.raises(ValueError, match="no window-attention kernel"):
        V.qkv_attention_backward(
            torch.zeros((4, 9, 64), device="meta"), *args[1:],
            torch.zeros((4, 9, 64), device="meta"), 4, 1)


# ---------------------------------------------------------------------------
# WindowAttention at rank 4 and entry-fused, against fr_tpu's module
# ---------------------------------------------------------------------------

def _carry(variables):
    """fr_tpu WindowAttention params → the port module's state dict."""
    p = {k: np.asarray(v) for k, v in _flat(variables["params"]).items()}
    return {
        "qkv.weight": p["qkv_kernel"].T, "q_bias": p["q_bias"],
        "v_bias": p["v_bias"], "logit_scale": p["logit_scale"],
        "cpb_mlp.0.weight": p["cpb_fc1.kernel"].T,
        "cpb_mlp.0.bias": p["cpb_fc1.bias"],
        "cpb_mlp.2.weight": p["cpb_fc2.kernel"].T,
        "proj.weight": p["proj.kernel"].T, "proj.bias": p["proj.bias"]}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "."))
        else:
            out[key] = v
    return out


def _module_pair(C, ws, heads, seed, x):
    rng = np.random.default_rng(seed)
    jmod = jax_swin.WindowAttention(C, (ws, ws), heads, dtype=jnp.float32)
    variables = jmod.init(jax.random.key(seed), jnp.asarray(x))
    # move the biases and scales off their init values
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (rng.uniform(-0.1, 0.1, leaf.shape).astype(
            np.float32) if path[-1].key in ("q_bias", "v_bias", "bias")
            else np.log(rng.uniform(5, 20, leaf.shape)).astype(np.float32)
            if path[-1].key == "logit_scale" else np.asarray(leaf)),
        variables["params"])
    tmod = swin_common.WindowAttention(C, (ws, ws), heads)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in _carry({"params": params}).items()}
    missing = tmod.load_state_dict(sd, strict=False)
    assert not missing.unexpected_keys and set(missing.missing_keys) == {
        "relative_coords_table", "relative_position_index"}
    return jmod, params, tmod


def _grads_close(jmod, params, x, mask, tmod, tx, tmask, port_fn):
    ref = jmod.apply({"params": params}, jnp.asarray(x), mask)
    gref = jax.jit(jax.grad(lambda p: (jmod.apply(
        {"params": p}, jnp.asarray(x), mask) ** 2).sum()))(params)
    out = port_fn(tx, tmask)
    (out ** 2).sum().backward()
    assert np.abs(_np(out) - np.asarray(ref)).max() <= 1e-4
    ours = _carry({"params": gref})
    grads = {n: p.grad for n, p in tmod.named_parameters()}
    for name, want in ours.items():
        got = _np(grads[name])
        mag = max(float(np.abs(want).max()), 1.0)
        assert np.abs(got - want).max() <= 2e-4 * mag, name


@pytest.mark.parametrize("listed", [True, False], ids=["spatial", "windows"])
@pytest.mark.parametrize("shift", [0, 3])
def test_module_rank4_matches_fr_tpu(shift, listed, monkeypatch):
    """fr_tpu's WindowAttention on a (B, H, W, C) map, listed in
    SPATIAL_KERNEL_CONFIGS (the spatial op) or not (partition, the windows
    API, reverse), against the port's module on the same weights; the
    gradients of every parameter (fr_tpu test_fused_window_attn.py:531).
    Tolerances as fr_tpu's own module tests: value 1e-4, gradients
    2e-4·max(|ref|, 1)."""
    H = W = 12
    ws, C, heads = 6, 64, 4
    configs = frozenset({(ws, C)}) if listed else frozenset()
    monkeypatch.setattr(jax_swin, "SPATIAL_KERNEL_CONFIGS", configs)
    monkeypatch.setattr(swin_common, "SPATIAL_KERNEL_CONFIGS", configs)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, H, W, C)).astype(np.float32)
    mask = shifted_window_mask(H, W, ws, shift) if shift else None
    jmod, params, tmod = _module_pair(C, ws, heads, 3, x)
    calls = []
    spatial = V.fused_window_attention_spatial

    def spy(*a):
        calls.append(1)
        return spatial(*a)

    monkeypatch.setattr(swin_common, "fused_window_attention_spatial", spy)
    _grads_close(jmod, params, x, mask, tmod, torch.from_numpy(x),
                 None if mask is None else torch.from_numpy(mask), tmod)
    assert bool(calls) == listed


@pytest.mark.parametrize("shift", [0, 3])
def test_module_entry_fused_matches_fr_tpu(shift, monkeypatch):
    """entry_fused on both modules (rank-3 windows, a packed shape): the
    entry-fused op in fr_tpu's module against the port's
    (fr_tpu test_fused_window_attn.py:568)."""
    H = W = 12
    ws, C, heads = 6, 64, 4
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8 * 4, ws * ws, C)).astype(np.float32)
    mask = shifted_window_mask(H, W, ws, shift) if shift else None
    _, params, tmod = _module_pair(C, ws, heads, 1, x)
    jmod = jax_swin.WindowAttention(C, (ws, ws), heads, dtype=jnp.float32,
                                    entry_fused=True)
    tmod.entry_fused = True
    calls = []
    fused = V.fused_window_attention_packed_qkv

    def spy(*a, **k):
        calls.append(1)
        return fused(*a, **k)

    monkeypatch.setattr(swin_common, "fused_window_attention_packed_qkv", spy)
    _grads_close(jmod, params, x, mask, tmod, torch.from_numpy(x),
                 None if mask is None else torch.from_numpy(mask), tmod)
    assert calls
