"""The port's per-head window-attention entry and both stored-stats arms
against fr_tpu's: rows 5–6 (per-head forward and recompute backward)
against the jnp contracts ``_heads_fwd`` / ``_bwd_jnp`` and the Pallas
programs ``_fwd_pallas`` / ``_bwd_pallas`` in the Pallas interpreter; rows
7–8 (stored-stats forward and backward) against ``_fwd_stats`` /
``_bwd_stats`` in the interpreter; rows 3–4 (the packed entry's stats arm)
against jax.vjp of fr_tpu's packed op with interpret=True and
stored_stats=True. Then the arms agree with each other, the
FR_ATTN_STORED_STATS routing, the model's routing between the entries, and
the wrappers' device handling. The Hopper kernels themselves are checked on
the card by test_torch_window_attn_perhead_cuda.py and
test_torch_window_attn_stats_cuda.py.

Shapes: N = 49 (window 7), head dims 32 (Swin50 stage 3) and 38
(EffiAlter_m stage 6), 8 heads, 2 images of 4 windows; masked with the
shift-3 SW-MSA mask over 14×14. Inputs come from numpy seeds.

Tolerances: f32 max-abs 2e-5·max(|ref|, 1); bf16 outputs two bf16 ulps of
the largest |ref| (the output is rounded to bf16 on both sides), bf16
gradients norm-wise 1e-2 (dq̂, dk̂ pass through bf16-rounded ds·scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fr_tpu.ops import fused_window_attn as fwa
from fr_tpu_torch.models import swin_common
from fr_tpu_torch.ops import _build
from fr_tpu_torch.ops import fused_window_attn as F
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

N, HEADS, RES, WS = 49, 8, 14, 7
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# (head dim, masked, dtype): each head dim masked and unmasked, each dtype
PALLAS_CASES = [(32, False, "f32"), (32, True, "bf16"), (38, True, "f32"),
                (38, False, "bf16")]
COUNTERS = [(F.fused_window_attention_packed, "launches"),
            (F.fused_window_attention_packed, "stats_launches"),
            (F.fused_window_attention_packed, "stats_backward_launches"),
            (F.window_attention_backward, "launches"),
            (F.fused_window_attention, "launches"),
            (F.fused_window_attention, "backward_launches"),
            (F.fused_window_attention, "stats_launches"),
            (F.fused_window_attention, "stats_backward_launches"),
            (F.window_attention_forward_stats, "launches"),
            (F.window_attention_backward_stats, "launches")]


def _case_id(case):
    hd, masked, dtype = case
    return f"hd{hd}-{'mask' if masked else 'nomask'}-{dtype}"


def _inputs(hd, masked, seed, n=N, heads=HEADS, res=RES, ws=WS, n_img=2,
            scale_range=(5, 20)):
    rng = np.random.default_rng(seed)
    nW = (res // ws) ** 2
    C = heads * hd
    qkv = rng.standard_normal((n_img * nW, n, 3 * C)).astype(np.float32)
    scale = rng.uniform(*scale_range, heads).astype(np.float32)
    bias16 = (16.0 / (1.0 + np.exp(-rng.standard_normal((heads, n, n))))
              ).astype(np.float32)
    g = rng.standard_normal((n_img * nW, n, C)).astype(np.float32)
    mask = swin_common.shifted_window_mask(res, res, ws, ws // 2) \
        if masked else None
    return qkv, scale, bias16, g, mask, nW


def _jax(qkv, scale, bias16, g, mask, jdt):
    return (jnp.asarray(qkv).astype(jdt), jnp.asarray(scale),
            jnp.asarray(bias16), jnp.asarray(g).astype(jdt),
            None if mask is None else jnp.asarray(mask))


def _torch(qkv, scale, bias16, g, mask, tdt):
    return (torch.from_numpy(qkv).to(tdt), torch.from_numpy(scale),
            torch.from_numpy(bias16), torch.from_numpy(g).to(tdt),
            None if mask is None else torch.from_numpy(mask))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_out(ours, ref, dtype):
    a, b = _f32(ours), _f32(ref)
    assert a.shape == b.shape
    mag = float(np.abs(b).max())
    tol = (2e-5 * max(mag, 1.0) if dtype == "f32"
           else 2.0 * 2.0 ** (np.floor(np.log2(mag)) - 7))
    assert np.abs(a - b).max() <= tol, (np.abs(a - b).max(), tol)


def _assert_grads(ours, ref, dtype):
    for name, a, b in zip(("dqkv", "dscale", "dbias"), ours, ref):
        a, b = _f32(a).reshape(-1), _f32(b).reshape(-1)
        assert a.shape == b.shape, name
        if dtype == "f32":
            tol = 2e-5 * max(float(np.abs(b).max()), 1.0)
            assert np.abs(a - b).max() <= tol, (name, np.abs(a - b).max())
        else:
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel <= 1e-2, (name, rel)


def _autograd(entry, qkv, scale, bias16, g, mask, nW, **kw):
    """Output and (dqkv, dscale, dbias) through the port's autograd
    Function."""
    q = qkv.clone().requires_grad_(True)
    s = scale.clone().requires_grad_(True)
    b = bias16.clone().requires_grad_(True)
    out = entry(q, s, b, scale.shape[0], nW, mask, out_dtype=qkv.dtype, **kw)
    out.backward(g)
    return out, (q.grad, s.grad, b.grad)


# -- rows 5-6: the per-head entry against fr_tpu's jnp contracts -----------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("hd", [32, 38])
def test_perhead_matches_heads_fwd_and_bwd_jnp(hd, masked, dtype):
    jdt, tdt = DTYPES[dtype]
    arrays = _inputs(hd, masked, seed=hd + masked)
    qkv, scale, bias16, g, mask = _jax(*arrays[:5], jdt)
    ref_out = fwa._heads_fwd(qkv, scale, bias16, mask, HEADS, jdt)
    ref_grads = fwa._bwd_jnp(qkv, scale, bias16, mask, g, HEADS)
    out, grads = _autograd(F.fused_window_attention,
                           *_torch(*arrays[:5], tdt), arrays[5])
    _assert_out(out, ref_out.astype(jdt), dtype)
    _assert_grads(grads, ref_grads, dtype)


@pytest.mark.parametrize("case", PALLAS_CASES, ids=_case_id)
def test_perhead_matches_interpreted_fwd_and_bwd_pallas(case):
    """_fwd_pallas and _bwd_pallas (the batched bodies) run in the Pallas
    interpreter on the CPU."""
    hd, masked, dtype = case
    jdt, tdt = DTYPES[dtype]
    arrays = _inputs(hd, masked, seed=100 + hd + masked)
    qkv, scale, bias16, g, mask = _jax(*arrays[:5], jdt)
    nW = arrays[5]
    ref_out = fwa._fwd_pallas(qkv, scale, bias16, mask, HEADS, nW, 1024, jdt)
    ref_grads = fwa._bwd_pallas(qkv, scale, bias16, mask, g, HEADS, nW,
                                1024)
    out, grads = _autograd(F.fused_window_attention,
                           *_torch(*arrays[:5], tdt), nW)
    _assert_out(out, ref_out, dtype)
    _assert_grads(grads, ref_grads, dtype)


# -- rows 7-8: the stored-stats pair against fr_tpu's interpreted kernels --

@pytest.mark.parametrize("case", PALLAS_CASES, ids=_case_id)
def test_stats_pair_matches_interpreted_fwd_and_bwd_stats(case):
    """_fwd_stats / _bwd_stats with interpret=True, as
    tests/test_fused_window_attn.py drives them; p compared in fr_tpu's
    (h, B·nW, N, N) layout, the backward fed each side's own p."""
    hd, masked, dtype = case
    jdt, tdt = DTYPES[dtype]
    arrays = _inputs(hd, masked, seed=200 + hd + masked)
    qkv, scale, bias16, g, mask = _jax(*arrays[:5], jdt)
    nW = arrays[5]
    ref_out, ref_p = fwa._fwd_stats(qkv, scale, bias16, HEADS, nW, mask,
                                    1024, jdt, interpret=True)
    ref_grads = fwa._bwd_stats(qkv, scale, ref_p, g, HEADS, nW, 1024,
                               interpret=True)
    tq, ts, tb, tg, tm = _torch(*arrays[:5], tdt)
    out, p = F.window_attention_forward_stats(tq, ts, tb, HEADS, nW, tm,
                                              out_dtype=tdt)
    _assert_out(out, ref_out, dtype)
    # bf16: where the two sides' rsqrt differ in the last f32 digit, q̂ or
    # k̂ can round to the neighbouring bf16 value, which moves a score by up
    # to scale·2⁻⁸ (measured: p within 3.3e-4)
    np.testing.assert_allclose(p.permute(1, 0, 2, 3).numpy(),
                               np.asarray(ref_p), rtol=0,
                               atol=2e-6 if dtype == "f32" else 1e-3)
    grads = F.window_attention_backward_stats(tq, ts, p, tg, HEADS)
    _assert_grads(grads, ref_grads, dtype)


# -- rows 3-4: the packed entry's stats arm against fr_tpu's packed VJP ----

@pytest.mark.parametrize("shape,masked,dtype", [
    ((36, 4, 12, 6), True, "f32"), ((36, 8, 12, 6), False, "bf16"),
    ((9, 16, 6, 3), False, "f32"), ((9, 16, 6, 3), True, "bf16")],
    ids=["N36h4-mask-f32", "N36h8-bf16", "N9h16-f32", "N9h16-mask-bf16"])
def test_packed_stats_arm_matches_packed_vjp(shape, masked, dtype):
    """jax.vjp of fused_window_attention_packed(interpret=True,
    stored_stats=True) runs _pk_fwd_stats_pallas and _pk_bwd_stats_pallas
    in the interpreter. Scale 10: the packed kernel's shared row max needs
    the heads' scores within ~88 of each other (ROADMAP §3)."""
    n, heads, res, ws = shape
    jdt, tdt = DTYPES[dtype]
    arrays = _inputs(32, masked, seed=300 + n + heads, n=n, heads=heads,
                     res=res, ws=ws, scale_range=(10, 10))
    qkv, scale, bias16, g, mask = _jax(*arrays[:5], jdt)
    nW = arrays[5] if masked else 1

    def f(q, s, b):
        return fwa.fused_window_attention_packed(
            q, s, b, heads, nW, mask, 1024, True, jdt, stored_stats=True)

    ref_out, vjp = jax.vjp(f, qkv, scale, bias16)
    ref_grads = vjp(g)
    before = F.fused_window_attention_packed.stats_launches
    out, grads = _autograd(F.fused_window_attention_packed,
                           *_torch(*arrays[:5], tdt), nW, stored_stats=True)
    assert F.fused_window_attention_packed.stats_launches == before
    _assert_out(out, ref_out, dtype)
    _assert_grads(grads, ref_grads, dtype)


# -- the arms, the switch and the routing ----------------------------------

@pytest.mark.parametrize("entry", [F.fused_window_attention,
                                   F.fused_window_attention_packed],
                         ids=["per_head", "packed"])
def test_stats_arm_equals_recompute_arm(entry):
    """f32: the same output and gradients from both arms of the Function
    (dscale by the row-sum identity against Σ ds·s_raw)."""
    arrays = _torch(*_inputs(38, True, seed=7)[:5], torch.float32)
    nW = 4
    runs = [_autograd(entry, *arrays, nW, stored_stats=s)
            for s in (False, True)]
    _assert_out(runs[1][0], runs[0][0], "f32")
    _assert_grads(runs[1][1], runs[0][1], "f32")


def _record_arms(monkeypatch):
    """Which plain version each call took: 'fwd', 'bwd', 'fwd_stats',
    'bwd_stats'."""
    seen = []
    for arm, name in (("fwd", "window_attention_reference"),
                      ("bwd", "window_attention_backward_reference"),
                      ("fwd_stats", "window_attention_forward_stats_reference"),
                      ("bwd_stats",
                       "window_attention_backward_stats_reference")):
        fn = getattr(F, name)

        def wrapped(*a, _fn=fn, _arm=arm, **kw):
            seen.append(_arm)
            return _fn(*a, **kw)
        monkeypatch.setattr(F, name, wrapped)
    return seen


@pytest.mark.parametrize("env", [None, "0", "1", "yes"])
@pytest.mark.parametrize("stored_stats", [False, True])
@pytest.mark.parametrize("entry", [F.fused_window_attention,
                                   F.fused_window_attention_packed],
                         ids=["per_head", "packed"])
def test_fr_attn_stored_stats_overrides_the_argument(monkeypatch, entry,
                                                     stored_stats, env):
    """FR_ATTN_STORED_STATS in {"0", "1"} overrides stored_stats; any other
    value leaves it; without autograd only the forward runs."""
    if env is None:
        monkeypatch.delenv("FR_ATTN_STORED_STATS", raising=False)
    else:
        monkeypatch.setenv("FR_ATTN_STORED_STATS", env)
    seen = _record_arms(monkeypatch)
    arrays = _torch(*_inputs(32, False, seed=8, n_img=1)[:5], torch.float32)
    _autograd(entry, *arrays, 1, stored_stats=stored_stats)
    stats = env == "1" if env in ("0", "1") else stored_stats
    assert seen == (["fwd_stats", "bwd_stats"] if stats else ["fwd", "bwd"])
    seen.clear()
    with torch.no_grad():
        entry(*arrays[:3], HEADS, 1, stored_stats=stored_stats)
    assert seen == ["fwd"]


@pytest.mark.parametrize("heads,window,env,expect", [
    (8, 7, None, ("per_head", False)), (16, 7, "1", ("per_head", True)),
    (4, 6, None, ("packed", False)), (16, 3, "1", ("packed", True)),
    (4, 6, "0", ("packed", False))])
def test_window_attention_routes_as_fr_tpu(monkeypatch, heads, window, env,
                                           expect):
    """heads·N ≤ 288 → the packed entry, wider → the per-head entry; the
    stats argument is attention_stats_inmodel() (FR_ATTN_STORED_STATS=1)."""
    if env is None:
        monkeypatch.delenv("FR_ATTN_STORED_STATS", raising=False)
    else:
        monkeypatch.setenv("FR_ATTN_STORED_STATS", env)
    calls = []

    def recorder(name):
        def entry(*a, stored_stats, **kw):
            calls.append((name, stored_stats))
            return torch.zeros(a[0].shape[0], a[0].shape[1],
                               a[0].shape[2] // 3)
        return entry
    monkeypatch.setattr(swin_common, "fused_window_attention",
                        recorder("per_head"))
    monkeypatch.setattr(swin_common, "fused_window_attention_packed",
                        recorder("packed"))
    attn = swin_common.WindowAttention(heads * 4, (window, window), heads)
    attn(torch.zeros(2, window * window, heads * 4))
    assert calls == [expect]


def test_cpu_tensors_never_launch():
    before = [getattr(f, a) for f, a in COUNTERS]
    arrays = _torch(*_inputs(38, True, seed=9)[:5], torch.bfloat16)
    for entry in (F.fused_window_attention, F.fused_window_attention_packed):
        for stats in (False, True):
            _autograd(entry, *arrays, 4, stored_stats=stats)
    qkv, scale, bias16, g, mask = arrays
    _, p = F.window_attention_forward_stats(qkv, scale, bias16, HEADS, 4,
                                            mask)
    F.window_attention_backward_stats(qkv, scale, p, g, HEADS)
    assert [getattr(f, a) for f, a in COUNTERS] == before


def test_other_devices_raise():
    qkv = torch.empty((4, 49, 3 * 8 * 38), device="meta")
    with pytest.raises(ValueError, match="no window-attention kernel"):
        F.fused_window_attention(qkv, torch.ones(8), torch.ones(8, 49, 49),
                                 8, 1)
    with pytest.raises(ValueError, match="no window-attention kernel"):
        F.window_attention_backward_stats(
            qkv, torch.ones(8), torch.empty(4, 8, 49, 49),
            torch.empty((4, 49, 304), device="meta"), 8)


def test_launch_checks_state_the_shared_memory_budget():
    """The N=49 shapes fit: forward (and stats forward) 32,928 B of 48 KB
    at head dim 38, recompute backward 76,568 B and stats backward 66,640 B
    of 227 KB; a shape beyond the budget is refused before any launch."""
    assert F._smem_bytes(49, 38) == 32928 <= F._SMEM_LIMIT
    assert F._bwd_smem_bytes(49, 38) == 76568 <= F._BWD_SMEM_LIMIT
    assert F._bwd_stats_smem_bytes(49, 38) == 66640 <= F._BWD_SMEM_LIMIT
    qkv = torch.zeros(2, 64, 3 * 256)
    with pytest.raises(ValueError, match="shared memory"):
        F._checked_operands(qkv, torch.ones(1), torch.ones(1, 64, 64), 1, 1,
                            None, F._smem_bytes, F._SMEM_LIMIT)


def test_every_source_builds_and_a_missing_nvcc_raises(monkeypatch,
                                                       tmp_path):
    assert "window_attn_stats.cu" in _build.SOURCES
    assert all((_build.CSRC / s).is_file()
               for s in _build.SOURCES + _build.HEADERS)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_an_edit_to_the_shared_header_names_a_new_library(monkeypatch,
                                                         tmp_path):
    """The sources include window_attn_common.cuh: the library's name hashes
    it too, so an edit there rebuilds."""
    for name in _build.SOURCES + _build.HEADERS:
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    with open(tmp_path / _build.HEADERS[0], "a") as f:
        f.write("\n")
    assert _build.library_path() != before
