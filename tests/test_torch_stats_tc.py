"""The stored-stats pair's two bodies (rows 3, 4, 7 and 8 of ROADMAP §2):
which calls take the tensor-core kernels (window_attn_fwd_stats_tc,
window_attn_bwd_stats_tc in csrc/window_attn_stats.cu) and which the
CUDA-core ones, the tensor-core CTAs' shared memory, the launch each route
makes (with the library replaced, so no card is needed) and the partial
buffer the plan sizes, and the CPU pair against fr_tpu's interpreted stats
kernels at the three AlterNet50 widths and head dim 38, bf16, where
test_torch_window_attn_perhead.py holds other cases. The kernels
themselves are checked on the card by
test_torch_window_attn_stats_cuda.py.

Tolerances as test_torch_window_attn_perhead.py states them: bf16 outputs
two bf16 ulps of the largest |ref|, p max-abs 1e-3, gradients norm-wise
1e-2."""

import contextlib

import jax
import numpy as np
import pytest
import torch

from fr_tpu.ops import fused_window_attn as fwa
from fr_tpu_torch.ops import _build
from fr_tpu_torch.ops import fused_window_attn as F
from test_torch_cpu_threads import one_torch_thread  # noqa: F401
from test_torch_window_attn_perhead import (DTYPES, HEADS, _assert_grads,
                                            _assert_out, _autograd, _inputs,
                                            _jax, _torch)

LIMIT = 227 * 1024
SLOTS = 264   # the stand-in card: 132 SMs of 2 CTAs


def _pf(N):
    """p's (N, N) f32 tile in floats, padded to 16-byte words."""
    return 4 * -(-N * N // 4)


# (N, hd, masked) → bytes of the forward and the backward CTA, by the
# layout window_attn_stats.cu states: forward 4·(bias (+ mask) + p tile)
# + 2·(zero row + two stages of q, k, v); backward 4·(4·NP + 32 + two p
# stages) + 2·(zero row + q̂, k̂ + two stages of q, k, v, g + the round(p)
# and round(ds·scale) tiles), with NP = 16·⌈N/16⌉ and rows of HDP + 8
SMEM = [((36, 32, True), 4 * (2 * 36 * 56 + 1296) + 2 * (40 + 6 * 36 * 40),
         4 * (4 * 48 + 32 + 2 * 1296) + 2 * (40 + 10 * 36 * 40
                                              + 2 * 48 * 56)),
        ((9, 32, False), 4 * (9 * 24 + 84) + 2 * (40 + 6 * 9 * 40),
         4 * (4 * 16 + 32 + 2 * 84) + 2 * (40 + 10 * 9 * 40 + 2 * 16 * 24)),
        ((49, 32, False), 4 * (49 * 72 + 2404) + 2 * (40 + 6 * 49 * 40),
         4 * (4 * 64 + 32 + 2 * 2404) + 2 * (40 + 10 * 49 * 40
                                              + 2 * 64 * 72)),
        ((49, 38, True), 4 * (2 * 49 * 72 + 2404) + 2 * (56 + 6 * 49 * 56),
         4 * (4 * 64 + 32 + 2 * 2404) + 2 * (56 + 10 * 49 * 56
                                              + 2 * 64 * 72))]


@pytest.mark.parametrize("case", SMEM, ids=lambda c: "-".join(
    map(str, c[0])))
def test_stats_smem_by_layout(case):
    """The Python twin of tc_fwd_stats_smem_bytes and
    tc_bwd_stats_smem_bytes at the models' shapes: the row-1 CTA plus one p
    tile, the row-2 CTA less its bias tile plus two p stages (78 KB at N
    49), each within the card's 227 KB; the backward's does not depend on
    the mask, which it never reads."""
    (N, hd, masked), fwd, bwd = case
    assert F._tc_stats_smem_bytes(N, hd, masked, False) == fwd <= LIMIT
    assert F._tc_stats_smem_bytes(N, hd, masked, True) == bwd <= LIMIT
    assert F._tc_stats_smem_bytes(N, hd, not masked, True) == bwd
    assert fwd == F._tc_smem_bytes(N, hd, masked, False) + 4 * _pf(N)


def test_largest_tile_fits_the_card():
    """N 64 and head dim 64, masked: the largest tile the tensor-core
    route takes fits 227 KB in both kernels."""
    worst = max(F._tc_stats_smem_bytes(n, hd, True, bwd)
                for n in (9, 36, 49, 64) for hd in (32, 38, 64)
                for bwd in (False, True))
    assert worst == F._tc_stats_smem_bytes(64, 64, True, True) <= LIMIT


class _Library:
    """Stands in for the kernels' library: records each entry called and
    its arguments, and returns 0 (no CUDA error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor counts as a CUDA tensor and the library is _Library:
    the wrappers' routing runs to the launch, and nothing launches. The
    occupancy queries are recorded and answer SLOTS CTAs."""
    lib = _Library()
    lib.slots = []

    def slots(entry, index, *args):
        lib.slots.append((entry, *args))
        return SLOTS
    monkeypatch.setattr(F, "_device", lambda t: "cuda")
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(F, "_tc_slots", slots)
    monkeypatch.setattr(F, "_stream", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    for key in F.route_launches:
        monkeypatch.setitem(F.route_launches, key, 0)
    return lib


def _stats_call(N, heads, hd, dtype, masked, nw, monkeypatch):
    """One stats forward and one stats backward on the stand-in card,
    with every torch.empty recorded; returns the shapes made."""
    rng = np.random.default_rng(N + hd)
    B_, C = 2 * nw, heads * hd
    qkv = torch.from_numpy(rng.standard_normal((B_, N, 3 * C)).astype(
        np.float32)).to(dtype)
    scale = torch.full((heads,), 10.0)
    bias16 = torch.zeros(heads, N, N)
    g = torch.from_numpy(rng.standard_normal((B_, N, C)).astype(np.float32))
    mask = torch.zeros(nw, N, N) if masked else None
    made = []
    empty = torch.empty

    def spy(*shape, **kw):
        one = len(shape) == 1 and isinstance(shape[0], (tuple, list))
        made.append((tuple(shape[0]) if one else shape, kw.get("dtype")))
        return empty(*shape, **kw)
    monkeypatch.setattr(torch, "empty", spy)
    out, p = F.window_attention_forward_stats(qkv, scale, bias16, heads,
                                              nw if masked else 1, mask,
                                              out_dtype=dtype)
    grads = F.window_attention_backward_stats(qkv, scale, p, g, heads)
    assert out.shape == (B_, N, C) and p.shape == (B_, heads, N, N)
    assert [t.shape for t in grads] == [(B_, N, 3 * C), (heads,),
                                        (heads, N, N)]
    return made


# (N, heads, hd, dtype, masked, windows per image, tensor cores)
CALLS = [(36, 4, 32, torch.bfloat16, True, 16, True),     # AlterNet50 s2
         (9, 16, 32, torch.bfloat16, False, 4, True),     # s4
         (49, 8, 38, torch.bfloat16, True, 4, True),      # EffiAlter_m
         (36, 8, 32, torch.float32, True, 4, False),      # f32
         (36, 4, 33, torch.bfloat16, False, 1, False)]    # odd head dim


@pytest.mark.parametrize("case", CALLS, ids=lambda c: (
    f"N{c[0]}h{c[1]}d{c[2]}-{str(c[3]).split('.')[-1]}"))
def test_stats_call_takes_its_body_without_a_launch(fake_card, monkeypatch,
                                                    case):
    """A stats forward and backward on a (stand-in) CUDA tensor reach the
    entries of their body, count once each on route_launches by body, and
    the tensor-core ones get the plan's windows per CTA from their own
    occupancy entry (the backward's unmasked: it reads no mask) and a
    partial buffer of one row per CTA and head; the CUDA-core backward's
    holds one row per (window, head)."""
    N, heads, hd, dtype, masked, nw, tc = case
    made = _stats_call(N, heads, hd, dtype, masked, nw, monkeypatch)
    names = [name for name, _ in fake_card.calls]
    suffix = "_tc" if tc else ""
    assert names == [f"window_attn_fwd_stats{suffix}",
                     f"window_attn_bwd_stats{suffix}"]
    body = "tensor_cores" if tc else "cuda_cores"
    assert F.route_launches == {
        "fwd_tensor_cores": int(tc), "fwd_cuda_cores": int(not tc),
        "bwd_tensor_cores": int(tc), "bwd_cuda_cores": int(not tc)}, body
    B_, C, cols = 2 * nw, heads * hd, N * N + 1
    (_, fwd), (_, bwd) = fake_card.calls
    # (qkv, scale, bias16, mask, out, p, B·nW, N, C, heads, nW, ...)
    assert fwd[6:11] == (B_, N, C, heads, nw if masked else 1)
    assert (fwd[3] is None) is not masked
    # (qkv, scale, p, g, dqkv, partial, sums, B·nW, N, C, heads, ...)
    assert bwd[7:11] == (B_, N, C, heads)
    if tc:
        assert fake_card.slots == [
            ("window_attn_stats_tc_occupancy", N, C, heads, int(masked), 0),
            ("window_attn_stats_tc_occupancy", N, C, heads, 0, 1)]
        plan_f = F.tensor_core_plan(B_, nw if masked else 1, heads, masked,
                                    SLOTS)
        wpc_b, ctas = F.tensor_core_plan(B_, 1, heads, False, SLOTS)
        vec = 16 if hd % 8 == 0 else 4
        assert fwd[11:14] == (int(dtype == torch.bfloat16), plan_f[0], vec)
        assert bwd[11:13] == (wpc_b, vec)
        assert ((ctas * heads, cols), torch.float32) in made
    else:
        assert fake_card.slots == []
        code = F._DTYPE_CODE[dtype]
        assert fwd[11:14] == (code, code, F._THREADS)
        assert bwd[11:13] == (code, F._BWD_THREADS)
        assert ((B_ * heads, cols), torch.float32) in made


def test_tensor_core_switch_moves_the_stats_calls(fake_card, monkeypatch):
    """The body follows each call alone: a bf16 stats pair at an odd head
    dim (N 36, head dim 33) takes the CUDA-core kernels, and the bf16 pair
    at the N=49 shape after it (head dim 38) the tensor cores, in that
    order, with the occupancy queried for the tensor-core pair only; the
    AlterNet50 shapes sit on the tile too."""
    for N, heads, hd in ((36, 4, 32), (9, 16, 32), (49, 8, 38)):
        assert F.tensor_core_route(torch.bfloat16, N, hd)
    _stats_call(36, 4, 33, torch.bfloat16, False, 1, monkeypatch)
    _stats_call(49, 8, 38, torch.bfloat16, True, 4, monkeypatch)
    assert [name for name, _ in fake_card.calls] == [
        "window_attn_fwd_stats", "window_attn_bwd_stats",
        "window_attn_fwd_stats_tc", "window_attn_bwd_stats_tc"]
    assert F.route_launches == dict.fromkeys(F.route_launches, 1)
    assert [s[0] for s in fake_card.slots] == [
        "window_attn_stats_tc_occupancy"] * 2


def test_the_models_stats_arm_takes_the_tensor_cores(fake_card, monkeypatch):
    """Under autograd with FR_ATTN_STORED_STATS=1 the per-head entry's bf16
    call runs the tensor-core stats pair, counted on the entry's stats
    counters."""
    monkeypatch.setenv("FR_ATTN_STORED_STATS", "1")
    entry = F.fused_window_attention
    before = (entry.stats_launches, entry.stats_backward_launches)
    arrays = _torch(*_inputs(32, True, seed=3)[:5], torch.bfloat16)
    _autograd(entry, *arrays, 4)
    assert [name for name, _ in fake_card.calls] == [
        "window_attn_fwd_stats_tc", "window_attn_bwd_stats_tc"]
    assert (entry.stats_launches, entry.stats_backward_launches) == (
        before[0] + 1, before[1] + 1)


def test_cpu_stats_pair_matches_interpreted_stats_at_head_dim_38():
    """bf16, head dim 38 (EffiAlter_m), masked: fr_tpu's _fwd_stats and
    _bwd_stats interpreted against the port's CPU pair, the backward fed
    each side's own p."""
    jdt, tdt = DTYPES["bf16"]
    arrays = _inputs(38, True, seed=238)
    qkv, scale, bias16, g, mask = _jax(*arrays[:5], jdt)
    nW = arrays[5]
    ref_out, ref_p = fwa._fwd_stats(qkv, scale, bias16, HEADS, nW, mask,
                                    1024, jdt, interpret=True)
    ref_grads = fwa._bwd_stats(qkv, scale, ref_p, g, HEADS, nW, 1024,
                               interpret=True)
    tq, ts, tb, tg, tm = _torch(*arrays[:5], tdt)
    out, p = F.window_attention_forward_stats(tq, ts, tb, HEADS, nW, tm,
                                              out_dtype=tdt)
    _assert_out(out, ref_out, "bf16")
    np.testing.assert_allclose(p.permute(1, 0, 2, 3).numpy(),
                               np.asarray(ref_p), rtol=0, atol=1e-3)
    _assert_grads(F.window_attention_backward_stats(tq, ts, p, tg, HEADS),
                  ref_grads, "bf16")


# AlterNet50 at 192 px: (N, heads, resolution, window), each masked, bf16
@pytest.mark.parametrize("shape", [(36, 4, 12, 6), (36, 8, 12, 6),
                                   (9, 16, 6, 3)],
                         ids=["N36h4", "N36h8", "N9h16"])
def test_packed_stats_arm_matches_packed_vjp_bf16(shape):
    """bf16 with the shift mask at the three AlterNet50 widths (C 128, 256,
    512): jax.vjp of fr_tpu's packed op with interpret=True and
    stored_stats=True (_pk_fwd_stats_pallas, _pk_bwd_stats_pallas) against
    the port's packed stats arm on the CPU. Scale 10: the packed kernel's
    shared row max needs the heads' scores within ~88 of each other
    (ROADMAP §3)."""
    n, heads, res, ws = shape
    jdt, tdt = DTYPES["bf16"]
    arrays = _inputs(32, True, seed=310 + n + heads, n=n, heads=heads,
                     res=res, ws=ws, scale_range=(10, 10))
    qkv, scale, bias16, g, mask = _jax(*arrays[:5], jdt)
    nW = arrays[5]

    def f(q, s, b):
        return fwa.fused_window_attention_packed(
            q, s, b, heads, nW, mask, 1024, True, jdt, stored_stats=True)

    ref_out, vjp = jax.vjp(f, qkv, scale, bias16)
    ref_grads = vjp(g)
    out, grads = _autograd(F.fused_window_attention_packed,
                           *_torch(*arrays[:5], tdt), nW, stored_stats=True)
    _assert_out(out, ref_out, "bf16")
    _assert_grads(grads, ref_grads, "bf16")
