"""The entry-fused forward's two bodies (row 18 of ROADMAP §2): which calls
take the tensor-core kernel (window_attn_qkv_fwd_tc) and which the CUDA-core
one, the tensor-core CTA's shared memory, the launch each route makes (with
the library replaced, so no card is needed), and the CPU path against
fr_tpu's entry-fused op with its Pallas programs interpreted, at the three
AlterNet50 widths. The kernels themselves are checked on the card by
test_torch_window_attn_variants_cuda.py.

Tolerance against fr_tpu, max-abs: bf16 3e-2·max(|ref|, 1), as
test_torch_window_attn_variants.py holds fr_tpu's packed Pallas programs
(they also round their unnormalised exponentials to bf16)."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fr_tpu.ops.fused_window_attn_variants as jax_variants
from fr_tpu_torch.models.swin_common import shifted_window_mask
from fr_tpu_torch.ops import _build
from fr_tpu_torch.ops import fused_window_attn as F
from fr_tpu_torch.ops import fused_window_attn_variants as V
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

LIMIT = 227 * 1024
# AlterNet50 at 192 px: (N, C, heads, resolution, window)
ALTERNET50 = [(36, 128, 4, 24, 6), (36, 256, 8, 12, 6), (9, 512, 16, 6, 3)]


def _x(N, C, dtype=torch.bfloat16, windows=4):
    return torch.zeros((windows, N, C), dtype=dtype)


# (N, C, hd, masked, lanes) → bytes, by the layout the kernel states:
# 4·(bias (+ mask) + 3·HDP) + 2·(zero row + W slice + lanes·(q, k, v + x))
SMEM = [((36, 128, 32, True, 1),
         4 * (2 * 36 * 56 + 96)
         + 2 * (40 + 96 * 136 + (3 * 36 * 40 + 36 * 136))),
        ((36, 256, 32, True, 1),
         4 * (2 * 36 * 56 + 96)
         + 2 * (40 + 96 * 264 + (3 * 36 * 40 + 36 * 264))),
        ((9, 512, 32, True, 1),
         4 * (2 * 9 * 24 + 96)
         + 2 * (40 + 96 * 520 + (3 * 9 * 40 + 9 * 520))),
        ((9, 512, 32, False, 8),
         4 * (9 * 24 + 96)
         + 2 * (40 + 96 * 520 + 8 * (3 * 9 * 40 + 9 * 520)))]


@pytest.mark.parametrize("case", SMEM, ids=lambda c: "-".join(
    map(str, c[0])))
def test_tensor_core_smem_at_alternet50_shapes(case):
    """The Python twin of qkv_tc_smem_bytes at the AlterNet50 sites: W's
    slice is 26, 51 and 100 KB at C = 128, 256, 512, and every site's CTA
    fits the card's 227 KB, at N = 9 with eight window lanes too."""
    args, expected = case
    assert V._qkv_tc_smem_bytes(*args) == expected <= LIMIT
    N, C, hd, masked, _ = args
    assert V._qkv_tc_route(_x(N, C), C // hd, masked)


def test_tensor_core_smem_beyond_the_card_takes_the_cuda_cores():
    """N 64 at C = 1024, head dim 64: W's slice alone is 396 KB, so the
    call takes the CUDA-core kernel, whose block fits."""
    assert V._qkv_tc_smem_bytes(64, 1024, 64, False, 1) > LIMIT
    assert F.tensor_core_route(torch.bfloat16, 64, 64)
    assert not V._qkv_tc_route(_x(64, 1024), 16, False)
    assert V._qkv_smem_bytes(64, 64, False) <= LIMIT


def _smem_occupancy(N, C, hd, masked, regs=96):
    """CTAs an H100 SM holds, from shared memory (228 KB, 1 KB reserved a
    CTA) and registers (64K) alone: a stand-in for the occupancy API."""
    def per_sm(lanes):
        smem = V._qkv_tc_smem_bytes(N, C, hd, masked, lanes) + 1024
        threads = 32 * -(-N // 16) * lanes
        return min(233472 // smem, 65536 // (regs * threads))
    return per_sm


# (N, C, masked, registers, lanes expected, warps an SM then holds)
LANES = [(36, 128, True, 96, 7, 21),    # registers: 96 · 96 · 7 ≤ 64K
         (36, 256, True, 96, 5, 15),    # shared memory ends it at 5
         (9, 512, False, 80, 11, 11),   # and at 11
         (9, 512, False, 255, 8, 8)]    # registers: 255 · 32 · 8 = 65,280


@pytest.mark.parametrize("case", LANES, ids=lambda c: "-".join(map(str, c)))
def test_window_lanes_keep_the_most_warps_resident(case):
    N, C, masked, regs, lanes, warps = case
    per_sm = _smem_occupancy(N, C, 32, masked, regs)
    assert V.qkv_tc_lanes(N, C, 32, masked, per_sm) == lanes
    assert per_sm(lanes) * lanes * -(-N // 16) == warps


def test_window_lanes_tie_goes_to_more_lanes():
    """At equal warps the CTA with more lanes wins (W staged fewer times);
    a lane count that fits no CTA (0 an SM) never does."""
    assert V.qkv_tc_lanes(9, 512, 32, False, lambda lanes: 4 // lanes) == 4
    assert V.qkv_tc_lanes(9, 512, 32, False,
                          lambda lanes: 1 if lanes < 3 else 0) == 2


# (N, C, heads, dtype, expected route)
ROUTES = [(36, 128, 4, torch.bfloat16, True),
          (36, 256, 8, torch.bfloat16, True),
          (9, 512, 16, torch.bfloat16, True),
          (49, 304, 8, torch.bfloat16, True),      # head dim 38: padded
          (36, 256, 8, torch.float32, False),      # f32: CUDA cores
          (36, 72, 4, torch.bfloat16, False),      # C % 16 != 0
          (81, 256, 8, torch.bfloat16, False),     # N beyond the tile
          (36, 132, 4, torch.bfloat16, False)]     # odd head dim 33


@pytest.mark.parametrize("case", ROUTES, ids=lambda c: (
    f"N{c[0]}C{c[1]}h{c[2]}-{str(c[3]).split('.')[-1]}"))
def test_tensor_core_route(case):
    N, C, heads, dtype, expected = case
    for masked in (False, True):
        assert V._qkv_tc_route(_x(N, C, dtype), heads, masked) is expected


def test_tensor_core_switch_puts_the_forward_on_the_cuda_cores():
    """The body follows each call alone: a bf16 entry-fused forward at
    C = 72 (C % 16 != 0) or N = 81 (beyond the tile) goes to the CUDA-core
    kernel, and every AlterNet50 site after it to the tensor cores."""
    for N, C, heads in ((36, 72, 4), (81, 256, 8)):
        assert not V._qkv_tc_route(_x(N, C), heads, True)
        for n, c, h, *_ in ALTERNET50:
            assert V._qkv_tc_route(_x(n, c), h, True)


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
    the wrapper's routing runs to the launch, and nothing launches. The
    card holds 132 SMs of 2 CTAs of 3 window lanes."""
    lib = _Library()
    monkeypatch.setattr(V, "_device", lambda t: "cuda")
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(V, "_qkv_tc_launch", lambda *args: (3, 264))
    monkeypatch.setattr(V, "_stream", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    for key in F.route_launches:
        monkeypatch.setitem(F.route_launches, key, 0)
    return lib


def _entry_call(N, C, heads, dtype, masked, windows_per_img, out_dtype):
    rng = np.random.default_rng(N + C)
    B_ = 2 * windows_per_img
    x = torch.from_numpy(rng.standard_normal((B_, N, C)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((3 * C, C)).astype(np.float32))
    b = torch.zeros(3 * C)
    scale = torch.full((heads,), 10.0)
    bias16 = torch.zeros(heads, N, N)
    mask = torch.zeros(windows_per_img, N, N) if masked else None
    return V.fused_window_attention_packed_qkv(
        x, w, b, scale, bias16, heads, windows_per_img if masked else 1,
        mask, out_dtype=out_dtype)


# (N, C, heads, dtype, masked, windows per image, out dtype, entry)
CALLS = [(36, 128, 4, torch.bfloat16, True, 16, torch.bfloat16,
          "window_attn_qkv_fwd_tc"),
         (9, 512, 16, torch.bfloat16, False, 4, torch.float32,
          "window_attn_qkv_fwd_tc"),
         (49, 304, 8, torch.bfloat16, True, 4, torch.bfloat16,
          "window_attn_qkv_fwd_tc"),
         (36, 256, 8, torch.float32, True, 4, torch.float32,
          "window_attn_qkv_fwd"),
         (36, 72, 4, torch.bfloat16, False, 1, torch.bfloat16,
          "window_attn_qkv_fwd")]


@pytest.mark.parametrize("case", CALLS, ids=lambda c: (
    f"N{c[0]}C{c[1]}-{str(c[3]).split('.')[-1]}-{c[7]}"))
def test_cuda_call_takes_its_body_without_a_launch(fake_card, case):
    """A call on a (stand-in) CUDA tensor reaches the entry of its body
    with the plan's windows per CTA and the window lanes, and counts once
    on the packed-qkv counter and once on route_launches by body."""
    N, C, heads, dtype, masked, nw, out_dtype, entry = case
    before = V.fused_window_attention_packed_qkv.launches
    out = _entry_call(N, C, heads, dtype, masked, nw, out_dtype)
    assert out.dtype == out_dtype and out.shape == (2 * nw, N, C)
    [(name, args)] = fake_card.calls
    assert name == entry
    assert V.fused_window_attention_packed_qkv.launches == before + 1
    tc = entry.endswith("_tc")
    assert F.route_launches == {
        "fwd_tensor_cores": int(tc), "fwd_cuda_cores": int(not tc),
        "bwd_tensor_cores": 0, "bwd_cuda_cores": 0}
    # (..., B·nW, N, C, heads, n_win_per_img, ...) after the seven pointers
    assert args[7:11] == (2 * nw, N, C, heads)
    if tc:
        out_code, wpc, lanes = args[12:15]
        assert (out_code, lanes) == (int(out_dtype == torch.bfloat16), 3)
        assert wpc == F.tensor_core_plan(2 * nw, nw if masked else 1, heads,
                                         masked, 264)[0]


def test_tensor_core_switch_moves_the_cuda_call(fake_card):
    """A bf16 call at C = 72 launches the CUDA-core forward and the
    AlterNet50 call after it (C 128) the tensor-core one, in that order,
    each counted on route_launches by body."""
    _entry_call(36, 72, 4, torch.bfloat16, True, 16, torch.bfloat16)
    _entry_call(36, 128, 4, torch.bfloat16, True, 16, torch.bfloat16)
    assert [name for name, _ in fake_card.calls] == [
        "window_attn_qkv_fwd", "window_attn_qkv_fwd_tc"]
    assert F.route_launches == {"fwd_tensor_cores": 1, "fwd_cuda_cores": 1,
                                "bwd_tensor_cores": 0, "bwd_cuda_cores": 0}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", ALTERNET50,
                         ids=lambda s: f"N{s[0]}C{s[1]}h{s[2]}")
def test_cpu_forward_matches_interpreted_pkx(shape, masked):
    """bf16 at the AlterNet50 widths (two images of windows): the CPU path,
    the plain version with no launch, against fr_tpu's entry-fused op with
    _pkx_fwd interpreted."""
    N, C, heads, res, ws = shape
    nw = (res // ws) ** 2
    rng = np.random.default_rng(C + masked)
    x = rng.standard_normal((2 * nw, N, C)).astype(np.float32)
    w = (rng.standard_normal((C, 3 * C)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(3 * C) * 0.1).astype(np.float32)
    scale = rng.uniform(5, 20, heads).astype(np.float32)
    bias16 = (16.0 / (1.0 + np.exp(-rng.standard_normal((heads, N, N))))
              ).astype(np.float32)
    mask = shifted_window_mask(res, res, ws, ws // 2) if masked else None
    n_win = nw if masked else 1
    ref = jax_variants.fused_window_attention_packed_qkv(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(scale), jnp.asarray(bias16), heads, n_win,
        None if mask is None else jnp.asarray(mask), 1024, True,
        jnp.bfloat16)
    before = V.fused_window_attention_packed_qkv.launches
    out = V.fused_window_attention_packed_qkv(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w.T.copy()),
        torch.from_numpy(b), torch.from_numpy(scale),
        torch.from_numpy(bias16), heads, n_win,
        None if mask is None else torch.from_numpy(mask),
        out_dtype=torch.bfloat16)
    assert V.fused_window_attention_packed_qkv.launches == before
    ref = np.asarray(ref, np.float32)
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 3e-2 * max(float(np.abs(ref).max()), 1.0), err
