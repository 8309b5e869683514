"""The all-in-kernel backward's two bodies (row 18b of ROADMAP §2): which
calls take the tensor-core kernels (window_attn_qkv_bwd_tc) and which the
CUDA-core ones, the tensor-core CTA's shared memory and window lanes, the
launch each route makes (with the library replaced, so no card is needed),
and the CPU path against fr_tpu's entry-fused op with _PKX_HYBRID_BWD off
and its all-in-kernel Pallas program interpreted, at the three AlterNet50
widths. The kernels themselves are checked on the card by
test_torch_window_attn_variants_cuda.py.

Tolerance against fr_tpu, max-abs: bf16 3e-2·max(|ref|, 1), as
test_entry_fused_matches_interpreted_pkx holds fr_tpu's packed Pallas
programs (they also round their unnormalised exponentials to bf16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fr_tpu.ops.fused_window_attn_variants as jax_variants
from fr_tpu_torch.models.swin_common import shifted_window_mask
from fr_tpu_torch.ops import fused_window_attn as F
from fr_tpu_torch.ops import fused_window_attn_variants as V
from test_torch_cpu_threads import one_torch_thread  # noqa: F401
from test_torch_qkv_tc import ALTERNET50, LIMIT, _smem_occupancy, _x
from test_torch_qkv_tc import fake_card  # noqa: F401
from test_torch_window_attn_variants import _assert_close, _np


# (N, C, hd, masked, lanes) → bytes, by the layout the kernel states:
# 4·(bias (+ mask) + 3·HDP + lanes·(4·NP + (NT + 1)·3·HDP))
# + 2·(zero row + W slice + lanes·(7 token tiles + 2 NP tiles + x))
def _by_layout(N, C, np_, nt, masked, lanes):
    bias = N * (np_ + 8) * (2 if masked else 1)
    lane_f32 = 4 * np_ + (nt + 1) * 96
    lane_bf16 = 7 * N * 40 + 2 * np_ * (np_ + 8) + N * (C + 8)
    return 4 * (bias + 96 + lanes * lane_f32) + 2 * (
        40 + 96 * (C + 8) + lanes * lane_bf16)


SMEM = [((36, 128, 32, True, 1), _by_layout(36, 128, 48, 3, True, 1)),
        ((36, 128, 32, True, 4), _by_layout(36, 128, 48, 3, True, 4)),
        ((36, 256, 32, False, 3), _by_layout(36, 256, 48, 3, False, 3)),
        ((36, 256, 32, True, 3), _by_layout(36, 256, 48, 3, True, 3)),
        ((9, 512, 32, True, 1), _by_layout(9, 512, 16, 1, True, 1)),
        ((9, 512, 32, False, 7), _by_layout(9, 512, 16, 1, False, 7))]


@pytest.mark.parametrize("case", SMEM, ids=lambda c: "-".join(
    map(str, c[0])))
def test_tensor_core_smem_at_alternet50_shapes(case):
    """The Python twin of qkv_bwd_tc_smem_bytes at the AlterNet50 sites:
    one lane is 84, 109 (117 masked) and 116 KB at C = 128, 256, 512, and
    every site's CTA fits the card's 227 KB with lanes: 4 at C = 128, 3 at
    C = 256, 7 at N = 9."""
    args, expected = case
    assert V._qkv_bwd_tc_smem_bytes(*args) == expected <= LIMIT
    N, C, hd, masked, lanes = args
    # the lane counts above one are the most that fit
    assert lanes == 1 or V._qkv_bwd_tc_smem_bytes(N, C, hd, masked,
                                                  lanes + 1) > LIMIT
    assert V._qkv_bwd_tc_route(_x(N, C), C // hd, masked)


def test_tensor_core_smem_beyond_the_card_takes_the_cuda_cores():
    """N 64 at C = 1024, head dim 64: W's slice alone is 396 KB, so the
    backward takes the CUDA-core kernels, whose block fits."""
    assert V._qkv_bwd_tc_smem_bytes(64, 1024, 64, False, 1) > LIMIT
    assert not V._qkv_bwd_tc_route(_x(64, 1024), 16, False)
    assert V._qkv_smem_bytes(64, 64, True) <= LIMIT


# (N, C, masked, registers, lanes expected, warps an SM then holds)
LANES = [(36, 128, True, 255, 2, 6),    # registers: 255 · 96 · 3 > 64K
         (36, 128, True, 192, 3, 9),    # 192 · 96 · 3 ≤ 64K
         (36, 256, False, 128, 3, 9),   # shared memory ends it at 3
         (9, 512, True, 136, 7, 7)]     # and at 7


@pytest.mark.parametrize("case", LANES, ids=lambda c: "-".join(map(str, c)))
def test_window_lanes_keep_the_most_warps_resident(case):
    """qkv_tc_lanes with the backward's shared memory picks the lanes that
    keep the most warps resident (a tie goes to more lanes)."""
    N, C, masked, regs, lanes, warps = case

    def per_sm(lanes_):
        smem = V._qkv_bwd_tc_smem_bytes(N, C, 32, masked, lanes_) + 1024
        threads = 32 * -(-N // 16) * lanes_
        return min(233472 // smem, 65536 // (regs * threads))
    assert V.qkv_tc_lanes(N, C, 32, masked, per_sm,
                          V._qkv_bwd_tc_smem_bytes) == lanes
    assert per_sm(lanes) * lanes * -(-N // 16) == warps


def test_forward_lanes_keep_their_own_shared_memory():
    """qkv_tc_lanes defaults to the forward's CTA, which admits more
    lanes than the backward's."""
    per_sm = _smem_occupancy(9, 512, 32, False, 80)
    assert V.qkv_tc_lanes(9, 512, 32, False, per_sm) == 11
    assert V.qkv_tc_lanes(9, 512, 32, False, per_sm,
                          V._qkv_bwd_tc_smem_bytes) == 7


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
        assert V._qkv_bwd_tc_route(_x(N, C, dtype), heads, masked) \
            is expected


def test_dw_chunks_fill_the_card():
    """The dW product's row chunks: whole k steps of 32, and about 264
    CTAs (two per SM of an H100) at each AlterNet50 site."""
    for (N, C, *_), windows in zip(ALTERNET50, (2048, 512, 512)):
        rows = windows * N
        chunk = V.qkv_dw_chunk_rows(rows, C)
        tiles = -(-3 * C // 128) * -(-C // 64)
        ctas = tiles * -(-rows // chunk)
        assert chunk % 32 == 0 and 264 <= ctas < 264 + 2 * tiles, (C, ctas)
    assert V.qkv_dw_chunk_rows(40, 128) == 32


def _bwd_call(N, C, heads, dtype, masked, windows_per_img):
    rng = np.random.default_rng(N + C)
    B_ = 2 * windows_per_img
    x = torch.from_numpy(rng.standard_normal((B_, N, C)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((3 * C, C)).astype(np.float32))
    b = torch.zeros(3 * C)
    scale = torch.full((heads,), 10.0)
    bias16 = torch.zeros(heads, N, N)
    g = torch.from_numpy(rng.standard_normal((B_, N, C)).astype(np.float32))
    mask = torch.zeros(windows_per_img, N, N) if masked else None
    return V.qkv_attention_backward(x, w, b, scale, bias16, g, heads,
                                    windows_per_img if masked else 1, mask)


# (N, C, heads, dtype, masked, windows per image, entry)
CALLS = [(36, 128, 4, torch.bfloat16, True, 16, "window_attn_qkv_bwd_tc"),
         (9, 512, 16, torch.bfloat16, False, 4, "window_attn_qkv_bwd_tc"),
         (49, 304, 8, torch.bfloat16, True, 4, "window_attn_qkv_bwd_tc"),
         (36, 256, 8, torch.float32, True, 4, "window_attn_qkv_bwd"),
         (36, 72, 4, torch.bfloat16, False, 1, "window_attn_qkv_bwd")]


@pytest.mark.parametrize("case", CALLS, ids=lambda c: (
    f"N{c[0]}C{c[1]}-{str(c[3]).split('.')[-1]}-{c[6]}"))
def test_cuda_call_takes_its_body_without_a_launch(fake_card, monkeypatch,
                                                   case):
    """A backward on a (stand-in) CUDA tensor reaches the entry of its body
    and counts once on the packed-qkv backward counter and once on
    route_launches by body. The tensor-core entry gets the plan's windows
    per CTA, the window lanes and the dW chunk, and a bf16 dqkv scratch
    (no f32 one); the gradients come back in the contract's shapes."""
    N, C, heads, dtype, masked, nw, entry = case
    made = []
    empty = torch.empty

    def spy(*shape, **kw):
        one = len(shape) == 1 and isinstance(shape[0], (tuple, list))
        made.append((tuple(shape[0]) if one else shape, kw.get("dtype")))
        return empty(*shape, **kw)
    monkeypatch.setattr(torch, "empty", spy)
    before = V.fused_window_attention_packed_qkv.backward_launches
    dx, dw, db, dscale, dbias = _bwd_call(N, C, heads, dtype, masked, nw)
    assert dx.dtype == dtype and dx.shape == (2 * nw, N, C)
    assert (dw.shape, db.shape, dscale.shape, dbias.shape) == (
        (3 * C, C), (3 * C,), (heads,), (heads, N, N))
    [(name, args)] = fake_card.calls
    assert name == entry
    assert V.fused_window_attention_packed_qkv.backward_launches == before + 1
    tc = entry.endswith("_tc")
    assert F.route_launches == {
        "fwd_tensor_cores": 0, "fwd_cuda_cores": 0,
        "bwd_tensor_cores": int(tc), "bwd_cuda_cores": int(not tc)}
    rows = 2 * nw * N
    if tc:
        # (..., B·nW, N, C, heads, n_win_per_img, wpc, lanes, chunk, stream)
        assert args[14:18] == (2 * nw, N, C, heads)
        wpc, lanes, chunk = args[19:22]
        assert lanes == 3 and chunk == V.qkv_dw_chunk_rows(rows, C)
        assert wpc == F.tensor_core_plan(2 * nw, nw if masked else 1, heads,
                                         masked, 264)[0]
        assert ((rows, 3 * C), torch.bfloat16) in made
        assert ((rows, 3 * C), torch.float32) not in made
    else:
        assert args[13:17] == (2 * nw, N, C, heads)
        assert ((rows, 3 * C), torch.float32) in made


def test_tensor_core_switch_moves_the_cuda_call(fake_card):
    """The body follows each call alone: a bf16 all-in-kernel backward at
    C = 72, which _qkv_tc_fits turns away (C % 16 != 0), takes the
    CUDA-core kernels, and the AlterNet50 call after it (C 128) the tensor
    cores, in that order; every AlterNet50 width sits on the tile."""
    assert not V._qkv_bwd_tc_route(_x(36, 72), 4, True)
    for N, C, heads, *_ in ALTERNET50:
        assert V._qkv_bwd_tc_route(_x(N, C), heads, True)
    _bwd_call(36, 72, 4, torch.bfloat16, True, 16)
    _bwd_call(36, 128, 4, torch.bfloat16, True, 16)
    assert [name for name, _ in fake_card.calls] == [
        "window_attn_qkv_bwd", "window_attn_qkv_bwd_tc"]
    assert F.route_launches == {"fwd_tensor_cores": 0, "fwd_cuda_cores": 0,
                                "bwd_tensor_cores": 1, "bwd_cuda_cores": 1}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", ALTERNET50,
                         ids=lambda s: f"N{s[0]}C{s[1]}h{s[2]}")
def test_cpu_backward_matches_interpreted_pkx(shape, masked, monkeypatch):
    """bf16 at the AlterNet50 widths (two images of windows): the port's
    all-in-kernel backward on the CPU (the plain version, no launch)
    against fr_tpu's entry-fused op with _PKX_HYBRID_BWD off, its
    all-in-kernel _pkx_bwd program interpreted: dx, dW (fr_tpu's (C, 3C)
    layout), db, dscale and dbias."""
    N, C, heads, res, ws = shape
    nw = (res // ws) ** 2
    monkeypatch.setattr(jax_variants, "_PKX_HYBRID_BWD", False)
    rng = np.random.default_rng(C + masked)
    x = rng.standard_normal((2 * nw, N, C)).astype(np.float32)
    w = (rng.standard_normal((C, 3 * C)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(3 * C) * 0.1).astype(np.float32)
    scale = rng.uniform(5, 20, heads).astype(np.float32)
    bias16 = (16.0 / (1.0 + np.exp(-rng.standard_normal((heads, N, N))))
              ).astype(np.float32)
    g = rng.standard_normal((2 * nw, N, C)).astype(np.float32)
    mask = shifted_window_mask(res, res, ws, ws // 2) if masked else None
    n_win = nw if masked else 1
    jmask = None if mask is None else jnp.asarray(mask)

    def f(*a):
        return jax_variants.fused_window_attention_packed_qkv(
            *a, heads, n_win, jmask, 1024, True, jnp.bfloat16)

    _, vjp = jax.vjp(f, jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w),
                     jnp.asarray(b), jnp.asarray(scale), jnp.asarray(bias16))
    refs = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    before = V.fused_window_attention_packed_qkv.backward_launches
    ours = V.qkv_attention_backward(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w.T.copy()),
        torch.from_numpy(b), torch.from_numpy(scale),
        torch.from_numpy(bias16), torch.from_numpy(g).to(torch.bfloat16),
        heads, n_win, None if mask is None else torch.from_numpy(mask))
    assert V.fused_window_attention_packed_qkv.backward_launches == before
    assert ours[0].dtype == torch.bfloat16
    ours = [_np(t) for t in ours]
    ours[1] = ours[1].T
    _assert_close(("dx", "dw", "db", "dscale", "dbias"), ours, refs, "bf16",
                  packed=True)
