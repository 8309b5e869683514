"""The margin-CE kernels' two bodies (rows 9, 10 and 11 of ROADMAP §2):
which calls take the tensor-core kernels (margin_ce_stats_tc,
margin_ce_grad_emb_tc, margin_ce_grad_w_tc in csrc/margin_ce.cu) and which
the CUDA-core ones, the tensor-core CTAs' shared memory, the launch each
body makes (with the library replaced, so no card is needed) with the split
count and partial buffer its plan gives at the ms1m_arcface_122 and
webface42m heads; which calls of the plain CE (use_fused off) run on the
kernels, with the backward's coefficient as two bf16 terms, and how close
that twin comes to float64; and the port's plain statistics and backward
against fr_tpu's ``_stats_jnp`` and ``_bwd_jnp`` (what fr_tpu's own
``_stats`` and ``_bwd_rule`` run off the TPU) at the shapes the tensor-core
route makes new: three 64-row tiles, ragged classes, D = 48, labels −1,
masked columns, a zero cotangent row and logits beyond [−1, 1]. The kernels
themselves are checked on the card by test_torch_pfc_cuda.py.

Tolerances are those of tests/test_torch_pfc.py (bf16 operands; the f32
products of both sides agree to rtol 2e-4 / atol 1e-6, the statistics to
rtol 1e-5). About 12 s on one torch thread."""

import collections
import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fr_tpu.heads import partial_fc as jax_pfc
from fr_tpu.ops import fused_pfc as jax_fused
from fr_tpu_torch.heads import partial_fc
from fr_tpu_torch.heads.partial_fc import MASK_VALUE, PFCConfig
from fr_tpu_torch.ops import _build
from fr_tpu_torch.ops import fused_pfc as F
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

LIMIT = 227 * 1024
SLOTS = 132   # the stand-in card: 132 SMs of one CTA
# (N, D, K) of the ms1m_arcface_122 head (b 128, emd 512, int(0.3·86,690)
# columns) and of the webface42m head at sample_block 64
MS1M, WEBFACE = (128, 512, 26007), (128, 512, 205952)


def test_route_takes_bf16_with_d_a_multiple_of_16():
    """bf16 with D % 16 == 0, 16 ≤ D ≤ 512, takes the tensor cores; f32,
    D = 40 and D beyond 512 take the CUDA cores."""
    for D in (16, 48, 512):
        assert F.tensor_core_route(torch.bfloat16, D)
    for dtype, D in ((torch.float32, 512), (torch.bfloat16, 40),
                     (torch.bfloat16, 8), (torch.bfloat16, 528)):
        assert not F.tensor_core_route(dtype, D)


def test_smem_fits_the_card_at_every_admitted_width():
    """Three (64, D + 8) bf16 tiles and a (64, 72) coeff tile per term:
    208,896 bytes at D = 512, the widest the route admits, with one term
    and 218,112 with two, within 227 KB."""
    assert F.tc_smem_bytes(512) == 2 * (3 * 64 * 520 + 64 * 72) == 208896
    assert F.tc_smem_bytes(512, 2) == 208896 + 64 * 72 * 2 == 218112
    admitted = [D for D in range(16, 1025, 16)
                if F.tensor_core_route(torch.bfloat16, D)]
    assert max(admitted) == 512
    assert all(F.tc_smem_bytes(D, terms) <= LIMIT for D in admitted
               for terms in (1, 2))


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
    occupancy queries are recorded and answer SLOTS CTAs; every
    torch.empty is recorded in ``lib.made``."""
    lib = _Library()
    lib.slots, lib.made = [], []

    def slots(entry, index, *args):
        lib.slots.append((entry, *args))
        return SLOTS
    empty = torch.empty

    def spy(*shape, **kw):
        one = len(shape) == 1 and isinstance(shape[0], (tuple, list))
        lib.made.append((tuple(shape[0]) if one else shape, kw.get("dtype")))
        return empty(*shape, **kw)
    monkeypatch.setattr(F, "_route", lambda emb: True)
    monkeypatch.setattr(F, "_on_card", lambda t: True)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(F, "_tc_slots", slots)
    monkeypatch.setattr(F, "_stream", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch, "empty", spy)
    for key in F.route_launches:
        monkeypatch.setitem(F.route_launches, key, 0)
    monkeypatch.setattr(partial_fc.shard_softmax_ce, "routes",
                        collections.Counter())
    return lib


def _cfg(dtype, margin="ArcFace", D=512):
    return PFCConfig(num_classes=300000, embedding_size=D, margin=margin,
                     s=30.0, m=0.35, mixed_precision=dtype == torch.bfloat16)


def _backward_call(N, D, K, dtype, terms=1):
    """grad_emb then grad_W on the stand-in card. The operands are left
    unwritten (torch.empty touches no page): nothing reads them."""
    emb, w = torch.empty(N, D, dtype=dtype), torch.empty(K, D, dtype=dtype)
    labels = torch.zeros(N, dtype=torch.int32)
    cv = torch.ones(K, dtype=torch.bool)
    m, d, g = torch.zeros(N), torch.ones(N), torch.ones(N)
    cfg = _cfg(dtype, D=D)
    ge = F.margin_ce_grad_emb(emb, w, labels, cv, m, d, g, cfg, terms)
    gw = F.margin_ce_grad_w(emb, w, labels, cv, m, d, g, cfg, terms)
    assert ge.shape == (N, D) and gw.shape == (K, D)


# (N, D, K, dtype, tensor cores, grad_emb's splits)
CALLS = [(*MS1M, torch.bfloat16, True, 66),
         (*WEBFACE, torch.bfloat16, True, 66),
         (130, 512, 131, torch.bfloat16, True, 3),
         (10, 48, 300, torch.bfloat16, True, 5),
         (128, 512, 64, torch.bfloat16, True, 1),
         (*MS1M, torch.float32, False, 33),
         (10, 40, 131, torch.bfloat16, False, 3)]


@pytest.mark.parametrize("case", CALLS, ids=lambda c: (
    f"{c[0]}x{c[1]}x{c[2]}-{str(c[3]).split('.')[-1]}"))
def test_backward_call_takes_its_body_without_a_launch(fake_card, case):
    """grad_emb and grad_W on a (stand-in) CUDA tensor reach the entries of
    their body with the call's (N, K, D), count once each on
    route_launches by body, and grad_emb gets its split count and an
    (splits, N, D) f32 partial: on the tensor cores one wave of the
    occupancy entry's CTAs over the 64-row tiles (66 at both heads), no
    split without a 64-class tile; on the CUDA cores the 264-block
    heuristic over 16-row tiles."""
    N, D, K, dtype, tc, splits = case
    _backward_call(N, D, K, dtype)
    suffix = "_tc" if tc else ""
    (emb_entry, emb_args), (w_entry, w_args) = fake_card.calls
    assert (emb_entry, w_entry) == (f"margin_ce_grad_emb{suffix}",
                                    f"margin_ce_grad_w{suffix}")
    body = "tensor_cores" if tc else "cuda_cores"
    assert F.route_launches == dict.fromkeys(F.route_launches, 0) | {
        f"grad_emb_{body}": 1, f"grad_w_{body}": 1}
    # (emb, w, labels, col_valid, m, d, g, N, K, D, dtype, kind, s, ...)
    code = F._DTYPE_CODE[dtype]
    assert emb_args[7:11] == w_args[7:11] == (N, K, D, code)
    assert emb_args[18] == splits
    assert ((splits, N, D), torch.float32) in fake_card.made
    assert ((K, D), torch.float32) in fake_card.made
    if tc:
        assert splits == F.tc_splits(N, K, SLOTS)
        # one coefficient term, just before the stream
        assert emb_args[-2] == w_args[-2] == 1
        assert fake_card.slots == [("margin_ce_grad_emb_tc_occupancy", D,
                                    1)]
    else:
        assert splits == F._splits(-(-N // 16), -(-K // 64))
        assert fake_card.slots == []


def test_tensor_core_switch_moves_the_backward(fake_card):
    """The body follows each call alone: at the ms1m and the webface42m
    heads a bf16 pair at D = 40 takes the CUDA-core kernels and the bf16
    pair at D = 512 after it the tensor cores, in that order;
    route_launches counts both by body."""
    for N, D, K in (MS1M, WEBFACE):
        _backward_call(N, 40, K, torch.bfloat16)
        _backward_call(N, D, K, torch.bfloat16)
    assert [name for name, _ in fake_card.calls] == [
        "margin_ce_grad_emb", "margin_ce_grad_w", "margin_ce_grad_emb_tc",
        "margin_ce_grad_w_tc"] * 2
    assert F.route_launches == dict.fromkeys(F.route_launches, 0) | {
        "grad_emb_tensor_cores": 2, "grad_emb_cuda_cores": 2,
        "grad_w_tensor_cores": 2, "grad_w_cuda_cores": 2}


def test_fused_function_backward_reaches_the_tensor_cores(fake_card):
    """Under autograd the fused CE's bf16 forward calls the tensor-core
    stats kernel and its backward the tensor-core pair, and each wrapper
    counts its launch."""
    counts = [f.launches for f in (F.margin_ce_stats, F.margin_ce_grad_emb,
                                   F.margin_ce_grad_w)]
    N, D, K = 130, 48, 131
    emb = torch.zeros(N, D, dtype=torch.bfloat16, requires_grad=True)
    w = torch.zeros(K, D, dtype=torch.bfloat16, requires_grad=True)
    loss = F.fused_margin_softmax_ce(emb, w, torch.zeros(N, dtype=torch.long),
                                     torch.ones(K, dtype=torch.bool),
                                     _cfg(torch.bfloat16, D=D))
    loss.sum().backward()
    assert [name for name, _ in fake_card.calls] == [
        "margin_ce_stats_tc", "margin_ce_grad_emb_tc", "margin_ce_grad_w_tc"]
    assert [f.launches for f in (F.margin_ce_stats, F.margin_ce_grad_emb,
                                 F.margin_ce_grad_w)] == [
        c + 1 for c in counts]


def _edge_problem(n, k, d, seed):
    """Unit rows ×1.5 (so that some logits leave [−1, 1] and take the
    clamp's zero), labels with −1 rows, the last 3 columns masked, one zero
    cotangent row (the 1e-30 clamp's)."""
    rng = np.random.default_rng(seed)

    def unit(rows):
        x = rng.standard_normal((rows, d)).astype(np.float32)
        return 1.5 * x / np.linalg.norm(x, axis=1, keepdims=True)
    emb, w = unit(n), unit(k)
    labels = rng.integers(-1, k - 3, n).astype(np.int32)
    labels[:2] = -1
    col_valid = np.arange(k) < k - 3
    g = rng.uniform(0.5, 1.5, n).astype(np.float32)
    g[5] = 0.0
    return emb, w, labels, col_valid, g


@pytest.mark.parametrize("margin", ["ArcFace", "CosFace"])
def test_plain_backward_matches_bwd_jnp_at_the_new_edges(margin):
    """bf16, N = 130 (three 64-row tiles), K = 131 (ragged), D = 48: the
    port's plain backward and the CPU wrappers (what the card's kernels
    are held to) against fr_tpu's _bwd_jnp, fed fr_tpu's own m and d."""
    N, K, D = 130, 131, 48
    emb, w, labels, col_valid, g = _edge_problem(N, K, D, seed=11)
    cfg = _cfg(torch.bfloat16, margin, D)
    jcfg = jax_pfc.PFCConfig(**dataclasses.asdict(cfg))
    je, jw = jnp.asarray(emb, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    jl, jc = jnp.asarray(labels), jnp.asarray(col_valid)
    m, d, _ = jax_fused._stats_jnp(je, jw, jl, jc, jcfg)
    ref = jax_fused._bwd_jnp(je, jw, jl, jc, m, d, jnp.asarray(g), jcfg)
    te = torch.from_numpy(emb).bfloat16()
    tw = torch.from_numpy(w).bfloat16()
    args = (te, tw, torch.from_numpy(labels), torch.from_numpy(col_valid),
            torch.from_numpy(np.array(m)), torch.from_numpy(np.array(d)),
            torch.from_numpy(g))
    raw = te.float() @ tw.float().t()
    assert bool((raw.abs() > 1).any()), "no logit beyond [-1, 1]"
    ours = F.margin_ce_backward_reference(*args, cfg)
    wrappers = (F.margin_ce_grad_emb(*args, cfg),
                F.margin_ce_grad_w(*args, cfg))
    for a, b, c in zip(ours, wrappers, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=2e-4,
                                   atol=1e-6)
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    # the row whose cotangent the clamp zeroed has no gradient
    assert not bool(ours[0][5].any())


def test_stats_smem_fits_the_card_at_every_admitted_width():
    """The tensor-core stats CTA holds three (64, D + 8) bf16 tiles, the
    resident emb tile and two W stages, and five mbarriers: 199,720 bytes
    at D = 512, within 227 KB at every width the route admits."""
    assert F.stats_tc_smem_bytes(512) == 2 * 3 * 64 * 520 + 40 == 199720
    assert all(F.stats_tc_smem_bytes(D) <= LIMIT for D in range(16, 513, 16))


def _stats_call(N, D, K, dtype):
    """The stats wrapper on the stand-in card (operands left unwritten)."""
    emb, w = torch.empty(N, D, dtype=dtype), torch.empty(K, D, dtype=dtype)
    out = F.margin_ce_stats(emb, w, torch.zeros(N, dtype=torch.int32),
                            torch.ones(K, dtype=torch.bool),
                            _cfg(dtype, D=D))
    assert [tuple(x.shape) for x in out] == [(N,)] * 3


# (N, D, K, dtype, tensor cores, splits)
STATS_CALLS = [(*MS1M, torch.bfloat16, True, 66),
               (*WEBFACE, torch.bfloat16, True, 66),
               (130, 512, 131, torch.bfloat16, True, 3),
               (10, 48, 65, torch.bfloat16, True, 2),
               (128, 512, 64, torch.bfloat16, True, 1),
               (*MS1M, torch.float32, False, 66),
               (10, 40, 131, torch.bfloat16, False, 3)]


@pytest.mark.parametrize("case", STATS_CALLS, ids=lambda c: (
    f"{c[0]}x{c[1]}x{c[2]}-{str(c[3]).split('.')[-1]}"))
def test_stats_call_takes_its_body_without_a_launch(fake_card, case):
    """The stats on a (stand-in) CUDA tensor reach the entry of their body
    with the call's (N, K, D), count once on route_launches by body, and
    get their split count and a (3, splits, N) f32 partial: on the tensor
    cores one wave of margin_ce_stats_tc_occupancy's CTAs over the 64-row
    tiles (66 at both heads), no split without a 64-class tile; on the
    CUDA cores the 264-block heuristic over 32-row tiles."""
    N, D, K, dtype, tc, splits = case
    _stats_call(N, D, K, dtype)
    ((entry, args),) = fake_card.calls
    assert entry == "margin_ce_stats" + ("_tc" if tc else "")
    body = "tensor_cores" if tc else "cuda_cores"
    assert F.route_launches == dict.fromkeys(F.route_launches, 0) | {
        f"stats_{body}": 1}
    # (emb, w, labels, col_valid, N, K, D, dtype, kind, s, ..., splits, ...)
    assert args[4:8] == (N, K, D, F._DTYPE_CODE[dtype])
    assert args[15] == splits
    assert ((3, splits, N), torch.float32) in fake_card.made
    if tc:
        assert splits == F.tc_splits(N, K, SLOTS)
        assert fake_card.slots == [("margin_ce_stats_tc_occupancy", D)]
    else:
        assert splits == F._splits(-(-N // 32), -(-K // 64))
        assert fake_card.slots == []


def test_tensor_core_switch_moves_the_stats(fake_card):
    """The body follows each call alone: at the ms1m and the webface42m
    heads the bf16 stats at D = 40 take the CUDA-core kernel and the bf16
    stats at D = 512 after them the tensor cores, in that order;
    route_launches counts the stats by body."""
    for N, D, K in (MS1M, WEBFACE):
        _stats_call(N, 40, K, torch.bfloat16)
        _stats_call(N, D, K, torch.bfloat16)
    assert [name for name, _ in fake_card.calls] == [
        "margin_ce_stats", "margin_ce_stats_tc"] * 2
    assert F.route_launches == dict.fromkeys(F.route_launches, 0) | {
        "stats_tensor_cores": 2, "stats_cuda_cores": 2}


@pytest.mark.parametrize("margin", ["ArcFace", "CosFace"])
@pytest.mark.parametrize("K", [65, 131])
def test_plain_stats_match_stats_jnp_at_the_new_edges(margin, K):
    """bf16, N = 130 (three 64-row tiles), K = 65 and 131 (ragged last
    class tiles of 1 and 3 classes), D = 48, labels −1, the last 3 columns
    masked, logits beyond [−1, 1]: the port's plain statistics and the CPU
    wrapper (what the card's kernels are held to) against fr_tpu's
    _stats_jnp."""
    N, D = 130, 48
    emb, w, labels, col_valid, _ = _edge_problem(N, K, D, seed=K)
    cfg = _cfg(torch.bfloat16, margin, D)
    jcfg = jax_pfc.PFCConfig(**dataclasses.asdict(cfg))
    ref = jax_fused._stats_jnp(jnp.asarray(emb, jnp.bfloat16),
                               jnp.asarray(w, jnp.bfloat16),
                               jnp.asarray(labels), jnp.asarray(col_valid),
                               jcfg)
    te, tw = torch.from_numpy(emb).bfloat16(), torch.from_numpy(w).bfloat16()
    args = (te, tw, torch.from_numpy(labels), torch.from_numpy(col_valid))
    assert bool(((te.float() @ tw.float().t()).abs() > 1).any()), \
        "no logit beyond [-1, 1]"
    ours = F.margin_ce_stats_reference(*args, cfg)
    for a, b, c in zip(ours, F.margin_ce_stats(*args, cfg), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5)
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    # rows without a target have t = 0
    assert not bool(ours[2][torch.from_numpy(labels) < 0].any())


# The plain CE's route (use_fused off): (on the card, dtype, D, margin,
# on the kernels). Only a CUDA tensor in bf16 at a tensor-core width, with
# a margin the kernels know, leaves plain PyTorch.
PLAIN_ROUTES = [(True, torch.bfloat16, 512, "CosFace", True),
                (True, torch.bfloat16, 512, "ArcFace", True),
                (True, torch.float32, 512, "CosFace", False),
                (True, torch.bfloat16, 40, "CosFace", False),
                (True, torch.bfloat16, 512, "SphereFace", False),
                (False, torch.bfloat16, 512, "CosFace", False)]


@pytest.mark.parametrize("case", PLAIN_ROUTES, ids=lambda c: (
    f"{'card' if c[0] else 'cpu'}-{str(c[1]).split('.')[-1]}-D{c[2]}-"
    f"{c[3]}"))
def test_plain_route_takes_the_kernels_only_where_they_fit(request, case):
    """plain_kernel_route reads the call's device, compute dtype, width and
    margin; shard_softmax_ce (use_fused off) follows it, launches nothing
    on plain PyTorch and the stats and the two-term pair on the kernels,
    and counts the call on shard_softmax_ce.routes."""
    card, dtype, D, margin, kernels = case
    lib = request.getfixturevalue("fake_card") if card else None
    cfg = _cfg(dtype, margin, D)
    N, K = 8, 130
    emb = torch.zeros(N, D, dtype=cfg.compute_dtype)
    assert F.plain_kernel_route(emb, cfg) == kernels
    if margin not in F._MARGIN_CODE:
        return   # no margin function either: the plain CE cannot run it
    routes = partial_fc.shard_softmax_ce.routes
    before = routes.copy()
    e = torch.randn(N, D).requires_grad_(True)
    w = torch.randn(K, D).requires_grad_(True)
    loss = partial_fc.shard_softmax_ce(
        cfg, e, torch.arange(N), w, torch.ones(K, dtype=torch.bool))
    loss.sum().backward()
    route = "plain_kernels" if kernels else "plain_torch"
    assert routes - before == collections.Counter({route: 1})
    if card:
        assert [name for name, _ in lib.calls] == (
            ["margin_ce_stats_tc", "margin_ce_grad_emb_tc",
             "margin_ce_grad_w_tc"] if kernels else [])


@pytest.mark.parametrize("use_fused", [False, True], ids=["plain", "fused"])
def test_backward_terms_follow_the_route(fake_card, use_fused):
    """On the (stand-in) card the plain CE's backward reaches the
    tensor-core pair with two coefficient terms, counted as _2term, and
    use_fused's with one, counted as before; grad_emb's splits come from
    the occupancy of the body with that many terms."""
    N, D, K = 130, 48, 131
    cfg = dataclasses.replace(_cfg(torch.bfloat16, "CosFace", D),
                              use_fused=use_fused)
    e = torch.randn(N, D).requires_grad_(True)
    w = torch.randn(K, D).requires_grad_(True)
    partial_fc.shard_softmax_ce(cfg, e, torch.arange(N), w,
                                torch.ones(K, dtype=torch.bool)
                                ).sum().backward()
    terms = 1 if use_fused else 2
    names = [name for name, _ in fake_card.calls]
    assert names == ["margin_ce_stats_tc", "margin_ce_grad_emb_tc",
                     "margin_ce_grad_w_tc"]
    # the number of terms is the argument before the stream
    assert [args[-2] for _, args in fake_card.calls[1:]] == [terms, terms]
    suffix = "" if use_fused else "_2term"
    assert F.route_launches == dict.fromkeys(F.route_launches, 0) | {
        "stats_tensor_cores": 1, f"grad_emb_tensor_cores{suffix}": 1,
        f"grad_w_tensor_cores{suffix}": 1}
    assert ("margin_ce_grad_emb_tc_occupancy", D, terms) in fake_card.slots
    assert partial_fc.shard_softmax_ce.routes == collections.Counter(
        {"fused" if use_fused else "plain_kernels": 1})


def test_two_terms_need_the_tensor_cores(fake_card):
    """The CUDA-core pair rounds the coefficient to the compute dtype, so a
    two-term call at a width the tensor cores do not take is refused."""
    with pytest.raises(ValueError, match="coefficient terms"):
        _backward_call(10, 40, 131, torch.bfloat16, terms=2)


def _float64_plain_grads(te, tw, labels, col_valid, g, cfg):
    """Gradients of Σ g·loss of the plain CE (partial_fc.plain_softmax_ce's
    arithmetic) in float64 from the same bf16 operands."""
    e = te.double().requires_grad_(True)
    w = tw.double().requires_grad_(True)
    logits = torch.clamp(e @ w.t(), -1.0, 1.0)
    logits = cfg.margin_fn()(logits, labels)
    logits = torch.where(col_valid[None, :], logits, MASK_VALUE)
    ex = torch.exp(logits - logits.amax(dim=1, keepdim=True).detach())
    tgt_ex = torch.gather(ex, 1, torch.clamp_min(labels, 0)[:, None])[:, 0]
    tgt = torch.where(labels >= 0, tgt_ex, 0.0) / ex.sum(dim=1)
    loss = -torch.log(torch.clamp_min(tgt, 1e-30))
    return torch.autograd.grad((g.double() * loss).sum(), [e, w])


@pytest.mark.parametrize("margin", ["ArcFace", "CosFace"])
def test_two_term_twin_is_closer_to_float64_than_one_term(margin):
    """The plain twin of the kernels' backward with the coefficient as two
    bf16 terms (the plain route's contract) against float64 autograd of the
    plain CE: within 1e-5 norm-wise, and over 20 times closer than the
    one-term twin (use_fused's contract), which the coefficient's bf16
    rounding keeps near 1e-3. bf16, N = 130, K = 131, D = 48, the edges of
    _edge_problem."""
    N, K, D = 130, 131, 48
    emb, w, labels, col_valid, g = _edge_problem(N, K, D, seed=21)
    cfg = _cfg(torch.bfloat16, margin, D)
    te, tw = torch.from_numpy(emb).bfloat16(), torch.from_numpy(w).bfloat16()
    lab, cv = torch.from_numpy(labels).long(), torch.from_numpy(col_valid)
    gt = torch.from_numpy(g)
    ref = _float64_plain_grads(te, tw, lab, cv, gt, cfg)
    m, d, t = F.margin_ce_stats_reference(te, tw, lab, cv, cfg)
    # the cotangent as _FusedMarginCE.backward passes it: zero on the rows
    # under the 1e-30 clamp (here those without a target)
    gt = torch.where(t / d >= 1e-30, gt, 0.0)
    err = {}
    for terms in (1, 2):
        twin = F.margin_ce_backward_reference(te, tw, lab, cv, m, d, gt, cfg,
                                              terms)
        err[terms] = max(((a.double() - b).norm() / b.norm()).item()
                         for a, b in zip(twin, ref))
        wrappers = (F.margin_ce_grad_emb(te, tw, lab, cv, m, d, gt, cfg,
                                         terms),
                    F.margin_ce_grad_w(te, tw, lab, cv, m, d, gt, cfg, terms))
        for a, b in zip(wrappers, twin):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert err[2] <= 1e-5, err
    assert err[2] * 20 <= err[1], err
