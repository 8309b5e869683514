"""AlterNetSep, AlterNetV1 and EffiAlterNet's DepthwiseTaps in the PyTorch
port against fr_tpu: the architecture of the named plans, small plans
(fr_tpu tests/test_backbones.py:174,313) on carried weights in eval mode (f32
and bf16) and in train mode, the weight import both ways and the .npz round
trip, DepthwiseTaps at stride 1 and 2, and the full-width AlterNetSep50 and
AlterNetV1_50 goldens at 112 px.

fr_tpu has no torch importer for AlterNetSep or AlterNetV1; weights cross
through the port's table (fr_tpu_torch/utils/jax_import.py), whose names and
shapes the architecture tests hold against fr_tpu's trees. The parity tests
draw the port's weights from a seed (``seeded_state_dict``: every bias,
scale and statistic off its init value) and carry them into fr_tpu's trees,
which fr_tpu's apply takes only if every name and shape is its own; the
round-trip test carries them back.

Inputs come from numpy seeds. Tolerances: f32 embeddings max-abs 1e-4;
bf16 per-row cosine 0.999; train-mode statistics max-abs 1e-4 and outputs
1e-3 (the head's BatchNorm1d normalises by the standard deviation of four
samples, which magnifies the f32 differences of the layers before it);
DepthwiseTaps f32 1e-5 (fr_tpu's own test holds its taps to the conv at
1e-5), bf16 1.5e-2 (a chain of nine bf16 additions on both sides); the
goldens f32 1e-3 (full depth)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen

from fr_tpu.configs.base import Config
from fr_tpu.models import alternet as jax_alternet
from fr_tpu.models import alternet_v1 as jax_v1
from fr_tpu.models import effialternet as jax_effi
from fr_tpu_torch.models import alternet, alternet_v1, effialternet
from fr_tpu_torch.utils import jax_import
from fr_tpu_torch.utils.golden import seeded_state_dict
from test_torch_cpu_threads import one_torch_thread  # noqa: F401
from test_torch_swin import (assert_architecture_matches,
                             assert_weight_round_trips, golden_check,
                             golden_regenerates, jax_embed, port_embed,
                             row_cosine)

IMG = 112
# fr_tpu's small plans: AlterNetSep18 (test_backbones.py:313) at 112 px,
# and the V1 plan of :174 at 56 px, where stage 4's 4×4 map takes 2×2
# windows; both have an attention block in stages 2-4
SEP_SMALL = alternet.ALTERNET_SEP_PLANS["AlterNetSep18"]
V1_SMALL = ((2, 3, 3, 3), (0, 1, 1, 1))
V1_IMG = 56
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _sep_pair(dtype, emd=64):
    jdt, tdt = DTYPES[dtype]
    return (jax_alternet.AlterNetSep(*SEP_SMALL, emd_size=emd, dtype=jdt),
            alternet.AlterNetSep(*SEP_SMALL, emd_size=emd,
                                 compute_dtype=tdt))


def _v1_pair(dtype, emd=48):
    jdt, tdt = DTYPES[dtype]
    return (jax_v1.AlterNetV1(*V1_SMALL, heads=(3, 6, 12, 24), emd_size=emd,
                              dtype=jdt),
            alternet_v1.AlterNetV1(*V1_SMALL, img_size=V1_IMG, emd_size=emd,
                                   compute_dtype=tdt))


# network: (the pair's maker, plan, image size)
PAIRS = {"AlterNetSep": (_sep_pair, SEP_SMALL[:2], IMG),
         "AlterNetV1": (_v1_pair, V1_SMALL, V1_IMG)}


def test_small_plans_have_the_shapes_they_are_for():
    _, sep = _sep_pair("f32")
    blocks = [m for m in sep.modules()
              if isinstance(m, alternet.AlterSwinBlock)]
    # stages 2-4 at 28, 14, 7 px, one window-7 block each; stage 2's
    # 4·49 = 196 ≤ 288 is the packed entry, the others per-head
    assert [(b.attn.num_heads, b.shift, b.attn_mask) for b in blocks] == [
        (4, 0, None), (8, 0, None), (16, 0, None)]
    _, v1 = _v1_pair("f32")
    locs = [m for m in v1.modules()
            if isinstance(m, alternet_v1.LocalAttention)]
    assert [(m.p, m.pos_embedding.shape[0]) for m in locs] == [
        (7, 13), (7, 13), (2, 3)]


@pytest.mark.parametrize("network", ["AlterNetSep50", "AlterNetV1_50"])
def test_named_plans_match_fr_tpu_architecture(network):
    """build_encoder against fr_tpu's parameter shapes (on the meta device:
    nothing allocated), at 112 px."""
    from fr_tpu.models import build_encoder as jax_build_encoder
    from fr_tpu_torch.models import build_encoder

    conf = Config(network=network, img_size=IMG, emd_size=512,
                  mixed_precision=True)
    with torch.device("meta"):
        model = build_encoder(conf)
    cls = alternet_v1.AlterNetV1 if "V1" in network else alternet.AlterNetSep
    assert isinstance(model, cls)
    assert_architecture_matches(jax_build_encoder(conf), model, network, IMG)


def _carried(model, network, size, plan, seed):
    """Seeded weights in the port's model and as fr_tpu's trees."""
    sd = seeded_state_dict(model, seed)
    model.load_state_dict(sd, strict=True)
    return jax_import.encoder_trees_from_state_dict(sd, network, size, plan)


def assert_embeddings_match(enc, model, network, size, plan, dtype, seed):
    """2 images in eval mode: f32 max-abs ≤ 1e-4; bf16 per-row cosine ≥
    0.999."""
    params, stats = _carried(model, network, size, plan, seed)
    x = np.random.default_rng(seed).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    ref = jax_embed(enc, size, params, stats, x)
    out = port_embed(model, size, x)
    if dtype == "f32":
        assert np.abs(out - ref).max() <= 1e-4, np.abs(out - ref).max()
    else:
        assert row_cosine(out, ref).min() >= 0.999, row_cosine(out, ref)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("network", list(PAIRS))
def test_small_plan_matches_fr_tpu(network, dtype):
    make, plan, size = PAIRS[network]
    enc, model = make(dtype)
    assert_embeddings_match(enc, model, network, size, plan, dtype,
                            seed=31 if dtype == "f32" else 32)


def _without_head_dropout(monkeypatch):
    """Both frameworks' head dropout off: fr_tpu's module sees a linen whose
    Dropout is the identity, the port's the identity for ``dropout``."""
    shim = types.ModuleType("linen_without_dropout")
    shim.__dict__.update(vars(linen))
    shim.Dropout = lambda *a, **kw: (lambda x: x)
    for mod in (jax_alternet, jax_v1):
        monkeypatch.setattr(mod, "nn", shim)
    for mod in (alternet, alternet_v1):
        monkeypatch.setattr(mod, "dropout", lambda x, rate, gen: x)


@pytest.mark.parametrize("network", list(PAIRS))
def test_small_plan_train_mode_matches_fr_tpu(network, monkeypatch):
    """Train mode, f32, 4 images, head dropout off on both sides: the
    outputs (BatchNorm on batch statistics) and every updated running
    statistic."""
    _without_head_dropout(monkeypatch)
    make, plan, size = PAIRS[network]
    enc, model = make("f32")
    x = np.random.default_rng(7).standard_normal((4, size, size, 3)).astype(
        np.float32)
    params, stats = _carried(model, network, size, plan, 7)
    ref, new = jax.jit(lambda p, s, v: enc.apply(
        {"params": p, "batch_stats": s}, v, train=True,
        mutable=["batch_stats"]))(params, stats, jnp.asarray(x))
    model.train()
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert np.abs(out - np.asarray(ref)).max() <= 1e-3
    _, ours = jax_import.encoder_trees_from_state_dict(
        model.state_dict(), network, size, plan)
    theirs = jax.tree.leaves(new["batch_stats"])
    assert jax.tree.structure(ours) == jax.tree.structure(
        new["batch_stats"])
    for a, b in zip(jax.tree.leaves(ours), theirs):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 1e-4


@pytest.mark.parametrize("network", list(PAIRS))
def test_weights_and_npz_round_trip(network, tmp_path):
    make, plan, size = PAIRS[network]
    _, model = make("f32")
    assert_weight_round_trips(model, network, size, plan, tmp_path, seed=8)


def test_alternet_v1_at_192_px_fails_in_both():
    """fr_tpu's default_img_size gives AlterNetV1 192 px, where stage 2's
    48×48 map is not whole 7×7 windows: fr_tpu fails to build it and the
    port raises (ROADMAP §3)."""
    from fr_tpu.configs.base import default_img_size
    from fr_tpu_torch.configs.base import default_img_size as port_size

    assert default_img_size("AlterNetV1_50") == port_size(
        "AlterNetV1_50") == 192
    enc, _ = _v1_pair("f32")
    with pytest.raises(TypeError, match="cannot reshape"):
        jax.eval_shape(lambda v: enc.init(jax.random.key(0), v, train=False),
                       jax.ShapeDtypeStruct((1, 192, 192, 3), jnp.float32))
    model = alternet_v1.AlterNetV1(*V1_SMALL, img_size=192, emd_size=48)
    with pytest.raises(ValueError, match="not whole windows"):
        model.eval()(torch.zeros((1, 192, 192, 3)))


# ---------------------------------------------------------------------------
# DepthwiseTaps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_taps_matches_fr_tpu(stride, dtype):
    """fr_tpu's DepthwiseTaps on its own kernel against the port's on the
    same weight (odd and even sizes), and the port's taps against its own
    depthwise conv (f32)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(stride)
    C = 24
    for size in (14, 7):
        x = rng.standard_normal((2, size, size, C)).astype(np.float32)
        k = (0.3 * rng.standard_normal((3, 3, 1, C))).astype(np.float32)
        ref = np.asarray(jax_effi.DepthwiseTaps(C, stride, dtype=jdt).apply(
            {"params": {"Conv_0": {"kernel": k}}},
            jnp.asarray(x).astype(jdt)), np.float32)
        taps = effialternet.DepthwiseTaps(C, stride, tdt)
        with torch.no_grad():
            taps.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
            xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt)
            out = taps(xt).float().permute(0, 2, 3, 1).numpy()
        assert out.shape == ref.shape
        tol = 1e-5 if dtype == "f32" else 1.5e-2 * max(np.abs(ref).max(), 1)
        assert np.abs(out - ref).max() <= tol
        if dtype == "f32":
            conv = effialternet.EConv(C, C, 3, stride, groups=C)
            conv.load_state_dict(taps.state_dict())
            with torch.no_grad():
                assert (conv(xt) - taps(xt)).abs().max().item() <= 1e-5


def test_dw_taps_builds_the_taps_under_the_same_names():
    """conf.dw_taps swaps every SE MBConv's depthwise conv for DepthwiseTaps
    at conv.3, so the two encoders share one state dict and the weight
    table (fr_tpu effialternet.py:166-177)."""
    from fr_tpu_torch.models import build_encoder

    def build(taps):
        with torch.device("meta"):
            return build_encoder(Config(network="EffiAlter_m", img_size=IMG,
                                        emd_size=512, dw_taps=taps))

    plain, taps = build(False), build(True)
    sd_plain, sd_taps = plain.state_dict(), taps.state_dict()
    assert list(sd_plain) == list(sd_taps)
    assert all(sd_plain[k].shape == sd_taps[k].shape for k in sd_plain)
    n_taps = sum(isinstance(m, effialternet.DepthwiseTaps)
                 for m in taps.modules())
    n_se = sum(isinstance(m, effialternet.MBConv) and len(m.conv) == 9
               for m in plain.modules())
    assert n_taps == n_se > 0
    assert not any(isinstance(m, effialternet.DepthwiseTaps)
                   for m in plain.modules())


def test_small_effialternet_with_dw_taps_matches_fr_tpu():
    """The SE stage of test_torch_effialternet's small cfg (a stride-2 and
    a stride-1 SE MBConv) with dw_taps on both sides, f32."""
    from test_torch_effialternet import IMG as EIMG, SMALL

    enc = jax_effi.EffNetV2(cfgs=SMALL, img_size=EIMG, emd_size=64,
                            dw_taps=True)
    model = effialternet.EffNetV2(SMALL, img_size=EIMG, emd_size=64,
                                  dw_taps=True)
    assert_embeddings_match(enc, model, "EffiAlter", EIMG, SMALL, "f32",
                            seed=23)


# ---------------------------------------------------------------------------
# goldens
# ---------------------------------------------------------------------------

GOLDENS = {"AlterNetSep50": jax_alternet.build_alternet_sep,
           "AlterNetV1_50": jax_v1.build_alternet_v1}


@pytest.mark.parametrize("network", list(GOLDENS))
def test_port_matches_golden_f32(network):
    golden_check(network)


def _from_port_table(network):
    """fr_tpu's (encoder, params, stats) for a seeded port state dict: the
    dict crosses through the port's weight table, fr_tpu having no
    importer of its own for these networks."""
    def from_fr_tpu(sd):
        params, stats = jax_import.encoder_trees_from_state_dict(
            sd, network, IMG)
        enc = GOLDENS[network](Config(network=network, img_size=IMG,
                                      emd_size=512, mixed_precision=False))
        return enc, params, stats
    return from_fr_tpu


@pytest.mark.slow
@pytest.mark.parametrize("network", list(GOLDENS))
def test_golden_regenerates_with_jax(network):
    golden_regenerates(network, _from_port_table(network))


# ---------------------------------------------------------------------------
# the attention routes inside the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["spatial", "entry_fused"])
def test_alternet_routes_agree_with_the_windows_route(route, monkeypatch):
    """A small AlterNet (96 px: windows 6, 6, 3 at 12, 6 and 3 px, packed
    shapes, one shifted block per pair) through the spatial route (every
    (window, dim) listed) or with entry_fused on, against the default
    windows route on the same weights: the f32 embeddings in eval mode
    within 1e-5, and every parameter's gradient of a train-mode loss
    norm-wise within 1e-5 (the projections' sums in another order)."""
    from fr_tpu_torch.models import swin_common
    from fr_tpu_torch.models.common import l2_normalize

    plan = ((3, 3, 3, 3), (0, 1, 1, 1), (2, 4, 8, 16))
    model = alternet.AlterNet(*plan, img_size=96, emd_size=64,
                              drop_path_rate=0.0, head_drop=0.0)
    sd = seeded_state_dict(model, 2)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 96, 96, 3)).astype(
        np.float32))
    r = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    calls = []

    def counted(name):
        fn = getattr(swin_common, name)

        def spy(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(swin_common, name, spy)

    def run():
        # train mode moves the BatchNorm statistics: each run starts afresh
        model.load_state_dict(sd, strict=True)
        model.eval()
        with torch.no_grad():
            emb = model(x)
        model.train()
        loss = (l2_normalize(model(x)) * r).sum()
        return emb, torch.autograd.grad(loss, list(model.parameters()))

    ref = run()
    if route == "spatial":
        counted("fused_window_attention_spatial")
        monkeypatch.setattr(swin_common, "SPATIAL_KERNEL_CONFIGS",
                            frozenset({(6, 128), (6, 256), (3, 64)}))
    else:
        counted("fused_window_attention_packed_qkv")
        monkeypatch.setattr(swin_common.WindowAttention, "entry_fused", True)
    ours = run()
    assert len(calls) == 2 * 6          # six sites, eval and train
    assert (ours[0] - ref[0]).abs().max().item() <= 1e-5
    # above a floor of 1e-5 of the largest gradient norm: the biases in
    # front of a BatchNorm get gradients of rounding noise
    floor = 1e-5 * max(b.norm().item() for b in ref[1])
    for a, b in zip(ours[1], ref[1]):
        d = (a - b).norm().item()
        assert max(d - floor, 0.0) <= 1e-5 * b.norm().item()
