"""EffiAlterNet in the PyTorch port against fr_tpu: the architecture of
every named cfg, a small cfg on carried weights in f32 and bf16, the weight
import both ways and the .npz round trip, the family's initialisation, and
the full-width EffiAlter_m golden.

Inputs come from numpy seeds. Tolerances: f32 embeddings max-abs 1e-4;
bf16 per-row cosine 0.999; the golden f32 1e-3 (full depth)."""

import numpy as np
import pytest
import torch

from fr_tpu.configs.base import Config
from fr_tpu.models import effialternet as jax_effi
from fr_tpu_torch.models import effialternet
from fr_tpu_torch.models.common import init_weights
from test_torch_cpu_threads import one_torch_thread  # noqa: F401
from test_torch_swin import (assert_architecture_matches,
                             assert_encoder_matches, assert_weight_round_trips,
                             golden_check, golden_regenerates)

# a fused (no-SE) stage at 28 px, then an SE stage at 14 px whose
# bookkeeping resolution 14 > 7 places a W-MSA/SW-MSA pair: 304 channels
# in 8 heads of 38, heads·N = 392, the per-head attention entry, masked
# and unmasked
SMALL = [[1, 16, 2, 1, 0, 0, 2], [2, 304, 3, 2, 1, 1, 8]]
IMG = 28
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pair(dtype, emd=64):
    import jax.numpy as jnp
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    enc = jax_effi.EffNetV2(cfgs=SMALL, img_size=IMG, emd_size=emd,
                            dtype=jdt)
    model = effialternet.EffNetV2(SMALL, img_size=IMG, emd_size=emd,
                                  compute_dtype=DTYPES[dtype])
    return enc, model


def test_small_cfg_has_the_shapes_it_is_for():
    _, model = _pair("f32")
    fans = [m for m in model.features
            if isinstance(m, effialternet.FANSwinBlock)]
    assert [m.shift for m in fans] == [0, 3]
    assert fans[1].attn_mask.shape == (4, 49, 49)
    assert fans[0].attn.num_heads == 8 and fans[0].attn.qkv.in_features == 304
    kinds = {len(m.conv) for m in model.features
             if isinstance(m, effialternet.MBConv)}
    assert kinds == {5, 9}          # fused and SE MBConvs


@pytest.mark.parametrize("network", sorted(effialternet.EFFIALTER_CFGS))
def test_named_cfgs_match_fr_tpu_architecture(network):
    """build_encoder's EffiAlter_s/m/l/xl against fr_tpu's parameter shapes
    (on the meta device: nothing allocated)."""
    from fr_tpu_torch.models import build_encoder
    from fr_tpu.models import build_encoder as jax_build_encoder

    conf = Config(network=network, img_size=112, emd_size=512,
                  mixed_precision=True)
    with torch.device("meta"):
        model = build_encoder(conf)
    assert isinstance(model, effialternet.EffNetV2)
    assert_architecture_matches(jax_build_encoder(conf), model, network, 112)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_small_effialternet_matches_fr_tpu(dtype):
    enc, model = _pair(dtype)
    assert_encoder_matches(enc, model, "EffiAlter", IMG, SMALL, dtype,
                           seed=21 if dtype == "f32" else 22)


def test_weights_and_npz_round_trip(tmp_path):
    _, model = _pair("f32")
    assert_weight_round_trips(model, "EffiAlter", IMG, SMALL, tmp_path,
                              seed=6)


def test_init_follows_the_family():
    """Truncated normal σ 0.02 cut at ±2σ for the convs, SE, CP and head;
    Xavier for the window attention; zero biases; temperature 1."""
    _, model = _pair("f32")
    init_weights(model, seed=0)
    trunc = torch.cat([m.weight.flatten() for m in model.modules()
                       if getattr(m, "init_std", None)])
    assert abs(trunc.std().item() - 0.02) < 1e-3
    assert trunc.abs().max().item() <= 0.04 / 0.87962566103423978 + 1e-6
    fan = model.features[-1]
    w = fan.attn.qkv.weight
    assert abs(w.std().item() - (2.0 / (w.shape[0] + w.shape[1])) ** 0.5) \
        < 2e-3
    assert torch.equal(fan.chnnel_processing.temperature,
                       torch.ones(8, 1, 1))
    assert float(fan.chnnel_processing.qv.bias.detach().abs().max()) == 0.0


def test_effialter_m_port_matches_golden_f32():
    golden_check("EffiAlter_m")


def _fr_tpu_effialter_m(sd):
    from fr_tpu.utils.torch_import import effialternet_from_torch

    params, stats = effialternet_from_torch(
        sd, jax_effi.EFFIALTER_CFGS["EffiAlter_m"], img_size=112)
    enc = jax_effi.build_effialternet(Config(
        network="EffiAlter_m", img_size=112, emd_size=512,
        mixed_precision=False))
    return enc, params, stats


@pytest.mark.slow
def test_effialter_m_golden_regenerates_with_jax():
    golden_regenerates("EffiAlter_m", _fr_tpu_effialter_m)
