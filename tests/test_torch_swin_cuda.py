"""Swin50 and EffiAlter_m at full width on the card, held to fr_tpu's
goldens (tests/data/{swin50,effialter_m}_golden.npz, swin50_train_golden.npz)
through the seeded weights. Imports no jax:

    python -m pytest tests/test_torch_swin_cuda.py --noconftest -q

Tolerances: f32 (TF32 off) embeddings max-abs 1e-3; bf16 per-row cosine
0.99; the training golden as tests/test_torch_swin_train.py states.
Without a CUDA device every test skips with its reason."""

from pathlib import Path

import numpy as np
import pytest
import torch

from fr_tpu_torch.configs.base import Config
from fr_tpu_torch.ops import fused_window_attn as F
from fr_tpu_torch.train.step import make_embed_step
from fr_tpu_torch.utils.golden import (golden_encoder, golden_images,
                                       run_train_golden, seeded_state_dict)

DATA = Path(__file__).parent / "data"
LAUNCHES = {"Swin50": 14, "EffiAlter_m": 4}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("network", list(LAUNCHES))
def test_golden_embeddings_on_card(cuda_device, network, dtype):
    golden = np.load(DATA / f"{network.lower()}_golden.npz")
    seed, ref = int(golden["seed"]), golden["embeddings"]
    model = golden_encoder(network, torch.float32 if dtype == "f32"
                           else torch.bfloat16)
    model.load_state_dict(seeded_state_dict(model, seed), strict=True)
    embed = make_embed_step(Config(img_size=112), model.to(cuda_device),
                            cuda_device)
    before = F.fused_window_attention.launches
    out = embed(golden_images(seed, img_size=112)).cpu().numpy()
    assert F.fused_window_attention.launches - before == LAUNCHES[network]
    if dtype == "f32":
        assert np.abs(out - ref).max() <= 1e-3
    else:
        cos = np.sum(out * ref, axis=1) / (np.linalg.norm(out, axis=1)
                                           * np.linalg.norm(ref, axis=1))
        assert cos.min() >= 0.99


@pytest.mark.cuda
def test_swin50_training_golden_on_card(cuda_device):
    golden = np.load(DATA / "swin50_train_golden.npz")
    before = F.fused_window_attention.backward_launches
    ours = run_train_golden(int(golden["seed"]), cuda_device, "Swin50")
    assert F.fused_window_attention.backward_launches - before == 28
    assert list(ours["update_names"]) == list(golden["update_names"])
    np.testing.assert_allclose(ours["losses"], golden["losses"], rtol=1e-3)
    np.testing.assert_allclose(ours["grad_norms"], golden["grad_norms"],
                               rtol=1e-3)
    np.testing.assert_allclose(ours["update_norms"], golden["update_norms"],
                               rtol=5e-2,
                               atol=1e-3 * golden["update_norms"].max())
