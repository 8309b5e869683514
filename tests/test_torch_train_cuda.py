"""The training slice's parts on the card: BatchNorm's flax-style running
update through cuDNN, dropout and DropPath under CUDA generators, and one
training step of a small AlterNet with use_fused on, launching every kernel
of the path. Imports no jax, so it also runs on a machine without it:

    python -m pytest tests/test_torch_train_cuda.py --noconftest -q

Without a CUDA device every test skips with its reason."""

import pytest
import torch

from fr_tpu_torch.configs.base import Config
from fr_tpu_torch.heads.partial_fc import PFCConfig
from fr_tpu_torch.models.alternet import AlterNet
from fr_tpu_torch.models.common import BatchNorm2d, dropout, init_weights
from fr_tpu_torch.models.swin_common import DropPath
from fr_tpu_torch.ops import fused_pfc
from fr_tpu_torch.ops.fused_window_attn import (
    fused_window_attention_packed, window_attention_backward)
from fr_tpu_torch.train.state import init_train_state
from fr_tpu_torch.train.step import make_train_step


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_batchnorm_update_on_card_equals_cpu(cuda_device):
    """The CPU update is held to flax's by test_torch_train_parts.py; the
    card's, through cuDNN, equals it to 1e-6."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 16, 3, 3, generator=gen) * 2 + 0.5
    bns = []
    for dev in ("cpu", cuda_device):
        bn = BatchNorm2d(16).to(dev).train()
        bn.running_var.fill_(0.7)
        bn(x.to(dev).contiguous(memory_format=torch.channels_last))
        bns.append(bn)
    for name in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(bns[1], name).cpu(),
                                   getattr(bns[0], name), rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_random_layers_follow_their_cuda_generator(cuda_device):
    x = torch.ones((64, 8, 2, 2), device=cuda_device)
    dp = DropPath(0.25).train()
    a = dp(x, torch.Generator(device=cuda_device).manual_seed(1))
    b = dp(x, torch.Generator(device=cuda_device).manual_seed(1))
    assert torch.equal(a, b)
    y = dropout(torch.ones(20000, device=cuda_device), 0.5,
                torch.Generator(device=cuda_device).manual_seed(2))
    assert abs(float((y == 0).float().mean()) - 0.5) < 0.02


@pytest.mark.cuda
def test_small_alternet_step_launches_every_kernel(cuda_device):
    plan = ((3, 3, 3, 3), (0, 1, 1, 1), (2, 4, 8, 16))
    conf = Config(optimizer_name="SGD", wd=5e-4, mom=0.9)
    model = init_weights(AlterNet(*plan, img_size=96, emd_size=64,
                                  compute_dtype=torch.bfloat16))
    cfg = PFCConfig(300, 64, sample_rate=0.5, margin="ArcFace", s=30.0,
                    m=0.35, mixed_precision=True, use_fused=True)
    state = init_train_state(conf, model, cfg, cuda_device)
    step = make_train_step(conf, cfg, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    images = torch.randn(4, 96, 96, 3, device=cuda_device, generator=gen)
    labels = torch.randint(0, 300, (4,), device=cuda_device, generator=gen)
    counters = (fused_window_attention_packed, window_attention_backward,
                fused_pfc.margin_ce_stats, fused_pfc.margin_ce_grad_emb,
                fused_pfc.margin_ce_grad_w)
    before = [c.launches for c in counters]
    m = step(state, images, labels, 0.05)
    torch.cuda.synchronize()
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    # 3 swin pairs = 6 attention sites; one margin-CE launch of each kind
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [6, 6, 1, 1, 1]
