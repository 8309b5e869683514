"""The ViT encoder (fr_tpu_torch/models/vit.py) and its global attention
(ops/global_attn.py) against the benchmark's plain float32 reference of
the same family (benchmark/reference/families/vit.py), which imports
nothing of either package. fr_tpu has no ViT, so the reference is the
oracle.

A tiny model of the family, the ``ViT_T`` preset (36 px, patch 9: 16
tokens; 3 blocks of width 64, 4 heads; 25% of the tokens masked; drop
path 0.05), takes the reference's seeded weights, so both compute in
float32 on the same values: evaluation embeddings, training embeddings
and every gradient under one generator seed (the masking noise and the
drop-path draws), the mask token's gradient, the attention's plain route,
its calls by entry over a step, and a whole AdamW step with grouped row
sampling on the port's normal path (``load_config`` → task → step).

The CPU tests take a few seconds on one worker. The tests marked ``cuda``
hold the flash route against the plain one on the card; the file imports
no jax, so there:

    python -m pytest tests/test_torch_vit.py --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.loops.train import load_weights
from benchmark.reference.encoders import identity
from benchmark.reference.families import vit as ref_vit
from fr_tpu_torch.configs import load_config
from fr_tpu_torch.models import build_encoder
from fr_tpu_torch.models.common import init_weights
from fr_tpu_torch.models.vit import VIT_PRESETS, VisionTransformer
from fr_tpu_torch.ops.global_attn import (attention_reference,
                                          global_attention,
                                          tensor_core_attention)
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

IMG, EMB, BATCH = 36, 32, 8
MODEL = {"kind": "vit", "img_size": IMG, "emd_size": EMB,
         **VIT_PRESETS["ViT_T"]}
# The program and the reference run the same float32 operations on the
# same values; what differs is only how some are grouped (the program adds
# a linear layer's bias after the product, the reference inside the same
# expression; BatchNorm's plain version normalises through its own f32
# path), so they agree to a few float32 ulps of the largest value. 1e-5
# relative leaves two orders of magnitude above the 3e-7 seen.
F32_REL = 1e-5


def _rel(a, b) -> float:
    a, b = a.detach(), b.detach()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _pair(seed=3):
    """(the program's tiny ViT in f32, the reference's parameters), the
    same weights and BatchNorm statistics in both."""
    params = inputs.encoder_params(MODEL, seed, "cpu")
    enc = init_weights(VisionTransformer(img_size=IMG, emd_size=EMB,
                                         **VIT_PRESETS["ViT_T"]), 0)
    load_weights(enc, params)
    return enc, params


def _images(seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((BATCH, IMG, IMG, 3), generator=g) * 2.0 - 1.0


def _leaves(params):
    return {n: v.clone().requires_grad_(True) for n, v in params.items()
            if not n.endswith(("running_mean", "running_var"))}


def test_parameters_are_insightfaces_in_the_references_order():
    enc, params = _pair()
    names = [n for n, _ in enc.named_parameters()]
    assert names == [n for n, _, _ in ref_vit.param_spec(MODEL)]
    assert names[:4] == ["pos_embed", "mask_token", "patch_embed.proj.weight",
                         "patch_embed.proj.bias"]
    assert "blocks.2.attn.qkv.bias" not in names
    assert enc.n_keep == ref_vit.kept_tokens(MODEL) == 12


def test_evaluation_embeddings_match_the_reference():
    enc, params = _pair()
    x = _images()
    with torch.no_grad():
        got = enc.eval()(x)
        want = ref_vit.forward(MODEL, params, x, False, None, identity)
    assert _rel(got, want) < F32_REL


def test_training_embeddings_and_every_gradient_match_the_reference():
    enc, params = _pair()
    x = _images(1)
    enc.train()
    got = enc(x, torch.Generator().manual_seed(11))
    leaves = _leaves(params)
    want = ref_vit.forward(MODEL, {**params, **leaves}, x, True,
                           torch.Generator().manual_seed(11), identity)
    assert _rel(got, want) < F32_REL
    w = torch.randn(want.shape, generator=torch.Generator().manual_seed(2))
    names, ours = zip(*enc.named_parameters())
    g_got = torch.autograd.grad((got * w).sum(), ours)
    g_want = torch.autograd.grad((want * w).sum(), [leaves[n] for n in names])
    worst = max((_rel(a, b), n) for a, b, n in zip(g_got, g_want, names))
    assert worst[0] < F32_REL, worst
    # the draws were the same: a seed's another draw gives other embeddings
    other = ref_vit.forward(MODEL, params, x, True,
                            torch.Generator().manual_seed(12), identity)
    assert _rel(other.detach(), want.detach()) > 1e-2


def test_the_mask_tokens_gradient_comes_from_the_dropped_places_only():
    """Its gradient is the sum, over the places masking dropped, of the
    gradient that reaches the restored tokens; in evaluation, where no
    place is dropped, it takes none."""
    enc, _ = _pair()
    x = _images(2)
    seen = []

    def keep_input(module, args):
        args[0].retain_grad()
        seen.append(args[0])
    enc.feature.register_forward_pre_hook(keep_input)
    enc.train()
    out = enc(x, torch.Generator().manual_seed(5))
    out.square().sum().backward()
    n, d = enc.num_patches, MODEL["embed_dim"]
    g = seen[0].grad.reshape(BATCH, n, d)
    noise = torch.rand((BATCH, n), generator=torch.Generator().manual_seed(5))
    dropped = torch.argsort(noise, dim=1, stable=True)[:, enc.n_keep:]
    want = torch.gather(g, 1, dropped[:, :, None].expand(-1, -1, d)).sum(
        (0, 1))
    got = enc.mask_token.grad.reshape(d)
    assert got.norm() > 0 and _rel(got, want) < F32_REL
    enc.zero_grad(set_to_none=True)
    enc.eval()(x).square().sum().backward()
    assert enc.mask_token.grad is None


def _plain_attention(q, k, v, scale):
    return torch.softmax((q @ k.transpose(-1, -2)) * scale, -1) @ v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_global_attention_on_the_cpu_is_the_plain_math(dtype):
    """Forward and backward of the CPU route against autograd through the
    plain math in float64: to f32 rounding for f32 inputs; bf16 inputs
    are computed in f32 and only the results rounded, so they agree to
    bf16's half ulp (2⁻⁹ relative) and a little."""
    g = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn((2, 4, 12, 16), generator=g) for _ in
                     range(4))
    scale = 16 ** -0.5
    qs, ks, vs = (t.to(dtype).requires_grad_(True) for t in (q, k, v))
    out = global_attention(qs, ks, vs, scale)
    assert out.dtype == dtype and out.shape == q.shape
    dq, dk, dv = torch.autograd.grad(out, (qs, ks, vs), dout.to(dtype))
    q64, k64, v64 = (t.detach().double().requires_grad_(True)
                     for t in (qs, ks, vs))
    want = _plain_attention(q64, k64, v64, scale)
    wq, wk, wv = torch.autograd.grad(want, (q64, k64, v64),
                                     dout.to(dtype).double())
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    for a, b in ((out, want), (dq, wq), (dk, wk), (dv, wv)):
        assert _rel(a.double(), b) < tol


def _near_mean(shape, spread, generator, device="cpu"):
    """bf16 q, k or v whose tokens lie ``spread`` about a mean they share
    (per image and head), as in the deeper blocks of a ViT at init."""
    b, h, n, d = shape
    mean = torch.randn((b, h, 1, d), generator=generator, device=device)
    return (mean + spread * torch.randn(shape, generator=generator,
                                        device=device)).to(torch.bfloat16)


def _grads_against_float64(fn, shape, spread, device="cpu"):
    """Relative errors of fn's (dq, dk, dv) against autograd in float64,
    at bf16 inputs whose tokens lie ``spread`` about their mean."""
    g = torch.Generator(device=device).manual_seed(4)
    q, k, v = (_near_mean(shape, spread, g, device) for _ in range(3))
    dout = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
    scale = shape[-1] ** -0.5
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(fn(*leaves, scale), leaves, dout)
    wide = [t.double().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(_plain_attention(*wide, scale), wide,
                               dout.double())
    return [_rel(a.double(), b) for a, b in zip(got, want)]


def test_the_cards_backward_keeps_dq_where_tokens_are_near_their_mean():
    """The card's backward is autograd through ``tensor_core_attention``
    (bf16 products, f32 softmax); here on the CPU at tokens 0.03 about
    their mean, where the true dq is a thousandth of dv's size. Its rows of
    the scores' gradient sum to nought with the probabilities they were
    made from, so dq stays within 0.08 of float64 (bf16 rounding of q, k
    and the scores; 0.25 leaves three times that), where a backward that
    takes each row's Σⱼ Pᵢⱼ dPᵢⱼ from the bf16 output, as flash's does,
    is off by about 20 times dq's norm."""
    errors = _grads_against_float64(tensor_core_attention, (2, 4, 136, 96),
                                    0.03)
    assert max(errors) < 0.25, errors


def test_attention_calls_by_entry_over_one_step():
    """One training step through the normal path calls the attention
    forward once a block and its backward once a block; an evaluation
    call the forward alone."""
    task = _task()
    images, labels = _batch(task.conf)
    global_attention.launches.clear()
    task.training_step((images, labels))
    depth = VIT_PRESETS["ViT_T"]["depth"]
    assert dict(global_attention.launches) == {"fwd": depth, "bwd": depth}
    global_attention.launches.clear()
    task._embed(np.zeros((2, IMG, IMG, 3), np.float32))
    assert dict(global_attention.launches) == {"fwd": depth}


def _task():
    """The normal path: load_config of webface42m with the tiny preset,
    AdamW at the ViT-L recipe's lr and weight decay, grouped sampling of
    4-row groups over a 64-class head."""
    from fr_tpu_torch.train.task import FaceRecognitionTask
    conf = load_config("webface42m", network="ViT_T", optimizer="AdamW",
                       lr=0.001, wd=0.1, sample_rate=0.5, sample_block=4,
                       img_size=IMG, emd_size=EMB, b=BATCH, n_classes=64,
                       mixed_precision=False)
    task = FaceRecognitionTask(conf, stage="train", device="cpu", seed=0)
    task.epoch = conf.warmup_steps
    return task


def _batch(conf, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, 256, (BATCH, IMG, IMG, 3),
                                         dtype=np.uint8)),
            torch.as_tensor(rng.integers(0, conf.n_classes, BATCH)))


def test_adamw_step_with_grouped_sampling_on_the_normal_path():
    task = _task()
    assert isinstance(task.encoder, VisionTransformer)
    assert task.pfc_cfg.sample_block == 4 and task.pfc_cfg.sampling
    before = {n: p.detach().clone()
              for n, p in task.encoder.named_parameters()}
    for k in range(2):
        loss = float(task.training_step(_batch(task.conf, k))["loss"])
        assert math.isfinite(loss) and loss > 0
    moved = [n for n, p in task.encoder.named_parameters()
             if not torch.equal(p, before[n])]
    assert moved == list(before)
    slots = task.state.opt_slots
    assert set(slots) == {"exp_avg", "exp_avg_sq"}
    assert float(slots["exp_avg_sq"]["mask_token"].sum()) > 0
    emb = task._embed(np.zeros((3, IMG, IMG, 3), np.float32))
    assert emb.shape == (3, EMB)
    assert torch.allclose(emb.norm(dim=1), torch.ones(3), atol=1e-5)


def test_the_vit_l_preset_builds_insightfaces_sizes():
    """ViT-L through build_encoder, on the meta device (no memory): 144
    patches, 136 kept, 255,684,352 parameters, as the reference counts."""
    conf = load_config("webface42m", network="ViT_L")
    with torch.device("meta"):
        enc = build_encoder(conf)
    assert enc.num_patches == 144 and enc.n_keep == 136
    assert enc.compute_dtype == torch.bfloat16
    model = {"kind": "vit", "img_size": 112, "emd_size": 512,
             **VIT_PRESETS["ViT_L"]}
    spec = ref_vit.param_spec(model)
    assert [(n, tuple(p.shape)) for n, p in enc.named_parameters()] == \
        [(n, s) for n, s, _ in spec]
    assert sum(math.prod(s) for _, s, _ in spec) == 255_684_352


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash route runs only on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 8, 136, 96), (3, 4, 16, 16)],
                         ids=["vit_l", "tiny"])
def test_flash_route_matches_the_plain_route_on_the_card(cuda_device,
                                                         shape):
    """bf16 q, k, v as strided views of one qkv tensor, as the model
    makes them: the flash forward and the tensor-core backward against
    the plain route's f32 arithmetic on the same bf16 values, to a few
    bf16 ulps (both round P to bf16 before ·v and accumulate in f32)."""
    b, h, n, d = shape
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn((b, n, 3, h, d), generator=g, device=cuda_device,
                      dtype=torch.bfloat16).requires_grad_(True)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    dout = torch.randn((b, h, n, d), generator=g, device=cuda_device,
                       dtype=torch.bfloat16)
    scale = d ** -0.5
    global_attention.launches.clear()
    out = global_attention(q, k, v, scale)
    assert out.transpose(1, 2).is_contiguous()
    (grad,) = torch.autograd.grad(out, qkv, dout)
    assert dict(global_attention.launches) == {"fwd": 1, "bwd": 1}
    ref_qkv = qkv.detach().float().requires_grad_(True)
    rq, rk, rv = ref_qkv.permute(2, 0, 3, 1, 4)
    want = attention_reference(rq, rk, rv, scale)
    (want_grad,) = torch.autograd.grad(want, ref_qkv, dout.float())
    assert _rel(out.float(), want) < 2 ** -6
    assert _rel(grad.float(), want_grad) < 2 ** -5


@pytest.mark.cuda
def test_the_card_route_keeps_dq_where_tokens_are_near_their_mean(
        cuda_device):
    """The whole card route (flash forward, tensor-core backward) at a
    ViT-L layer's shape with 16 images, tokens 0.03 about their mean:
    dq, dk and dv within 0.25 of float64 (0.08 measured on an H100, where
    flash's own backward is off by 21 times dq's norm)."""
    errors = _grads_against_float64(global_attention, (16, 8, 136, 96), 0.03,
                                    cuda_device)
    assert max(errors) < 0.25, errors
