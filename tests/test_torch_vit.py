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
drop-path draws), the mask token's gradient, the attention's plain route
on the packed qkv projection, the plain versions of its kernels'
arithmetic and the shapes the kernels take, its calls by entry over a
step, and a whole AdamW step with grouped row sampling on the port's
normal path (``load_config`` → task → step).

The CPU tests take a few seconds on one worker. The tests marked ``cuda``
hold the kernels of csrc/global_attn.cu against the plain route and the
plain versions of their arithmetic on the card, near-mean tokens, a
bitwise repeat and the launches of a step; the file imports no jax, so
there:

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
from fr_tpu_torch.ops.global_attn import (attention_backward_plain,
                                          attention_forward_plain,
                                          attention_reference_packed,
                                          global_attention,
                                          kernel_shape_error, merge_heads,
                                          split_heads)
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


def _packed(q, k, v):
    """(B, H, L, d) q, k and v as the (B, L, 3·D) projection the model
    makes, laid out (B, L, 3, H, d)."""
    b, h, n, d = q.shape
    return torch.stack([t.transpose(1, 2) for t in (q, k, v)], 2).reshape(
        b, n, 3 * h * d)


def _unpacked(dqkv, heads):
    """(B, L, 3·D) → (dq, dk, dv), (B, H, L, d) each."""
    return tuple(split_heads(dqkv, heads))


def _heads(x, heads):
    """(B, L, D) → (B, H, L, d)."""
    b, n, dim = x.shape
    return x.reshape(b, n, heads, dim // heads).transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_global_attention_on_the_cpu_is_the_plain_math(dtype):
    """Forward and backward of the CPU route, on the packed projection,
    against autograd through the plain math in float64: to f32 rounding
    for f32 inputs; bf16 inputs are computed in f32 and only the results
    rounded, so they agree to bf16's half ulp (2⁻⁹ relative) and a little."""
    g = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn((2, 4, 12, 16), generator=g) for _ in
                     range(4))
    scale = 16 ** -0.5
    qkv = _packed(q, k, v).to(dtype).requires_grad_(True)
    out = global_attention(qkv, 4, scale)
    assert out.dtype == dtype and out.shape == (2, 12, 64)
    (dqkv,) = torch.autograd.grad(out, qkv, merge_heads(dout).to(dtype))
    q64, k64, v64 = (t.detach().double().requires_grad_(True)
                     for t in split_heads(qkv, 4))
    want = _plain_attention(q64, k64, v64, scale)
    wq, wk, wv = torch.autograd.grad(want, (q64, k64, v64),
                                     dout.to(dtype).double())
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    dq, dk, dv = _unpacked(dqkv, 4)
    for a, b in ((_heads(out, 4), want), (dq, wq), (dk, wk), (dv, wv)):
        assert _rel(a.double(), b) < tol


def test_the_kernels_plain_versions_are_the_attention_in_float32():
    """attention_forward_plain and attention_backward_plain, the kernels'
    arithmetic, on f32 inputs (where no rounding applies) against the
    plain math and its autograd in float64, at a ragged 37 tokens; the
    log-sum-exp against torch.logsumexp."""
    g = torch.Generator().manual_seed(1)
    q, k, v, dout = (torch.randn((2, 3, 37, 32), generator=g) for _ in
                     range(4))
    scale = 32 ** -0.5
    o, lse = attention_forward_plain(q, k, v, scale)
    grads = attention_backward_plain(q, k, v, lse, dout, scale)
    wide = [t.double().requires_grad_(True) for t in (q, k, v)]
    want = _plain_attention(*wide, scale)
    want_grads = torch.autograd.grad(want, wide, dout.double())
    assert _rel(o.double(), want) < 1e-6
    want_lse = torch.logsumexp((wide[0] @ wide[1].transpose(-1, -2)) * scale,
                               -1)
    assert _rel(lse.double(), want_lse) < 1e-6
    for a, b in zip(grads, want_grads):
        assert _rel(a.double(), b) < 1e-5


@pytest.mark.parametrize("case", [
    ((2, 16, 3 * 64), torch.float32, "bf16"),
    ((2, 145, 3 * 64), torch.bfloat16, "145 tokens"),
    ((2, 16, 3 * 4 * 8), torch.bfloat16, "head dim 8"),
    ((2, 16, 3 * 4 * 40), torch.bfloat16, "head dim 40"),
    ((2, 16, 3 * 144), torch.bfloat16, "head dim 144"),
], ids=["f32", "tokens", "d8", "d40", "d144"])
def test_the_kernels_refuse_what_they_do_not_take(case):
    """The card route raises rather than fall back for a dtype other than
    bf16, more than 144 tokens, or a head dim that is not a multiple of 16
    up to 128 (checked here on CPU tensors of those shapes)."""
    shape, dtype, words = case
    heads = 1 if shape[-1] == 3 * 144 else 4
    err = kernel_shape_error(torch.zeros(shape, dtype=dtype), heads)
    assert err is not None and words in err


def test_the_kernels_take_the_models_projection_and_refuse_odd_strides():
    """ViT-L's training (136) and evaluation (144) projections, and the
    tiny and ragged test shapes, are taken; a projection whose rows are
    not whole 16-byte words, or whose last dimension is strided, is not."""
    for b, n, heads, d in ((2, 136, 8, 96), (2, 144, 8, 96), (3, 16, 4, 16),
                           (2, 37, 4, 32), (1, 144, 1, 128)):
        qkv = torch.zeros((b, n, 3 * heads * d), dtype=torch.bfloat16)
        assert kernel_shape_error(qkv, heads) is None
    wide = torch.zeros((2, 16, 3 * 64 + 4), dtype=torch.bfloat16)
    assert "strides" in kernel_shape_error(wide[:, :, :3 * 64], 4)
    assert "strides" in kernel_shape_error(
        torch.zeros((2, 3 * 64, 16), dtype=torch.bfloat16).transpose(1, 2),
        4)


def _near_mean(shape, spread, generator, device="cpu"):
    """bf16 q, k or v whose tokens lie ``spread`` about a mean they share
    (per image and head), as in the deeper blocks of a ViT at init."""
    b, h, n, d = shape
    mean = torch.randn((b, h, 1, d), generator=generator, device=device)
    return (mean + spread * torch.randn(shape, generator=generator,
                                        device=device)).to(torch.bfloat16)


def _grads_against_float64(grads, shape, spread, device="cpu"):
    """Relative errors of (dq, dk, dv) from ``grads(qkv, heads, dout,
    scale)``, the (B, L, 3·D) gradient of a (B, L, 3·D) bf16 projection,
    against autograd in float64, at tokens ``spread`` about their mean;
    shape is (B, H, L, d)."""
    g = torch.Generator(device=device).manual_seed(4)
    q, k, v = (_near_mean(shape, spread, g, device) for _ in range(3))
    heads = shape[1]
    dout = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
    scale = shape[-1] ** -0.5
    got = _unpacked(grads(_packed(q, k, v), heads, merge_heads(dout), scale),
                    heads)
    wide = [t.double().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(_plain_attention(*wide, scale), wide,
                               dout.double())
    return [_rel(a.double(), b) for a, b in zip(got, want)]


def _plain_kernel_grads(qkv, heads, dout, scale):
    """The kernels' arithmetic in PyTorch: the forward's log-sum-exp, then
    the backward, as the (B, L, 3·D) gradient."""
    q, k, v = split_heads(qkv, heads)
    _, lse = attention_forward_plain(q, k, v, scale)
    grads = attention_backward_plain(q, k, v, lse, _heads(dout, heads), scale)
    return _packed(*grads)


def _route_grads(qkv, heads, dout, scale):
    """The gradient through global_attention (autograd)."""
    qkv = qkv.requires_grad_(True)
    return torch.autograd.grad(global_attention(qkv, heads, scale), qkv,
                               dout)[0]


def test_the_cards_backward_keeps_dq_where_tokens_are_near_their_mean():
    """The card's backward arithmetic (``attention_backward_plain``: P from
    the log-sum-exp and dP in f32, each row's Σⱼ Pᵢⱼ dPᵢⱼ from them, bf16
    dS), here on the CPU at tokens 0.03 about their mean, where the true dq
    is a thousandth of dv's size. Its rows of the scores' gradient sum to
    nought with the probabilities they were made from, so dq stays within
    0.08 of float64 (bf16 rounding of q, k and the scores; 0.25 leaves
    three times that), where a backward that takes each row's Σⱼ Pᵢⱼ dPᵢⱼ
    from the bf16 output, as flash's does, is off by about 20 times dq's
    norm."""
    errors = _grads_against_float64(_plain_kernel_grads, (2, 4, 136, 96),
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
        pytest.skip("needs an NVIDIA GPU: the global-attention kernels run "
                    "only on the card")
    return torch.device("cuda")


def _card_qkv(shape, device, seed=0):
    """A bf16 (B, L, 3·D) projection of shape (B, L, 3, H, d) and a bf16
    output gradient (B, L, D)."""
    b, n, _, h, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, n, 3 * h * d), generator=g, device=device,
                      dtype=torch.bfloat16)
    dout = torch.randn((b, n, h * d), generator=g, device=device,
                       dtype=torch.bfloat16)
    return qkv, dout


CARD_SHAPES = [(4, 136, 3, 8, 96), (2, 144, 3, 8, 96), (3, 16, 3, 4, 16),
               (2, 37, 3, 4, 32), (2, 144, 3, 2, 128)]
CARD_IDS = ["vit_l", "vit_l_eval", "tiny", "ragged37", "d128"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=CARD_IDS)
def test_the_kernels_match_the_plain_route_on_the_card(cuda_device, shape):
    """The forward and backward kernels on the packed projection against
    the plain route's f32 arithmetic (``attention_reference`` and its
    autograd) on the same bf16 values, to a few bf16 ulps (the kernels
    round P to bf16 before ·v and dS before its products); and against
    the plain versions of their own arithmetic, which round at the same
    places, closer still."""
    b, n, _, h, d = shape
    qkv, dout = _card_qkv(shape, cuda_device)
    scale = d ** -0.5
    global_attention.launches.clear()
    global_attention.kernel_launches.clear()
    leaf = qkv.clone().requires_grad_(True)
    out = global_attention(leaf, h, scale)
    assert out.shape == (b, n, h * d) and out.is_contiguous()
    (grad,) = torch.autograd.grad(out, leaf, dout)
    assert dict(global_attention.launches) == {"fwd": 1, "bwd": 1}
    assert dict(global_attention.kernel_launches) == {"fwd": 1, "bwd": 1}
    ref = qkv.float().requires_grad_(True)
    want = attention_reference_packed(ref, h, scale)
    (want_grad,) = torch.autograd.grad(want, ref, dout.float())
    assert _rel(out.float(), want) < 2 ** -6
    assert _rel(grad.float(), want_grad) < 2 ** -5
    q, k, v = split_heads(qkv, h)
    o_plain, lse = attention_forward_plain(q, k, v, scale)
    assert _rel(_heads(out, h).float(), o_plain.float()) < 2 ** -8
    plain_grad = _plain_kernel_grads(qkv, h, dout, scale)
    assert _rel(grad.float(), plain_grad.float()) < 2 ** -7


@pytest.mark.cuda
def test_the_card_route_keeps_dq_where_tokens_are_near_their_mean(
        cuda_device):
    """The kernels at a ViT-L layer's shape with 16 images, tokens 0.03
    about their mean: dq, dk and dv within 0.25 of float64 (flash's own
    backward is off by 21 times dq's norm there on an H100)."""
    errors = _grads_against_float64(_route_grads, (16, 8, 136, 96), 0.03,
                                    cuda_device)
    assert max(errors) < 0.25, errors


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES[:2] + CARD_SHAPES[3:4],
                         ids=["vit_l", "vit_l_eval", "ragged37"])
def test_two_runs_of_the_kernels_give_the_same_bits(cuda_device, shape):
    """No atomics and sums in a fixed order: o, the log-sum-exp and the
    whole gradient are bitwise the same on a second run."""
    qkv, dout = _card_qkv(shape, cuda_device, seed=3)
    h, scale = shape[3], shape[4] ** -0.5
    runs = []
    for _ in range(2):
        leaf = qkv.clone().requires_grad_(True)
        out = global_attention(leaf, h, scale)
        runs.append((out, torch.autograd.grad(out, leaf, dout)[0]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.cuda
def test_the_card_route_raises_for_what_the_kernels_do_not_take(cuda_device):
    """f32, 145 tokens and a head dim of 40 raise on the card; nothing
    falls back to the plain route."""
    global_attention.kernel_launches.clear()
    for shape, dtype in (((2, 16, 3 * 64), torch.float32),
                         ((2, 145, 3 * 64), torch.bfloat16),
                         ((2, 16, 3 * 160), torch.bfloat16)):
        with pytest.raises(ValueError):
            global_attention(torch.zeros(shape, dtype=dtype,
                                         device=cuda_device), 4, 0.125)
    assert not global_attention.kernel_launches


@pytest.mark.cuda
def test_a_vit_training_step_launches_each_kernel_once_a_block(cuda_device):
    """The tiny ViT's forward and backward in bf16 on the card: in training
    one forward and one backward kernel launch a block. Then, in eval mode
    (no masking or drop-path draws, which differ between devices), every
    parameter's gradient against the f32 plain route on a CPU copy of the
    same weights: each within 0.25 (bf16 products alone read up to 0.07 on
    the CPU, in the MLP and its LayerNorm), and the q, k and v rows of each
    block's qkv weight each within 2⁻⁴ (0.008–0.014 on the CPU), held
    apart because the q and k rows carry a fortieth of that gradient's
    norm at these weights."""
    enc = VisionTransformer(img_size=IMG, emd_size=EMB,
                            compute_dtype=torch.bfloat16,
                            **VIT_PRESETS["ViT_T"])
    enc = init_weights(enc, 0).to(cuda_device).train()
    x = _images().to(cuda_device)
    global_attention.kernel_launches.clear()
    out = enc(x, torch.Generator(device=cuda_device).manual_seed(1))
    out.square().sum().backward()
    depth = VIT_PRESETS["ViT_T"]["depth"]
    assert dict(global_attention.kernel_launches) == {"fwd": depth,
                                                      "bwd": depth}
    assert all(torch.isfinite(p.grad).all() for p in enc.parameters()
               if p.grad is not None)

    ref = VisionTransformer(img_size=IMG, emd_size=EMB,
                            **VIT_PRESETS["ViT_T"])
    ref.load_state_dict({k: v.cpu() for k, v in enc.state_dict().items()})
    enc.zero_grad(set_to_none=True)
    global_attention.kernel_launches.clear()
    enc.eval()(x).square().sum().backward()
    assert dict(global_attention.kernel_launches) == {"fwd": depth,
                                                      "bwd": depth}
    ref.eval()(x.cpu()).square().sum().backward()
    want = dict(ref.named_parameters())
    errors = {}
    for name, p in enc.named_parameters():
        if p.grad is None:
            assert want[name].grad is None, name
            continue
        got, wide = p.grad.float().cpu(), want[name].grad
        errors[name] = _rel(got, wide)
        if name.endswith("attn.qkv.weight"):
            for part, a, b in zip("qkv", got.chunk(3), wide.chunk(3)):
                assert _rel(a, b) < 2 ** -4, (name, part, _rel(a, b))
    assert max(errors.values()) < 0.25, errors
