"""The Hopper grouped sparse-row kernels (csrc/sparse_rows.cu) against their
plain PyTorch versions, on the card. Imports no jax, so it also runs on a
machine without it:

    python -m pytest tests/test_torch_sparse_rows_cuda.py --noconftest -q

Without a CUDA device every test skips with its reason.

Tolerances: the gather is a copy and must be equal. The updates hold to
rtol 1e-5 / atol 1e-6: nvcc contracts mom·buf + g and the AdamW sums into
fused multiply-adds, the plain version rounds every product, and AdamW's
division and square root differ in their last digits. Rows outside the
sampled groups must keep their bits, and two runs must give the same bits.

The large cases are there for the offsets: a table beyond 2³¹ elements
(8.7 GB in f32) for the gather and SGD, one beyond 4 GiB for AdamW, with
the first and the last group of the table among the sampled ones."""

import pytest
import torch

from fr_tpu_torch.configs.base import Config
from fr_tpu_torch.ops import sparse_rows as rows

# (rows, D, block, groups): a small aligned case, a ragged one whose groups
# are no multiple of 4 floats (the scalar path), a group longer than one
# CUDA block's chunk, and the two large tables
SMALL = [(64, 128, 4, 5), (33, 10, 3, 4), (4096, 512, 64, 7)]
BEYOND_2_31_ELEMENTS = (4259840, 512, 64, 300)    # 2.18e9 elements, 8.7 GB
BEYOND_4_GIB = (2228224, 512, 64, 300)            # 4.56e9 bytes


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _gidx(n_rows, block, ng, gen, dev):
    """ng sorted unique group ids with the first and the last group in."""
    total = n_rows // block
    inner = torch.randperm(total - 2, generator=gen, device=dev)[:ng - 2] + 1
    ends = torch.tensor([0, total - 1], device=dev)
    return torch.sort(torch.cat([inner, ends])).values


def _problem(shape, slots, dev, seed=0):
    n_rows, d, block, ng = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    tables = {}
    for name in ("weight",) + slots:
        t = torch.randn(n_rows, d, device=dev, generator=gen)
        tables[name] = t.abs_() if name == "exp_avg_sq" else t
    gidx = _gidx(n_rows, block, ng, gen, dev)
    grad = torch.randn(ng * block, d, device=dev, generator=gen)
    return tables, gidx, grad


def _untouched_rows_keep_their_bits(after, before, gidx, block):
    changed = (after != before).any(dim=1)
    touched = torch.zeros_like(changed)
    touched[rows.expand_group_index(gidx, block)] = True
    assert not bool((changed & ~touched).any())
    assert bool((changed & touched).any())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SMALL + [BEYOND_2_31_ELEMENTS],
                         ids=["aligned", "ragged", "long-group", "2^31"])
def test_gather_equals_plain_on_card(cuda_device, shape):
    tables, gidx, _ = _problem(shape, (), cuda_device)
    table, block = tables["weight"], shape[2]
    before = rows.grouped_gather.launches
    out = rows.grouped_gather(table, gidx, block)
    torch.cuda.synchronize()
    assert rows.grouped_gather.launches == before + 1
    assert out.shape == (shape[3] * block, shape[1])
    assert torch.equal(out, rows.grouped_gather_reference(table, gidx, block))
    assert torch.equal(out[-block:], table[-block:])   # the last group


def _run_update(optimizer, tables, gidx, grad, block, kernel):
    conf = Config(wd=5e-4, mom=0.9, betas=(0.9, 0.999), eps=1e-8)
    w = tables["weight"].clone()
    slots = {k: v.clone() for k, v in tables.items() if k != "weight"}
    if kernel:
        rows.grouped_update(optimizer, conf, w, slots, gidx, grad, 0.05, 3,
                            block)
    elif optimizer == "SGD":
        rows.grouped_update_sgd_reference(w, slots, gidx, grad, 0.05,
                                          conf.wd, conf.mom, block)
    else:
        rows.grouped_update_adamw_reference(w, slots, gidx, grad, 0.05,
                                            conf.wd, *conf.betas, conf.eps,
                                            3, block)
    torch.cuda.synchronize()
    return {"weight": w, **slots}


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer,shape", [
    *[(o, s) for o in ("SGD", "AdamW") for s in SMALL],
    ("SGD", BEYOND_2_31_ELEMENTS), ("AdamW", BEYOND_4_GIB)],
    ids=lambda v: v if isinstance(v, str) else "x".join(map(str, v)))
def test_update_matches_plain_on_card(cuda_device, optimizer, shape):
    names = ("momentum",) if optimizer == "SGD" else ("exp_avg", "exp_avg_sq")
    wrapper = (rows.grouped_update_sgd if optimizer == "SGD"
               else rows.grouped_update_adamw)
    tables, gidx, grad = _problem(shape, names, cuda_device, seed=1)
    block = shape[2]
    before = wrapper.launches
    ours = _run_update(optimizer, tables, gidx, grad, block, kernel=True)
    assert wrapper.launches == before + 1
    for name, t in ours.items():
        _untouched_rows_keep_their_bits(t, tables[name], gidx, block)
    again = _run_update(optimizer, tables, gidx, grad, block, kernel=True)
    for name in ours:
        assert torch.equal(again[name], ours[name]), name
    del again
    ref = _run_update(optimizer, tables, gidx, grad, block, kernel=False)
    idx = rows.expand_group_index(gidx, block)
    for name in ours:
        torch.testing.assert_close(ours[name].index_select(0, idx),
                                   ref[name].index_select(0, idx),
                                   rtol=1e-5, atol=1e-6, msg=name)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    tables, gidx, grad = _problem(SMALL[0], ("momentum",), cuda_device)
    w, slots = tables["weight"], {"momentum": tables["momentum"]}
    counts = [f.launches for f in (rows.grouped_gather,
                                   rows.grouped_update_sgd)]
    with pytest.raises(ValueError, match="int64"):
        rows.grouped_gather(w, gidx.int(), 4)
    with pytest.raises(ValueError, match="float32"):
        rows.grouped_gather(w.half(), gidx, 4)
    with pytest.raises(ValueError, match="contiguous on"):
        rows.grouped_gather(w, gidx.cpu(), 4)
    with pytest.raises(ValueError, match="contiguous on"):
        rows.grouped_update_sgd(w, slots, gidx, grad.cpu(), 0.1, 0.0, 0.9, 4)
    with pytest.raises(ValueError, match="grad_rows must be"):
        rows.grouped_update_sgd(w, slots, gidx, grad[:-4], 0.1, 0.0, 0.9, 4)
    with pytest.raises(ValueError, match="C % block"):
        rows.grouped_gather(w, gidx, 5)
    assert [f.launches for f in (rows.grouped_gather,
                                 rows.grouped_update_sgd)] == counts


@pytest.mark.cuda
def test_a_group_id_outside_the_table_is_skipped(cuda_device):
    """The kernels bound-check the id instead of writing out of bounds."""
    tables, gidx, grad = _problem(SMALL[0], ("momentum",), cuda_device)
    w0 = tables["weight"].clone()
    bad = gidx.clone()
    bad[-1] = 16          # 64 rows in groups of 4: ids 0..15
    rows.grouped_update_sgd(tables["weight"], {"momentum": tables[
        "momentum"]}, bad, grad, 0.05, 0.0, 0.9, 4)
    torch.cuda.synchronize()
    _untouched_rows_keep_their_bits(tables["weight"], w0, bad[:-1], 4)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["SGD", "AdamW"])
def test_block_sampled_step_launches_the_grouped_kernels(cuda_device,
                                                         optimizer):
    """One training step of a small ResNet with sample_block 4 on the card:
    one gather and one grouped update, a finite loss, and only rows of the
    drawn groups change."""
    from fr_tpu_torch.heads.partial_fc import PFCConfig
    from fr_tpu_torch.models.common import init_weights
    from fr_tpu_torch.models.resnet import ResNet
    from fr_tpu_torch.train.state import init_train_state
    from fr_tpu_torch.train.step import make_train_step

    conf = Config(optimizer_name=optimizer, wd=5e-4, mom=0.9,
                  betas=(0.9, 0.999), eps=1e-8)
    cfg = PFCConfig(298, 64, sample_rate=0.5, margin="ArcFace", s=30.0,
                    m=0.35, mixed_precision=True, optimizer=optimizer,
                    sample_block=4)
    model = init_weights(ResNet((1, 1, 1, 1), emd_size=64, img_size=32,
                                compute_dtype=torch.bfloat16))
    state = init_train_state(conf, model, cfg, cuda_device)
    step = make_train_step(conf, cfg, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    images = torch.randn(8, 32, 32, 3, device=cuda_device, generator=gen)
    labels = torch.randint(0, 298, (8,), device=cuda_device, generator=gen)
    update = (rows.grouped_update_sgd if optimizer == "SGD"
              else rows.grouped_update_adamw)
    counts = (rows.grouped_gather.launches, update.launches)
    before = state.pfc.weight.clone()
    m = step(state, images, labels, 0.05)
    torch.cuda.synchronize()
    assert torch.isfinite(m["loss"])
    assert (rows.grouped_gather.launches, update.launches) == \
        (counts[0] + 1, counts[1] + 1)
    changed = (state.pfc.weight != before).any(dim=1)
    assert 0 < int(changed.sum()) <= cfg.num_sample
    groups = changed.reshape(-1, 4).any(dim=1)
    assert int(groups.sum()) <= cfg.num_sample_groups
    assert bool(groups[labels // 4].all())
