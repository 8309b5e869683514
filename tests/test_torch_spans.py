"""The program's spans (fr_tpu_torch/utils/profiling.py ``span``): a
profiled training step at mesh (1, 1), an embedding call and the
card-resident loader each record their spans once, nested and in order;
no span is a user-scope range, the kind the profiler mirrors onto the
device's timeline; on the card no device event carries a span's name.

The CPU tests take about 3 s on one worker. The test marked ``cuda`` needs
a card and skips without one; the file imports no jax, so on the card:

    python -m pytest tests/test_torch_spans.py --noconftest -q
"""

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from fr_tpu_torch.configs import load_config
from fr_tpu_torch.data.augment import augment_cfg_from_conf
from fr_tpu_torch.data.device_corpus import DeviceCorpusLoader
from fr_tpu_torch.heads.partial_fc import PFCConfig
from fr_tpu_torch.models import build_encoder
from fr_tpu_torch.models.common import BatchNorm2d, Conv, Dense, init_weights
from fr_tpu_torch.train.state import init_train_state
from fr_tpu_torch.train.step import make_embed_step, make_train_step
from fr_tpu_torch.utils import profiling as spans
from fr_tpu_torch.utils.profiling import span
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

IMG, EMB, NCLS, BATCH = 16, 16, 37, 8
SPAN_NAMES = {
    spans.TRAIN_STEP, *spans.TRAIN_SPANS, spans.EMBED_STEP,
    spans.EMBED_COPY_IN, spans.EMBED_ENCODER, spans.DATA_BATCH,
    spans.DATA_EPOCH, spans.ENCODER_ATTENTION, spans.ENCODER_VIT_MASK}


class TinyEncoder(nn.Module):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(3, 8, 3, 2, dtype)
        self.bn = BatchNorm2d(8)
        self.fc = Dense(8 * (IMG // 2) ** 2, EMB)

    def forward(self, x, generator=None):
        x = F.relu(self.bn(self.conv(x.permute(0, 3, 1, 2))))
        return self.fc(x.flatten(1).float())


def _train(device, block):
    conf = load_config("ms1m_arcface_122", optimizer="SGD")
    conf.update(n_classes=NCLS, emd_size=EMB, mixed_precision=False)
    cfg = PFCConfig(NCLS, EMB, sample_rate=0.5, margin="ArcFace", s=30.0,
                    m=0.35, mixed_precision=False, sample_block=block)
    state = init_train_state(conf, init_weights(TinyEncoder(), 0), cfg,
                             device, 0)
    step = make_train_step(conf, cfg, device, augment_cfg_from_conf(conf))
    return state, step


def _batches(n, device="cpu"):
    rng = np.random.default_rng(0)
    return [(torch.as_tensor(rng.integers(0, 256, (BATCH, IMG, IMG, 3))
                             .astype(np.uint8)).to(device),
             torch.as_tensor(rng.integers(0, NCLS, BATCH)).to(device))
            for _ in range(n)]


def _spans(prof):
    """(start, end, name) of the profile's span events, by start; each
    checked to be a function-scope host event."""
    cpu = torch.autograd.DeviceType.CPU
    user = int(torch._C._profiler.RecordScope.USER_SCOPE)
    out = []
    for e in prof.events():
        if e.name in SPAN_NAMES:
            assert e.device_type == cpu, e.name
            assert e.scope != user, e.name
            out.append((e.time_range.start, e.time_range.end, e.name))
    return sorted(out)


def _nested(got, root, children, calls):
    """``calls`` roots, each holding ``children`` once and in order, one
    after another."""
    assert [n for _, _, n in got] == [root, *children] * calls
    for i in range(0, len(got), len(children) + 1):
        a, b, _ = got[i]
        kids = got[i + 1:i + 1 + len(children)]
        assert all(a <= s <= e <= b for s, e, _ in kids)
        assert all(e0 <= s1 for (_, e0, _), (s1, _, _) in zip(kids,
                                                               kids[1:]))


@pytest.mark.parametrize("block", [1, 4], ids=["per-row", "block4"])
def test_train_step_records_every_layer_once_in_order(block):
    """Each step is one ``train_step`` holding the augmentation, the head's
    four parts, the encoder's forward and backward, the collectives (empty
    at mesh (1, 1)) and the encoder's update, in the order they run."""
    state, step = _train("cpu", block)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for images, labels in _batches(2):
            step(state, images, labels, 0.05)
    _nested(_spans(prof), spans.TRAIN_STEP, spans.TRAIN_SPANS, 2)


def test_embed_step_records_its_copy_and_its_encoder():
    encoder = init_weights(TinyEncoder(), 0).eval()
    conf = load_config("ms1m_arcface_122")
    conf.update(img_size=IMG, emd_size=EMB)
    embed = make_embed_step(conf, encoder, "cpu")
    rng = np.random.default_rng(1)
    # one call at the encoder's size, one resized in the copy's span
    calls = [rng.normal(size=(4, s, s, 3)).astype(np.float32)
             for s in (IMG, IMG + 4)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for x in calls:
            assert embed(x).shape == (4, EMB)
    _nested(_spans(prof), spans.EMBED_STEP,
            (spans.EMBED_COPY_IN, spans.EMBED_ENCODER), 2)


def test_loader_records_each_epoch_and_each_batch():
    """``data:epoch`` once an epoch, then ``data:batch`` once a step,
    each closed before the batch is handed out."""
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (3 * BATCH + 2, IMG, IMG, 3), np.uint8)
    labels = rng.integers(0, NCLS, len(images))
    loader = DeviceCorpusLoader(images, labels, BATCH, seed=0, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for e in range(2):
            for _ in loader.epoch(e):
                with span("consumer"):
                    pass
    got = _spans(prof)
    want = [spans.DATA_EPOCH] + [spans.DATA_BATCH] * 3
    assert [n for _, _, n in got] == want * 2
    assert all(e0 <= s1 for (_, e0, _), (s1, _, _) in zip(got, got[1:]))
    consumer = [e.time_range.start for e in prof.events()
                if e.name == "consumer"]
    batches = [e for _, e, n in got if n == spans.DATA_BATCH]
    assert len(consumer) == 6
    assert all(b <= c for b, c in zip(batches, consumer))


def test_spans_are_function_scope_and_silent_outside_a_profile():
    """A span is a function-scope record, never ``record_function``'s user
    scope: the guard, here, of the rule that no span reaches the device's
    timeline. With no profiler on, a span records nothing."""
    names = sorted(SPAN_NAMES)
    for name in names:
        with span(name):
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in names:
            with span(name):
                torch.ones(2).add_(1)
    got = [e for e in prof.events() if e.name in SPAN_NAMES]
    assert sorted(e.name for e in got) == names
    scope = int(torch._C._profiler.RecordScope.FUNCTION)
    assert all(e.scope == scope for e in got)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device timeline exists only "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_no_span_on_the_device_timeline(cuda_device):
    """A profiled training step and embedding call on the card: no device
    event carries a span's name, and every kernel's launch call starts
    inside a span."""
    state, step = _train(cuda_device, 4)
    encoder = init_weights(TinyEncoder(), 0).to(cuda_device).eval()
    conf = load_config("ms1m_arcface_122")
    conf.update(img_size=IMG, emd_size=EMB)
    embed = make_embed_step(conf, encoder, cuda_device)
    batches = _batches(3, cuda_device)
    step(state, *batches[0], 0.05)
    x = np.zeros((4, IMG, IMG, 3), np.float32)
    embed(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for images, labels in batches[1:]:
            step(state, images, labels, 0.05)
        embed(x)
        torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in events if e.device_type == cuda]
    assert device
    assert not [e.name for e in device if e.name in SPAN_NAMES]
    got = _spans(prof)
    assert [n for _, _, n in got].count(spans.TRAIN_STEP) == 2
    roots = [(a, b) for a, b, n in got
             if n in (spans.TRAIN_STEP, spans.EMBED_STEP)]
    launched = {e.id: e.time_range.start for e in events
                if e.device_type != cuda and e.name.startswith("cu")}
    outside = [k.name for k in device if k.id in launched and not any(
        a <= launched[k.id] <= b for a, b in roots)]
    assert not outside


def _inside(inner, outer) -> int:
    """How many of the intervals ``inner`` lie inside one of ``outer``."""
    return sum(any(a0 <= a and b <= b0 for a0, b0 in outer)
               for a, b in inner)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_vit_step_records_its_attention_in_both_walks_and_its_masking(
        device):
    """A training step of the tiny ViT preset: ``encoder:attention`` opens
    once a block inside ``encoder:forward`` and once a block inside
    ``encoder:backward``, where the autograd engine calls the attention's
    backward (on the card from its own thread); ``encoder:vit_mask`` opens
    twice inside ``encoder:forward``, at the gather and at the restore.
    On the card no device event carries either name."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    img = 36
    conf = load_config("webface42m", network="ViT_T", optimizer="AdamW",
                       img_size=img, emd_size=EMB, n_classes=NCLS,
                       mixed_precision=device == "cuda")
    cfg = PFCConfig(NCLS, EMB, sample_rate=0.5, margin="CosFace", s=64.0,
                    m=0.4, mixed_precision=conf.mixed_precision,
                    optimizer="AdamW", sample_block=4)
    state = init_train_state(conf, init_weights(build_encoder(conf), 0),
                             cfg, device, 0)
    step = make_train_step(conf, cfg, device, augment_cfg_from_conf(conf))
    rng = np.random.default_rng(3)
    images, labels = (
        torch.as_tensor(rng.integers(0, 256, (BATCH, img, img, 3),
                                     dtype=np.uint8)).to(device),
        torch.as_tensor(rng.integers(0, NCLS, BATCH)).to(device))
    step(state, images, labels, 1e-3)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        step(state, images, labels, 1e-3)
        if device == "cuda":
            torch.cuda.synchronize()
    got = _spans(prof)

    def where(name):
        return [(a, b) for a, b, n in got if n == name]
    depth = len(state.encoder.blocks)
    attention = where(spans.ENCODER_ATTENTION)
    assert len(attention) == 2 * depth
    assert _inside(attention, where(spans.ENCODER_FORWARD)) == depth
    assert _inside(attention, where(spans.ENCODER_BACKWARD)) == depth
    masking = where(spans.ENCODER_VIT_MASK)
    assert len(masking) == 2
    assert _inside(masking, where(spans.ENCODER_FORWARD)) == 2
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    assert bool(device_events) == (device == "cuda")
    assert not [e.name for e in device_events if e.name in SPAN_NAMES]
