"""The program's spans, and the device activity of a ``torch.profiler``
window: the device's events and the time the device was busy, the union of
their intervals (overlapping kernels on several streams count once).

A span is a host event on the profiler's own clock, recorded only while a
profiler runs (``span``). The training and embedding steps open one at
every layer boundary, under the names below, so that a reader of a profile
can place each kernel in the span that holds its launch call, and each idle
stretch of the device under the span the host was in. ``--profile``'s
Chrome trace carries them.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

import torch

# train/step.py's spans. The step's root and its layers, in the order a
# training step opens them; every kernel of a step is launched inside one
TRAIN_STEP = "train_step"
AUGMENT = "data:augment"
HEAD_ROWS = "pfc_head:rows"
ENCODER_FORWARD = "encoder:forward"
HEAD_LOSS = "pfc_head:loss"
HEAD_BACKWARD = "pfc_head:backward"
ENCODER_BACKWARD = "encoder:backward"
COLLECTIVE_GRADS = "collective:grads"
OPTIM_ENCODER = "optim:encoder"
HEAD_UPDATE = "pfc_head:update"
TRAIN_SPANS = (AUGMENT, HEAD_ROWS, ENCODER_FORWARD, HEAD_LOSS,
               HEAD_BACKWARD, ENCODER_BACKWARD, COLLECTIVE_GRADS,
               OPTIM_ENCODER, HEAD_UPDATE)
# the head's four spans share this prefix
HEAD_RANGE = "pfc_head:"
# inside the encoder's spans (models/vit.py): each global attention's
# forward and backward (ops/global_attn.py), and the token masking's
# gather and its restore with the mask token
ENCODER_ATTENTION = "encoder:attention"
ENCODER_VIT_MASK = "encoder:vit_mask"
# the embedding step's root and its two layers
EMBED_STEP = "embed_step"
EMBED_COPY_IN = "embed:copy_in"
EMBED_ENCODER = "embed:encoder"
# data/device_corpus.py: each batch's gather, each epoch's permutation
DATA_BATCH = "data:batch"
DATA_EPOCH = "data:epoch"

_record = torch._C._profiler._RecordFunctionFast
_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` over its body as a host
    event of the running ``torch.profiler`` window; with no profiler on
    this thread it records nothing, at the cost of one check.

    The event is a function-scope record (``RecordScope.FUNCTION``), not
    ``record_function``'s user scope: the profiler mirrors user-scope
    ranges onto the device's timeline as ``gpu_user_annotation`` events,
    which a reader of the device's events would count as kernels. No span
    appears among a profile's device events.

    A reader attributes a kernel to the span that holds its launch call,
    so a step captured into a CUDA graph must keep its span boundaries at
    graph boundaries: kernels replayed by one graph launch all fall in the
    span that holds the replay."""
    return _record(name) if _profiling() else _OFF


def device_events(events: Sequence) -> List:
    """The device's events (kernels, copies, sets) among a profile's
    events. Names that start with ``HEAD_RANGE`` are dropped too: a
    ``record_function`` range of that name would be mirrored there, and
    the spans are not."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in events
            if e.device_type == cuda and not e.name.startswith(HEAD_RANGE)]


def busy_ms(kernels: Sequence) -> float:
    """Milliseconds in which at least one of the events ran."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3
