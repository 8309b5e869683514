"""Device activity of a ``torch.profiler`` window: the device's events and
the time the device was busy, the union of their intervals (overlapping
kernels on several streams count once)."""

from __future__ import annotations

from typing import List, Sequence

import torch

# train/step.py's record_function ranges around the head's parts: they show
# on the device's timeline too, and they are no kernels
HEAD_RANGE = "pfc_head:"


def device_events(events: Sequence) -> List:
    """The device's events (kernels, copies, sets) among a profile's
    events, without the step's ``pfc_head:*`` ranges."""
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
