"""A traced window read by the program's spans: the device time each span
launched, the copies among it, the blocking runtime calls a step makes,
and under which span the device idled.

The program records a span (``fr_tpu_torch/utils/profiling.py``) as a host
event of the profiler at every layer boundary of its steps; the benchmark
only reads the names below and imports nothing of the program. The rule is
``yardstick.head_ms``'s, for any span: a device operation belongs to a span
when its launch call (a CUDA API call, ``cu*``, that shares the operation's
correlation id, the event's ``id``) starts inside one of that span's host
intervals, whichever thread made the call; so the kernels that the
autograd engine's thread launches during ``encoder:backward`` belong to it.
A reader returns None where the window has no device operation or the span
never opened, and never 0 for a span that is missing.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence

# the program's spans
TRAIN_STEP = "train_step"
AUGMENT = "data:augment"
ENCODER_FORWARD = "encoder:forward"
ENCODER_BACKWARD = "encoder:backward"
OPTIM_ENCODER = "optim:encoder"
EMBED_STEP = "embed_step"
EMBED_COPY_IN = "embed:copy_in"
EMBED_ENCODER = "embed:encoder"
SPANS = (TRAIN_STEP, AUGMENT, "pfc_head:rows", ENCODER_FORWARD,
         "pfc_head:loss", "pfc_head:backward", ENCODER_BACKWARD,
         "collective:grads", OPTIM_ENCODER, "pfc_head:update", EMBED_STEP,
         EMBED_COPY_IN, EMBED_ENCODER, "data:batch", "data:epoch")
# the host operation under which casts and layout round trips launch
COPY_OP = "aten::copy_"
# CUDA API calls (``cuda*`` and their ``cu*`` counterparts) that hold the
# host until the device has drained the work before them
SYNC_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize",
    "cuEventSynchronize", "cuMemcpy", "cuMemcpyDtoH_v2", "cuMemcpyHtoD_v2"})
OUTSIDE = "outside every span"


def _host(e) -> bool:
    import torch
    return e.device_type == torch.autograd.DeviceType.CPU


class Intervals:
    """A union of host intervals (µs), sorted, for lookups by time."""

    def __init__(self, pairs):
        merged: List[List[float]] = []
        for a, b in sorted(pairs):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]

    def __bool__(self) -> bool:
        return bool(self.starts)

    def __contains__(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def _pairs(events: Sequence, names) -> list:
    return [(e.time_range.start, e.time_range.end) for e in events
            if _host(e) and e.name in names]


def launch_calls(events: Sequence) -> Dict[int, object]:
    """{correlation id: the launch call} of the window's CUDA API calls."""
    return {e.id: e for e in events if _host(e) and e.name.startswith("cu")}


def launched_in(events: Sequence, kernels: Sequence, names: Sequence[str]
                ) -> Optional[list]:
    """The device operations whose launch call starts inside a span of
    ``names``; None where none of them opened in the window."""
    spans = Intervals(_pairs(events, set(names)))
    if not spans:
        return None
    calls = launch_calls(events)
    return [k for k in kernels if k.id in calls
            and calls[k.id].time_range.start in spans]


def under_op(events: Sequence, kernels: Sequence, op: str = COPY_OP
             ) -> list:
    """Those of ``kernels`` whose launch call starts inside a host ``op``
    on the thread that made the call."""
    by_thread: Dict[int, list] = {}
    for e in events:
        if _host(e) and e.name == op:
            by_thread.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end))
    ops = {t: Intervals(v) for t, v in by_thread.items()}
    calls = launch_calls(events)
    out = []
    for k in kernels:
        call = calls.get(k.id)
        if call is not None and call.time_range.start in ops.get(
                call.thread, ()):
            out.append(k)
    return out


def _ms(kernels: Sequence) -> float:
    return sum(k.time_range.end - k.time_range.start for k in kernels) / 1e3


def device_ms_per_step(trace, names: Sequence[str], copies: bool = False
                       ) -> Optional[float]:
    """Device ms per traced step (or call) of the operations launched in
    the spans ``names``; with ``copies``, of those alone that launched
    under ``aten::copy_``. None without a traced device operation or where
    no span of ``names`` opened."""
    if trace is None or not trace.kernels:
        return None
    got = launched_in(trace.events, trace.kernels, names)
    if got is None:
        return None
    if copies:
        got = under_op(trace.events, got)
    return _ms(got) / trace.steps


def host_syncs(events: Sequence, within: str = TRAIN_STEP
               ) -> Optional[list]:
    """The blocking runtime calls (SYNC_CALLS) that start inside a
    ``within`` span; None where that span never opened."""
    spans = Intervals(_pairs(events, {within}))
    if not spans:
        return None
    return [e for e in events if _host(e) and e.name in SYNC_CALLS
            and e.time_range.start in spans]


class _Innermost:
    """The innermost program span at a host time: the window's span events
    cut at their starts and ends into stretches, each with one innermost
    span (or none)."""

    def __init__(self, events: Sequence):
        spans = [(e.time_range.start, e.time_range.end, e.name)
                 for e in events if _host(e) and e.name in SPANS]
        self.cuts = sorted({t for a, b, _ in spans for t in (a, b)})
        self.names = []
        for a, b in zip(self.cuts, self.cuts[1:]):
            cover = [s for s in spans if s[0] <= (a + b) / 2 <= s[1]]
            self.names.append(max(cover)[2] if cover else OUTSIDE)

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.cuts, t) - 1
        return self.names[i] if 0 <= i < len(self.names) else OUTSIDE

    def split(self, a: float, b: float) -> Dict[str, float]:
        """{innermost span: µs} of the host interval (a, b)."""
        out: Dict[str, float] = {}

        def add(name, lo, hi):
            if hi > lo:
                out[name] = out.get(name, 0.0) + hi - lo

        cuts = self.cuts
        if not self.names:
            add(OUTSIDE, a, b)
            return out
        add(OUTSIDE, a, min(b, cuts[0]))
        add(OUTSIDE, max(a, cuts[-1]), b)
        i = max(bisect.bisect_right(cuts, a) - 1, 0)
        while i < len(self.names) and cuts[i] < b:
            add(self.names[i], max(a, cuts[i]), min(b, cuts[i + 1]))
            i += 1
        return out


def breakdown(events: Sequence, kernels: Sequence, steps: int,
              limit: int = 6) -> dict:
    """The window by span, per step: ``device_ms`` and ``launches`` of the
    operations by the innermost span that launched them, ``idle_ms`` of
    the device's idle stretches by the innermost span the host was in,
    ``outside_ops`` the operations launched outside every span (name, ms
    per step), ``syncs`` the blocking runtime calls (call, innermost span,
    the host operations that hold it on the calling thread, outermost
    first, count per step)."""
    from benchmark import yardstick as ys
    inner = _Innermost(events)
    calls = launch_calls(events)
    device: Dict[str, float] = {}
    launches: Dict[str, float] = {}
    outside: Dict[str, float] = {}
    for k in kernels:
        call = calls.get(k.id)
        name = inner.at(call.time_range.start) if call else OUTSIDE
        ms = (k.time_range.end - k.time_range.start) / 1e3 / steps
        device[name] = device.get(name, 0.0) + ms
        launches[name] = launches.get(name, 0.0) + 1 / steps
        if name == OUTSIDE:
            outside[k.name] = outside.get(k.name, 0.0) + ms
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    idle: Dict[str, float] = {}
    at = lo
    for a, b in ys.busy_intervals(kernels) + [[hi, hi]]:
        if a > at:
            for name, us in inner.split(at, min(a, hi)).items():
                idle[name] = idle.get(name, 0.0) + us / 1e3 / steps
        at = max(at, b)
    ops = [e for e in events if _host(e) and e.name.startswith("aten::")]
    syncs: Dict[tuple, int] = {}
    for e in events:
        if not (_host(e) and e.name in SYNC_CALLS):
            continue
        t = e.time_range.start
        cover = sorted((o.time_range.start, o.name) for o in ops
                       if o.thread == e.thread
                       and o.time_range.start <= t <= o.time_range.end)
        key = (e.name, inner.at(t),
               " > ".join(n for _, n in cover) if cover else "none")
        syncs[key] = syncs.get(key, 0) + 1
    return {"device_ms": device, "launches": launches, "idle_ms": idle,
            "outside_ops": sorted(([n, v] for n, v in outside.items()),
                                  key=lambda x: -x[1])[:limit],
            "syncs": [[*k, n / steps] for k, n in sorted(syncs.items())]}
