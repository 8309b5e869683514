"""The benchmark's measuring rods, kept here so that a change to the program
cannot move them: the table of peaks, the FLOP and byte counts of the
rooflines, the mfu formula, the percentiles, and the reduction of a
``torch.profiler`` window to device busy time, launches, the head's ranges,
the busiest operations and the longest idle gaps.

The reduction of a window is a frozen copy of the program's
``utils/profiling.py`` (``device_events``, ``busy_ms``) and of the
attribution of kernels to the training step's ``pfc_head:*`` ranges that
the port's smoke script uses: a kernel belongs to the host range that
holds its launch call (a CUDA API call, ``cu*``), kernel and launch call
sharing a correlation id, which is the event's ``id``.
"""

from __future__ import annotations

import bisect
import subprocess
from typing import Dict, List, Optional, Sequence

import numpy as np

# NVIDIA H100 SXM5 data sheet, dense (no sparsity), at its 700 W limit;
# keyed by torch.cuda.get_device_name
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12,
                                   "bytes_per_s": 3.35e12}}

# the training step's host ranges around the head's parts (the program
# names them; the benchmark only reads them)
HEAD_RANGE = "pfc_head:"


def power_limit(index: int = 0) -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def peak_for(device_name: str) -> Optional[dict]:
    return PEAKS.get(device_name)


def mfu(flops_per_img: float, imgs_per_s: float, peak: dict) -> float:
    """The share of the card's dense bf16 peak that ``imgs_per_s`` images
    of ``flops_per_img`` each amount to."""
    return flops_per_img * imgs_per_s / peak["bf16_flops"]


def mesh(cfg: dict) -> tuple:
    """(data, model): the configuration's mesh, (1, 1) for one card."""
    shape = cfg.get("deployment", {}).get("mesh", {"data": 1, "model": 1})
    return shape["data"], shape["model"]


def chips(cfg: dict) -> int:
    data, model = mesh(cfg)
    return data * model


def train_flops_per_img(cfg: dict) -> float:
    """3 × the encoder's forward FLOPs (forward, and the backward's two
    products) + 6·D·n of the head's logits and their two gradients over
    the n sampled columns: every shard's ``sampled_columns`` on a mesh,
    since each image meets the columns of every shard."""
    head = cfg["head"]
    return (3.0 * cfg["fwd_flops_per_img"]
            + 6.0 * head["emd_size"] * (head["sampled_columns"]
                                        * mesh(cfg)[1]))


def margin_ce_least_s(b: int, n: int, d: int, peak: dict) -> float:
    """Least time of the margin-softmax CE's forward and backward over b
    embeddings and n drawn f32 rows of width d: the larger of 6·b·n·d
    FLOPs at the peak rate and, at the peak bandwidth, the rows read once,
    their gradient written once, the embeddings read and their gradient
    written (f32)."""
    flops = 6.0 * b * n * d
    nbytes = 4.0 * (2 * n * d + 2 * b * d)
    return max(flops / peak["bf16_flops"], nbytes / peak["bytes_per_s"])


def rows_update_least_s(n: int, d: int, peak: dict) -> float:
    """Least time of SGD-momentum on n f32 rows of width d: the rows and
    their momentum read and written, the row gradient read, 5·n·d·4
    bytes."""
    return 5.0 * n * d * 4 / peak["bytes_per_s"]


def percentile(values: Sequence[float], q: float) -> float:
    """numpy's linear-interpolation percentile."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


# ---------------------------------------------------------------------------
# torch.profiler windows
# ---------------------------------------------------------------------------

def _is_device(e) -> bool:
    import torch
    return e.device_type == torch.autograd.DeviceType.CUDA


def device_events(events: Sequence) -> List:
    """The device's operations (kernels, copies, sets) among a window's
    events, without the step's ``pfc_head:*`` ranges that the profiler
    mirrors onto the device's timeline."""
    return [e for e in events
            if _is_device(e) and not e.name.startswith(HEAD_RANGE)]


def busy_intervals(kernels: Sequence) -> List[List[float]]:
    """The union of the operations' intervals (µs), sorted."""
    out: List[List[float]] = []
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(kernels: Sequence) -> float:
    """Seconds in which at least one of the operations ran."""
    return sum(b - a for a, b in busy_intervals(kernels)) / 1e6


def overlap_s(first: Sequence, second: Sequence) -> float:
    """Seconds in which an operation of ``first`` and one of ``second``
    both ran."""
    a, b = busy_intervals(first), busy_intervals(second)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total / 1e6


# NCCL's kernels (``ncclDevKernel_*``, ``ncclKernel_*``): the collectives
COLLECTIVE_KERNEL = "nccl"


def collective_kernels(kernels: Sequence) -> tuple:
    """(the collectives' kernels, every other device operation)."""
    mine, rest = [], []
    for e in kernels:
        (mine if COLLECTIVE_KERNEL in e.name.lower() else rest).append(e)
    return mine, rest


def head_ms(events: Sequence, kernels: Sequence, steps: int
            ) -> Dict[str, float]:
    """{part: device ms per step} of the operations launched inside the
    step's ``pfc_head:<part>`` host ranges."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.device_type == cpu and e.name.startswith(HEAD_RANGE))
    starts = [a for a, _, _ in spans]
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == cpu and e.name.startswith("cu")}
    out: Dict[str, float] = {}
    for k in kernels:
        t = launched.get(k.id)
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= spans[i][1]:
            part = spans[i][2][len(HEAD_RANGE):]
            out[part] = out.get(part, 0.0) + (
                k.time_range.end - k.time_range.start) / 1e3 / steps
    return out


def top_device_ops(kernels: Sequence, limit: int = 10) -> List[list]:
    """[[name, seconds]] of the operations that took most device time."""
    total: Dict[str, float] = {}
    for e in kernels:
        total[e.name] = total.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6
    return [[n, s] for n, s in sorted(total.items(),
                                       key=lambda kv: -kv[1])[:limit]]


def idle_gaps(events: Sequence, kernels: Sequence, window_us,
              limit: int = 10) -> List[list]:
    """[[what the host was doing, seconds]] of the longest stretches in
    which no device operation ran inside ``window_us`` (start, end), each
    named by the innermost host operation that covers the gap's middle."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    busy = busy_intervals(kernels)
    lo, hi = window_us
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, min(a, hi)))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:limit]
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == cpu]
    out = []
    for a, b in gaps:
        mid = (a + b) / 2
        cover = [h for h in host if h[0] <= mid <= h[1]]
        name = max(cover)[2] if cover else "no host operation"
        out.append([name, (b - a) / 1e6])
    return out


def count_forward_flops(model: dict, seed: int = 0) -> float:
    """FLOPs of one evaluation-mode forward of the plain reference encoder
    at batch 1 on the CPU, counted by ``FlopCounterMode`` (a multiply-add
    is 2): the convolutions, the linear layers and the attention's two
    products. The configuration files store this count."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from benchmark import inputs
    from benchmark.reference.encoders import forward

    params = inputs.encoder_params(model, seed, "cpu")
    x = torch.zeros(1, model["img_size"], model["img_size"], 3)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        forward(model, params, x, train=False)
    return float(counter.get_total_flops())
