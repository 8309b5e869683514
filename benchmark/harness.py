"""The benchmark's engine: finds a cell's files by name, runs it through its
traffic's loop, reads the per-layer metrics, decides ``correct`` and
builds the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the names in
``BENCHMARK.json``:

    benchmark/configs/<config>.json     sizes, head, optimizer, FLOPs
    benchmark/traffic/<traffic>.json    the mix's parameters and its loop
    benchmark/workloads/<cell>.json     the cell's limits for ``correct``
    benchmark/metrics/<metric>.py       read(run) → number or None
    benchmark/loops/<loop>.py           the general generator of a kind of
                                        traffic (train, embed)

so a later change adds a configuration, a cell or a metric by adding files
and entries, with no edit to a file that is there.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import re
import sys
import time
import types
from pathlib import Path
from typing import List, Optional

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# modules that must not be loaded in a run, compared by the top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fr_tpu")


class BenchError(Exception):
    """A cell that cannot be run as stated."""


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def refuse_forbidden() -> None:
    """Raises BenchError naming the forbidden modules that are loaded."""
    found = forbidden_modules()
    if found:
        raise BenchError("modules that the port must not load: "
                         + ", ".join(found))


def load_manifest(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        manifest = json.load(fh)
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[section]:
            if not NAME.match(entry["name"]):
                raise BenchError(f"bad name {entry['name']!r} in {section}")
            if "unit" in entry and not UNIT.match(entry["unit"]):
                raise BenchError(f"bad unit {entry['unit']!r}")
    return manifest


def _json(path: Path) -> dict:
    if not path.is_file():
        raise BenchError(f"no file {path}")
    with open(path) as fh:
        return json.load(fh)


def cell_files(root: Path, manifest: dict, cell: str) -> dict:
    """The cell's entry, configuration, traffic (with the cell's own
    overrides) and limits."""
    entry = next((w for w in manifest["workloads"] if w["name"] == cell),
                 None)
    if entry is None:
        raise BenchError(f"no cell {cell!r} in BENCHMARK.json")
    cfg_entry = next(c for c in manifest["configs"]
                     if c["name"] == entry["config"])
    cfg = _json(root / cfg_entry["file"])
    bench = root / "benchmark"
    traffic = _json(bench / "traffic" / f"{entry['traffic']}.json")
    own = _json(bench / "workloads" / f"{cell}.json")
    traffic = {**traffic, **own.get("traffic", {})}
    return {"entry": entry, "config": cfg, "traffic": traffic,
            "limits": own["limits"]}


def cell_metrics(manifest: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` that the cell reports: those whose
    ``workloads`` list it, or, for an end-to-end metric without such a
    list, every cell."""
    return [m for m in manifest[section]
            if cell in m.get("workloads", [cell])]


def metric_reader(root: Path, name: str):
    """benchmark/metrics/<name>.py's ``read``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no reader {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loop_for(traffic: dict, mesh: bool = False):
    """The Loop of the traffic's loop, or of its mesh variant
    (``loops/<loop>_mesh.py``) for a cell of more than one card."""
    name = f"{traffic['loop']}_mesh" if mesh else traffic["loop"]
    path = Path(__file__).resolve().parent / "loops" / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no loop {path}")
    return importlib.import_module(f"benchmark.loops.{name}").Loop


def run_cell(root: Path, cell: str, seed: int, seconds: float, trace: bool,
             t_start: Optional[float] = None) -> dict:
    """One run of ``cell`` on the first card: set-up, the window, the
    traced steps with ``trace``, then the check. Returns the result line as
    a dict; raises BenchError where the run must print no result."""
    import torch
    from benchmark import yardstick as ys

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device("cuda:0")
    manifest = load_manifest(root)
    files = cell_files(root, manifest, cell)
    loop = loop_for(files["traffic"])(files["config"], files["traffic"],
                                      seed, dev)
    loop.setup()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    win = loop.window(seconds)
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    name = torch.cuda.get_device_name(dev)
    run = types.SimpleNamespace(
        kind=loop.kind, cfg=files["config"], traffic=files["traffic"],
        window=win, peak=ys.peak_for(name), setup_s=setup_s,
        peak_bytes=peak_bytes, trace=None)
    device_info = {"platform": "gpu", "kind": name, "count": 1,
                   "memory_peak_bytes": int(peak_bytes)}
    if trace:
        run.trace = profile(loop, files["traffic"]["profiled_steps"], True)
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
    result = conclude(root, manifest, cell, files, loop, run, device_info)
    result["card"] = ys.power_limit(0)
    result["checks"] = result.pop("checks")
    return result


def run_rank(root: Path, cell: str, seed: int, seconds: float,
             trace: bool, rank: int, world: int, t_start: float,
             backend: str = "nccl") -> Optional[dict]:
    """One rank's part of a run of a cell of ``world`` cards
    (``ranks.py`` starts them): joins the process group, builds the mesh
    of the configuration's ``deployment.mesh`` and runs the traffic's mesh
    loop on this rank's card. Set-up ends at a barrier; ``setup_s`` is
    rank 0's clock from ``t_start``; the peak is the largest of any rank's.
    With ``trace`` every rank runs the traced steps and rank 0 profiles
    them. Returns the result line on rank 0, None on the others; raises
    BenchError where the run must print no result."""
    import torch
    import torch.distributed as dist
    from benchmark import ranks
    from benchmark import yardstick as ys

    manifest = load_manifest(root)
    files = cell_files(root, manifest, cell)
    try:
        loop = ranks.mesh_loops(files, rank, world, backend)(seed)
        dev = loop.device
        cuda = dev.type == "cuda"
        print(f"set-up of rank {rank}", file=sys.stderr, flush=True)
        loop.setup()
        loop.barrier()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - t_start
        print(f"window of rank {rank}", file=sys.stderr, flush=True)
        win = loop.window(seconds)
        print(f"rank {rank}: {win['steps']} steps in the window",
              file=sys.stderr, flush=True)
        peak_bytes = int(loop.total(
            torch.cuda.max_memory_allocated(dev) if cuda else 0,
            dist.ReduceOp.MAX))
        name = torch.cuda.get_device_name(dev) if cuda else "cpu"
        run = types.SimpleNamespace(
            kind=loop.kind, cfg=files["config"], traffic=files["traffic"],
            window=win, peak=ys.peak_for(name), setup_s=setup_s,
            peak_bytes=peak_bytes, trace=None)
        device_info = {"platform": "gpu" if cuda else "cpu", "kind": name,
                       "count": world, "memory_peak_bytes": peak_bytes}
        if trace:
            steps = files["traffic"]["profiled_steps"]
            if loop.lead:
                run.trace = profile(loop, steps, cuda)
                device_info["busy_s"] = run.trace.busy_s
                device_info["window_s"] = run.trace.window_s
            else:
                loop.traced(steps)
        result = conclude(root, manifest, cell, files, loop, run,
                          device_info)
        if result is not None:
            result["card"] = ys.power_limit(rank) if cuda else "cpu"
            result["checks"] = result.pop("checks")
        return result
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def conclude(root: Path, manifest: dict, cell: str, files: dict, loop,
             run, device_info: dict) -> Optional[dict]:
    """What follows the window: the cell's metrics read from ``run``, the
    step recorded after the window, the program's state freed, the check
    of ``correct`` against the reference, and the look for modules that
    must not be loaded. Returns the result line as a dict, ``checks``
    last. On a mesh every rank records and frees, rank 0 (the loop's
    ``lead``) alone reads and checks, and the others return None."""
    import torch

    lead = getattr(loop, "lead", True)
    section = "per_layer" if run.trace is not None else "end_to_end"
    metrics = {}
    for m in cell_metrics(manifest, cell, section) if lead else ():
        value = metric_reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    loop.after_window()
    loop.release()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    if not lead:
        refuse_forbidden()
        return None
    t_check = time.perf_counter()
    readings = loop.readings(("program",))["program"]
    # each cell compares the numbers its limits name
    checks = {k: {"value": readings[k], "limit": v}
              for k, v in files["limits"].items()}
    checks["failed_steps"] = {"value": run.window["failed"], "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    print(f"check seconds: {time.perf_counter() - t_check:.1f}",
          file=sys.stderr)
    refuse_forbidden()
    result = {"correct": correct, "attempted": run.window["steps"],
              "failed": run.window["failed"], "metrics": metrics,
              "device": device_info}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown
    result["checks"] = checks
    return result


def profile(loop, steps: int, cuda: bool):
    """A torch.profiler window of ``steps`` steps: its length, the device's
    busy time and operations, the head's ranges and the breakdown."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from benchmark import yardstick as ys

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with tprofile(activities=acts) as prof:
        timed = loop.traced(steps)
    events = prof.events()
    kernels = ys.device_events(events)
    if cuda and not kernels:
        raise BenchError("the profiler recorded no device operation")
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    return types.SimpleNamespace(
        steps=steps, window_s=timed["elapsed"], events=events,
        kernels=kernels, busy_s=ys.busy_s(kernels),
        head_ms=ys.head_ms(events, kernels, steps),
        breakdown={"device_ops": ys.top_device_ops(kernels),
                   "idle_gaps": ys.idle_gaps(events, kernels, (lo, hi))})
