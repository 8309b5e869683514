"""Readings behind the limits of ``correct``: for each seed, the numbers
that a cell compares, read for the program and for the sides that stand
in its place, in one process.

    python3 benchmark/calibrate.py --workload r100_wf42m.train \
        --seeds 11,12,13 --sides program,control,half_batch [--seconds 3]

The sides: ``program`` (the program's readings, as a run takes them),
``control`` (the plain reference with every product's operands rounded to
float8 e4m3, in the program's place) and, for training cells,
``half_batch`` (the reference with the loss over half of each batch, a
planted fault), ``bf16`` and ``bf16_attention`` (witnesses of the
program's precision: the reference with every product's, or only the
window attention's, operands and gradients rounded to bfloat16); for a
cell of more than one card also ``no_grad_sum`` and ``local_head``
(``loops/train_mesh.py``). Each seed runs as a run does: set-up, a window
of ``--seconds``, the step recorded after it, then the reference. A cell
of more than one card runs one rank a card, as ``run.py`` does, every
seed in the same ranks, rank 0 reading. Prints one JSON line per seed
and, last, each side's largest and smallest reading of each number. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sides", default="program,control")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--detail", action="store_true",
                   help="also print each step's loss gap and the leaves "
                        "with the largest gaps")
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    import torch
    from benchmark import harness

    manifest = harness.load_manifest(ROOT)
    files = harness.cell_files(ROOT, manifest, args.workload)
    world = files["entry"]["chips"]
    if world > 1 and args.rank is None:
        from benchmark import ranks
        argv = sys.argv[1:] if argv is None else list(argv)
        return ranks.launch_built(
            lambda r: [sys.executable, str(Path(__file__).resolve()), *argv,
                       "--rank", str(r), "--world", str(world)],
            world, relay_all=True)[0]
    if args.rank is not None:
        from benchmark import ranks
        make = ranks.mesh_loops(files, args.rank, args.world, "nccl")
    else:
        make = functools.partial(harness.loop_for(files["traffic"]),
                                 files["config"], files["traffic"],
                                 device=torch.device(args.device))
    sides = tuple(args.sides.split(","))
    every = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        loop = make(seed)
        device = loop.device
        loop.setup()
        loop.window(args.seconds)
        loop.after_window()
        loop.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if not getattr(loop, "lead", True):
            continue
        print(f"reading seed {seed}", file=sys.stderr, flush=True)
        got = loop.readings(sides)
        extra = {}
        if args.detail and hasattr(loop, "raw"):
            from benchmark.loops.train import explain
            extra = {part: {side: explain(raw[side], raw["reference"])
                            for side in sides}
                     for part, raw in loop.raw.items()}
        del loop
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps({"seed": seed, "readings": got, "detail": extra,
                          "seconds": time.perf_counter() - t0}), flush=True)
        for side, nums in got.items():
            for k, v in nums.items():
                every.setdefault(side, {}).setdefault(k, []).append(v)
    print(json.dumps({"summary": {
        side: {k: {"max": max(v), "min": min(v), "n": len(v)}
               for k, v in nums.items()} for side, nums in every.items()}}),
        flush=True)
    if args.rank is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
