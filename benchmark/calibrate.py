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
window attention's, operands and gradients rounded to bfloat16). Each
seed runs as a run does: set-up, a window of ``--seconds``, the step
recorded after it, then the reference. Prints one JSON line per seed and,
last, each side's largest and smallest reading of each number. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
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
    args = p.parse_args(argv)

    import torch
    from benchmark import harness

    manifest = harness.load_manifest(ROOT)
    files = harness.cell_files(ROOT, manifest, args.workload)
    sides = tuple(args.sides.split(","))
    every = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        loop = harness.loop_for(files["traffic"])(
            files["config"], files["traffic"], seed, torch.device(args.device))
        loop.setup()
        loop.window(args.seconds)
        loop.after_window()
        loop.release()
        gc.collect()
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()
        got = loop.readings(sides)
        extra = {}
        if args.detail and hasattr(loop, "raw"):
            from benchmark.loops.train import explain
            extra = {part: {side: explain(raw[side], raw["reference"])
                            for side in sides}
                     for part, raw in loop.raw.items()}
        del loop
        gc.collect()
        if torch.device(args.device).type == "cuda":
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
