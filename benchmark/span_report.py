"""One traced run of a cell, with its traced window read by the program's
spans (``spans.breakdown``): device ms per step by the innermost span that
launched each operation, the device's idle time under each span, the
operations launched outside every span, and each blocking runtime call
with its span and host operation.

    python3 benchmark/span_report.py --workload r100_wf42m.train \
        --seed 7 --seconds 15 [--out report.json]

From the root of a checkout, on a card. The run is ``run.py --trace 1``'s
(``harness.run_cell``), its check of ``correct`` included; the report is
one JSON object, its result line's ``correct``, ``metrics``, ``device``
and ``card`` beside the breakdown, printed last on standard output and
written to ``--out`` where given. A checkout whose program records no span
reads every operation as outside every span.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    # run.py's cache paths inside the checkout
    from benchmark import harness, run, spans  # noqa: F401
    kept = {}
    profile = harness.profile

    def keep(loop, steps, cuda):
        kept["trace"] = profile(loop, steps, cuda)
        return kept["trace"]

    harness.profile = keep
    try:
        result = harness.run_cell(ROOT, args.workload, args.seed,
                                  args.seconds, True, t_start=T_START)
    except harness.BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 4
    finally:
        harness.profile = profile
    trace = kept["trace"]
    report = {"workload": args.workload, "seed": args.seed,
              "correct": result["correct"], "metrics": result["metrics"],
              "device": result["device"], "card": result["card"],
              "busy_ms": 1e3 * trace.busy_s / trace.steps,
              "traced_wall_ms": 1e3 * trace.window_s / trace.steps,
              **spans.breakdown(trace.events, trace.kernels, trace.steps)}
    line = json.dumps(report)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
