"""The port's benchmark: one run of one cell on the card.

    python3 benchmark/run.py --workload r100_wf42m.train --seed 7 \
        --seconds 20 --trace 0

(or ``python3 -m benchmark.run ...``) from the root of a checkout. The run
makes its inputs from ``--seed``, sets up and warms the cell's shapes,
measures for ``--seconds``, checks what the timed path produced against
the plain reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared
beside its limit. It exits non-zero and prints no result where no card is
found, where the cell cannot run, or where a module of JAX or of the JAX
package is loaded once the window has closed.

A cell of more than one card runs one rank a card: this script builds the
program's kernels once, then starts itself once a rank with the private
arguments ``--rank``, ``--world`` and ``--t-before`` (``ranks.py``); each
rank joins the NCCL group on its card, rank 0 prints the result, and the
run fails with no result once any rank fails or stalls.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / ".cache"
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, help=argparse.SUPPRESS)
    p.add_argument("--t-before", type=float, default=0.0,
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    import torch
    from benchmark import harness

    if args.rank is not None:
        return rank_main(args)

    manifest = harness.load_manifest(ROOT)
    entry = next((w for w in manifest["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no cell {args.workload!r}", file=sys.stderr)
        return 2
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < entry["chips"]:
        print(f"the cell needs {entry['chips']} CUDA device(s); torch finds "
              f"{found}", file=sys.stderr)
        return 3
    if entry["chips"] != 1:
        return launch(args, entry["chips"])
    try:
        result = harness.run_cell(ROOT, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  t_start=T_START)
    except harness.BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    print_checks(result)
    return 0


def print_checks(result: dict) -> None:
    for k, c in result["checks"].items():
        print(f"{k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)


def launch(args, world: int) -> int:
    """Builds the program's kernels once, then runs one rank a card."""
    from benchmark import ranks

    def command(rank):
        return [sys.executable, str(Path(__file__).resolve()),
                "--workload", args.workload, "--seed", str(args.seed),
                "--seconds", repr(args.seconds), "--trace", str(args.trace),
                "--rank", str(rank), "--world", str(world),
                "--t-before", repr(time.perf_counter() - T_START)]
    code, line = ranks.launch_built(command, world)
    if code == 0:
        print(line, flush=True)
        print_checks(json.loads(line))
    return code


def rank_main(args) -> int:
    """One rank of a multi-card cell; rank 0 prints the result."""
    from benchmark import harness

    try:
        result = harness.run_rank(ROOT, args.workload, args.seed,
                                  args.seconds, bool(args.trace), args.rank,
                                  args.world, T_START - args.t_before)
    except harness.BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 4
    if result is not None:
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
