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
    args = p.parse_args(argv)

    import torch
    from benchmark import harness

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
        print("this harness drives one card a run", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(ROOT, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  t_start=T_START)
    except harness.BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        print(f"{k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
