"""The port's bench under its two opt-in arms beside the default, in turn.

    python -m fr_tpu_torch.tools.bench_arms \
        [--rows alternet50,webface42m_head] [--rounds 3]

Arms: ``default``; ``fused`` (BENCH_FUSED=1: the fused CE's contract);
``stats`` (FR_ATTN_STORED_STATS=1: the stored-stats attention). Each round
runs every row under each arm, one bench row process at a time
(fr_tpu_torch/bench.py ``_run_row``, each within BENCH_ROW_TIMEOUT), the
arms in the order default, fused, stats, reversed in every second round, so
that a drift of the card over the run falls on every arm alike. Prints each
run's row to stderr and, last, one JSON object: {row: {arm: entry}}, each
entry the bench's own summary of the rounds (``bench.summarise``: the median
of each summarised key, its spread max - min, and every round's numbers
under "runs"). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

from fr_tpu_torch import bench

ARMS = {"default": {}, "fused": {"BENCH_FUSED": "1"},
        "stats": {"FR_ATTN_STORED_STATS": "1"}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rows", default="alternet50,webface42m_head")
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    rows = args.rows.split(",")
    runs = {row: {arm: [] for arm in ARMS} for row in rows}
    for r in range(args.rounds):
        order = list(ARMS) if r % 2 == 0 else list(ARMS)[::-1]
        for row in rows:
            for arm in order:
                res = bench._run_row(row, "cuda", bench.row_timeout(),
                                     ARMS[arm])
                print(f"# round {r + 1} {row} {arm}: {json.dumps(res)}",
                      file=sys.stderr, flush=True)
                if "value" not in res:
                    raise RuntimeError(f"{row} {arm}: {res.get('error')}")
                runs[row][arm].append(res)
    out = {row: {arm: bench.summarise(row, results)
                 for arm, results in arms.items()}
           for row, arms in runs.items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
