"""Run one cell of the benchmark on the card(s) of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result's JSON object; earlier lines give the card, the schedule and how
late the loop ran against it.  The last lines of standard error give each
number the check compared, beside its limit.  Exits non-zero, with no
result, when the cell's cards are missing or a forbidden module (JAX or
the JAX package) was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness
    cell = harness.load_cell(args.workload)
    try:
        result, _ = harness.run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), t_start=T_START)
    except harness.NoCard as err:
        print(f"no result: {err}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
