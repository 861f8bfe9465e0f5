"""The check's readings of a cell on several seeds in one process: the
program's, and the control's — the plain reference computed in float8 put
in the program's place, read at the same prompts and served tokens and
held to the same limits (``control_correct``).  The limits in
``perfbench/limits/<cell>.json`` are set between the two.  Exits 1 unless
every seed's program run is correct and every control reads not correct.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 30 [--out chiprun_out/control.jsonl]

The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from perfbench import harness
    cell = harness.load_cell(args.workload)
    sound = True
    for seed in (int(s) for s in args.seeds.split(",")):
        result, readings = harness.run_cell(
            cell, seed, args.seconds, False, t_start=time.perf_counter(),
            control=True, log=lambda _: None)
        row = {"workload": args.workload, "seed": seed,
               "correct": result["correct"], **readings}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        sound &= result["correct"] and not readings["control_correct"]
    if not sound:
        print("a program run read not correct, or a control read correct",
              file=sys.stderr)
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
