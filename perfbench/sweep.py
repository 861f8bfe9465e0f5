"""Offer a cell's traffic at several fixed rates, one short window each,
in one process, to find the knee once (the cells then run at a fixed
rate; no run searches for one).

    python3 perfbench/sweep.py --workload <cell> --rates 2,4,6 \
        --seconds 20 [--seed 7] [--out chiprun_out/sweep.jsonl]

Prints one JSON line a rate: the end-to-end metrics of every kind, the
schedule (requests due, how late the loop ran, the queue at the close)
and the check's readings.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from perfbench import harness
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(args.workload, bench)
    cell = dataclasses.replace(cell, end_to_end=[
        m for m in bench["end_to_end"] if m["name"] != "setup_s"])
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        lines = []
        result, checks = harness.run_cell(
            cell, args.seed + i, args.seconds, False,
            t_start=time.perf_counter(), rate=rate, log=lines.append)
        row = {"rate_per_s": rate, **{k: v["value"] for k, v in
                                      result["metrics"].items()},
               **json.loads(lines[-1]), "checks": checks,
               "correct": result["correct"]}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
