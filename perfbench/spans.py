"""The port's own step spans and counters (``serving/engine.py`` and
``serving/paged_runtime.py`` on ``core/obs.py::Tracer``), read beside
runs of one cell, with the traced steps' idle gaps put down to them.

    python3 perfbench/spans.py --workload <cell> --seeds 11,12,13 \
        --seconds 51 [--modes 1a,0n,0x] [--out spans.jsonl]
    python3 perfbench/spans.py --cost 32,40

A mode is one run of the cell a seed: ``1`` or ``0`` for ``--trace``,
``a`` with the program's recorder attached, ``n`` without it, ``x`` with
it attached and the step spans on every other step only (the overhead
of the spans, in turns within one run: :func:`overhead`).  A seed's
modes run in turns, in reverse order on every other seed.  Prints one
JSON line a run: the result's metrics, the schedule line, and with the
recorder the readings below.  ``--cost`` prints what a step's span
calls and, with no recorder, its guards cost the host at each number of
layers (:func:`span_cost_us`, :func:`guard_cost_us`).

The benchmark's own runs (``run.py``) attach no recorder.  Here
``harness.run_cell`` runs with a hook (:class:`Attach`) that attaches a
``serving/trace.py::FlightRecorder`` when the schedule's loop first asks
the engine for work, after the warm requests, as ``launch/serve.py``
attaches its recorder after warming.  Its request segments take the
harness's own stamps (those ``finalize_step`` is given); its step spans
take a clock on the same base, the harness's seconds after the
schedule's origin, tied to the profiler's time base by one anchor pair
``(clock(), time.time_ns())`` read back to back: ``torch.profiler``'s
event times are microseconds after ``kineto_results.trace_start_ns()``,
on ``time.time_ns()``'s clock.  This tool is for bounded runs: it keeps
every window step's record (the recorder itself keeps a ring).

Readings over the window's steps (those of ``harness.Context.steps``):

- ``queue_wait_p90_ms``: 90th percentile, over the requests due in the
  window with a first token by the run's end, of their ``sched_queued``
  seconds before it (``FlightRecorder.first_token_splits``);
- ``forward_host_pct``: sum of ``step.forward`` over the sum of
  ``step.copy_in``, ``step.forward`` and ``step.sync_out`` (the region
  ``StepReport.compute_s`` times), in percent;
- ``attention_pad_pct``: 100 x (1 - sum of ``rows`` over the sum of
  ``lane_slots``), the lane-major attention call's pad slots;
- ``per_step``: the counters a step on average (``lanes``, ``rows``,
  ``lane_slots``, ``chunk_tokens``), and the share of the pad slots that
  lie in steps with a prefill chunk, where every lane is padded to the
  chunk's rows;

and the checks: those three spans against the sum of ``compute_s``; the
share of ``engine.step`` its ``step.*`` children cover; with ``--trace
1``, each idle gap of the traced steps under the innermost of the
harness's labels and the program's spans it began in, the total against
the harness's own breakdown, and the share of what fell on
``model.forward`` that now falls on a ``fwd.*`` or ``step.*`` span.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Sequence, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, stats, yardstick  # noqa: E402

COMPUTE = ("step.copy_in", "step.forward", "step.sync_out")
OUTSIDE = "engine.step or loop"       # the harness's name for no label


class Attach:
    """The hook: attaches a recorder to the engine at the schedule's
    origin and pairs each later step's span record with the harness's
    stamps of that step, ``(record, start, end, compute_s)``.

    The recorder's clock is the harness's: seconds after the schedule's
    origin, ``perf_counter() - base``.  The hook cannot see the origin,
    so it takes ``base`` from the first step's stamps, ``perf_counter() -
    end`` on entering its ``finalize_step`` (a microsecond or so after the
    harness's ``end``), and only then gives the recorder its clock: the
    request segments start with the first step of the schedule, the step
    spans with the second (both in the preamble).  With ``alternate``,
    the clock is taken away again after each step that had it, so the
    spans are on every other step; ``walls`` keeps each step's ``(had
    spans, start, end)``."""

    def __init__(self, attach: bool = True, alternate: bool = False):
        self.attach = attach
        self.alternate = alternate
        self.recorder = None
        self.base: Optional[float] = None
        self.anchor: Optional[Tuple[float, int]] = None
        self.steps: List[tuple] = []
        self.walls: List[tuple] = []

    def clock(self) -> float:
        return time.perf_counter() - self.base

    def __call__(self, engine) -> None:
        from repro_torch.serving.trace import FlightRecorder
        has_work, finalize = engine.has_work, engine.finalize_step

        def first_ask():
            engine.has_work = has_work
            if self.attach:
                self.recorder = FlightRecorder()
                engine.tracer = self.recorder
            return has_work()

        def finalize_step(report, end_time, start_time=None):
            now = time.perf_counter()
            rec = self.recorder
            on = rec is not None and rec.clock is not None
            finalize(report, end_time, start_time)
            if rec is None:
                return
            if report.kind != "idle":
                self.walls.append((on, start_time, end_time))
                if on:
                    self.steps.append((rec.steps[-1], start_time, end_time,
                                       report.compute_s))
            if self.base is None:
                self.base = now - end_time
                self.anchor = (self.clock(), time.time_ns())
            rec.clock = None if self.alternate and on else self.clock
        engine.has_work = first_ask
        engine.finalize_step = finalize_step

    def window(self, w0: float, w1: float) -> List[tuple]:
        """The steps the harness counts in its window."""
        return [s for s in self.steps if w0 <= s[1] and s[2] <= w1]


# ------------------------------------------------------------- readings
def queue_wait_p90_ms(recorder, ctx) -> Optional[float]:
    """See the module's docstring; None with no such request."""
    splits = recorder.first_token_splits()
    waits = [splits[("bench", r.src.rid)].get("sched_queued", 0.0)
             for r in ctx.window_requests()
             if ("bench", r.src.rid) in splits]
    return 1e3 * stats.percentile(waits, 90) if waits else None


def forward_host_pct(steps: Sequence[tuple]) -> Optional[float]:
    timed = sum(rec.total(n) for rec, *_ in steps for n in COMPUTE)
    if not timed:
        return None
    return 100.0 * sum(rec.total("step.forward") for rec, *_ in steps) / timed


def attention_pad_pct(steps: Sequence[tuple]) -> Optional[float]:
    slots = sum(rec.args["lane_slots"] for rec, *_ in steps)
    if not slots:
        return None
    return 100.0 * (1.0 - sum(rec.args["rows"] for rec, *_ in steps) / slots)


def per_step(steps: Sequence[tuple]) -> Dict[str, float]:
    """The counters a step on average, and the share of the pad slots
    (``lane_slots`` - ``rows``) in steps with a prefill chunk."""
    if not steps:
        return {}
    out = {k: sum(rec.args[k] for rec, *_ in steps) / len(steps)
           for k in ("lanes", "rows", "lane_slots", "chunk_tokens")}
    pad = [(rec.args["lane_slots"] - rec.args["rows"],
            rec.args["chunk_tokens"] > 0) for rec, *_ in steps]
    total = sum(p for p, _ in pad)
    out["pad_on_chunk_steps_pct"] = (100.0 * sum(p for p, c in pad if c)
                                     / total if total else None)
    return out


def overhead(walls: Sequence[tuple], w0: float, w1: float) -> Dict:
    """With the spans on every other step: the window's step walls with
    and without them (ms, p50), and the differences within disjoint
    pairs of consecutive steps, one of each (with minus without; median,
    mean and its standard error, and the mean as a share of the p50)."""
    seq = [(on, 1e3 * (e - s)) for on, s, e in walls if w0 <= s and e <= w1]
    diffs = [(a[1] - b[1]) if a[0] else (b[1] - a[1])
             for a, b in zip(seq[0::2], seq[1::2]) if a[0] != b[0]]
    if len(diffs) < 2:
        return {}
    p50 = stats.percentile([w for _, w in seq], 50)
    mean = statistics.fmean(diffs)
    return {"pairs": len(diffs),
            "step_ms_p50_with": stats.percentile(
                [w for on, w in seq if on], 50),
            "step_ms_p50_without": stats.percentile(
                [w for on, w in seq if not on], 50),
            "diff_ms_p50": stats.percentile(diffs, 50),
            "diff_ms_mean": mean,
            "diff_ms_se": statistics.stdev(diffs) / len(diffs) ** 0.5,
            "diff_pct_of_step_p50": 100.0 * mean / p50}


def span_cost_us(layers: int, reps: int = 2000) -> float:
    """Host microseconds of one paged step's span calls at ``layers``
    layers, on a clock like :class:`Attach`'s: the record opened, its
    phases in the engine's order, its counters, closed and finalized
    (best of 5 x ``reps``)."""
    import timeit

    from repro_torch.core.obs import StepSpans
    att = Attach()
    att.base = time.perf_counter()
    per_layer = ("fwd.qkv", "fwd.kv_write", "fwd.attention", "fwd.out",
                 "fwd.ffn")

    def step():
        sp = StepSpans(att.clock)
        sp.phase("step.plan")
        sp.args.update(lanes=1, rows=1, lane_slots=1)
        sp.phase("step.pack")
        sp.phase("step.sync_in")
        t_fwd = sp.phase("step.copy_in")
        sp.restart()
        sp.phase("fwd.embed")
        for _ in range(layers):
            for name in per_layer:
                sp.phase(name)
        sp.phase("fwd.logits")
        sp.span("step.forward", t_fwd)
        sp.phase("step.sync_out")
        sp.args["chunk_tokens"] = 0
        sp.phase("step.readback")
        sp.phase("step.commit")
        sp.close()
        sp.span("engine.finalize", att.clock())
    return 1e6 * min(timeit.repeat(step, number=reps, repeat=5)) / reps


def guard_cost_us(sites: int, reps: int = 20000) -> float:
    """Host microseconds of ``sites`` guards ``if sp is not None`` on no
    record (what the spans cost a step when no recorder has a clock),
    less a function of as many plain statements: best of 5 x ``reps``."""
    import timeit
    ns: Dict = {}
    exec("def guards(sp):\n" + "    if sp is not None:\n"
         "        sp.phase('x')\n" * sites + "    return sp\n"
         "def plain(sp):\n" + "    pass\n" * sites + "    return sp\n",
         ns)
    best = [min(timeit.repeat(lambda: f(None), number=reps, repeat=5))
            for f in (ns["guards"], ns["plain"])]
    return 1e6 * (best[0] - best[1]) / reps


def step_checks(steps: Sequence[tuple]) -> Dict:
    """The spans against the harness's clock and ``compute_s``."""
    root = sum(rec.t1 - rec.t0 for rec, *_ in steps)
    timed = sum(rec.total(n) for rec, *_ in steps for n in COMPUTE)
    compute = sum(c for *_, c in steps)
    children = sum(e - s for rec, *_ in steps
                   for n, s, e in zip(rec.names, rec.starts, rec.ends)
                   if n.startswith("step."))
    return {"steps": len(steps),
            "compute_spans_over_compute_s": timed / compute if compute
            else None,
            "children_cover_step": children / root if root else None,
            "engine_step_over_harness_wall": root / sum(
                e - s for _, s, e, _ in steps) if steps else None}


def mean_ms(steps: Sequence[tuple]) -> Dict[str, float]:
    """Mean milliseconds a step of each span name (a ``fwd.*`` name summed
    over the layers), the root ``engine.step`` first."""
    tot: Dict[str, float] = {}
    for rec, *_ in steps:
        tot["engine.step"] = tot.get("engine.step", 0.0) + rec.t1 - rec.t0
        for n, s, e in zip(rec.names, rec.starts, rec.ends):
            tot[n] = tot.get(n, 0.0) + e - s
    return {n: 1e3 * v / len(steps) for n, v in tot.items()} if steps else {}


# ---------------------------------------------------------------- trace
def trace_offset_us(anchor: Tuple[float, int], trace_start_ns: int) -> float:
    """The profiler's microseconds at clock 0: a clock time ``t`` is at
    ``t * 1e6 + offset`` in the trace."""
    clock0, ns0 = anchor
    return (ns0 - trace_start_ns) / 1e3 - clock0 * 1e6


def program_spans(records, offset_us: float) -> List[tuple]:
    """(start, end, name) in the trace's microseconds of every span of
    the step records (``engine.finalize`` included) that ends after the
    trace began."""
    return [(s * 1e6 + offset_us, e * 1e6 + offset_us, n)
            for rec in records if rec.t1 is not None
            for n, s, e in rec.spans() if e * 1e6 + offset_us >= 0.0]


def innermost(points: Sequence[float], spans: Sequence[tuple]) -> List[str]:
    """For each of the sorted ``points``, the name of the shortest span
    (start, end, name) holding it, or the harness's name for none: one
    sweep, holding only the spans open at the point."""
    order = sorted(spans)
    out, open_, i = [], [], 0
    for t in points:
        while i < len(order) and order[i][0] <= t:
            open_.append(order[i])
            i += 1
        open_ = [sp for sp in open_ if t < sp[1]]
        out.append(min(open_, key=lambda sp: sp[1] - sp[0])[2] if open_
                   else OUTSIDE)
    return out


def attribute(gaps: Sequence[tuple], labels: Sequence[tuple],
              spans: Sequence[tuple]) -> Dict:
    """Each idle gap (start, end; microseconds) under the innermost of the
    harness's labels as the harness names it, and under the innermost of
    the labels and the program's spans: seconds by name both ways, and
    the share of the ``model.forward`` seconds the spans name ``fwd.*``
    or ``step.*``."""
    gaps = sorted(gaps)
    starts = [g0 for g0, _ in gaps]
    old: Dict[str, float] = {}
    new: Dict[str, float] = {}
    fwd = moved = 0.0
    for (g0, g1), a, b in zip(gaps, innermost(starts, labels),
                              innermost(starts, list(labels) + list(spans))):
        d = (g1 - g0) / 1e6
        old[a] = old.get(a, 0.0) + d
        new[b] = new.get(b, 0.0) + d
        if a == "model.forward":
            fwd += d
            moved += d if b.startswith(("fwd.", "step.")) else 0.0
    return {"old": old, "new": new,
            "moved_from_model_forward": moved / fwd if fwd else None}


def read_gaps(prof, trace: Dict, att: Attach) -> Dict:
    """The traced steps' idle gaps (between the kernels ``trace``, the
    harness's ``read_trace``, found) by the harness's labels and by the
    program's spans, and how far the two clocks agree: each
    ``model.forward`` label against the mapped ``fwd.embed`` start and
    ``fwd.logits`` end inside it (microseconds)."""
    import torch
    labels = [(e.time_range.start, e.time_range.end, e.name)
              for e in prof.events() if e.name in harness.LABELS
              and e.device_type != torch.autograd.DeviceType.CUDA]
    off = trace_offset_us(att.anchor,
                          prof.profiler.kineto_results.trace_start_ns())
    spans = program_spans(att.recorder.steps, off)
    out = attribute(yardstick.idle_gaps([(s, e) for _, s, e
                                         in trace["kernels"]]),
                    labels, spans)
    out["harness_total_s"] = sum(trace["gaps"].values())
    lead, lag = [], []
    embeds = [s for s in spans if s[2] == "fwd.embed"]
    ends = [s for s in spans if s[2] == "fwd.logits"]
    for a, b, name in labels:
        if name != "model.forward":
            continue
        e0 = [s[0] for s in embeds if a <= s[0] <= b]
        e1 = [s[1] for s in ends if a <= s[1] <= b]
        if e0 and e1:
            lead.append(min(e0) - a)
            lag.append(b - max(e1))
    out["time_base_us"] = {
        "forwards_matched": len(lead),
        "forwards": sum(1 for *_, n in labels if n == "model.forward"),
        "embed_after_label_p50": stats.percentile(lead, 50) if lead else None,
        "embed_after_label_min": min(lead) if lead else None,
        "label_after_logits_p50": stats.percentile(lag, 50) if lag else None,
        "label_after_logits_min": min(lag) if lag else None}
    return out


# ------------------------------------------------------------------ run
def run(cell, seed: int, seconds: float, trace: bool, attach: bool,
        **kw) -> Tuple[Dict, Dict]:
    """One run of ``cell`` through ``harness.run_cell``: the row printed,
    and what was read on the way (``ctx``, the harness's ``Context``;
    ``att``, the :class:`Attach`; with a trace ``prof`` and ``trace``).
    ``kw`` goes to ``run_cell`` (the CPU tests' device and sizes)."""
    att = Attach(attach, alternate=kw.pop("alternate", False))
    seen: Dict = {"att": att}
    read_metrics, read_trace = harness.read_metrics, harness.read_trace

    def metrics_w(entries, ctx):
        seen["ctx"] = ctx
        return read_metrics(entries, ctx)

    def trace_w(prof, steps):
        seen["prof"] = prof
        seen["trace"] = read_trace(prof, steps)
        return seen["trace"]
    lines: List[str] = []
    harness.read_metrics, harness.read_trace = metrics_w, trace_w
    try:
        result, _ = harness.run_cell(cell, seed, seconds, trace,
                                     t_start=kw.pop("t_start", T_START),
                                     hook=att, log=lines.append, **kw)
    finally:
        harness.read_metrics, harness.read_trace = read_metrics, read_trace
    ctx = seen["ctx"]
    sched = [json.loads(x)["schedule"] for x in lines if '"schedule"' in x]
    row = {"workload": cell.name, "seed": seed, "trace": int(trace),
           "attached": attach, "correct": result["correct"],
           "device": result["device"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "schedule": sched[-1] if sched else None}
    if att.recorder is None:
        return row, seen
    steps = att.window(ctx.w0, ctx.w1)
    row["program"] = {
        "queue_wait_p90_ms": queue_wait_p90_ms(att.recorder, ctx),
        "forward_host_pct": forward_host_pct(steps),
        "attention_pad_pct": attention_pad_pct(steps),
        "per_step": per_step(steps),
        **step_checks(steps), "mean_ms": mean_ms(steps)}
    if att.alternate:
        row["overhead"] = overhead(att.walls, ctx.w0, ctx.w1)
    if "prof" in seen and att.anchor is not None:
        row["gaps"] = read_gaps(seen["prof"], seen["trace"], att)
    return row, seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seeds")
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--modes", default="1a")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cost", default=None,
                    help="layer counts, comma-separated")
    args = ap.parse_args(argv)
    if args.cost:
        for layers in (int(x) for x in args.cost.split(",")):
            sites = 5 * layers + 15     # the guards a paged step runs
            print(json.dumps({"layers": layers, "guards": sites,
                              "guard_cost_us": guard_cost_us(sites),
                              "span_cost_us": span_cost_us(layers)}))
        return 0
    if not (args.workload and args.seeds and args.seconds):
        ap.error("--workload, --seeds and --seconds, or --cost")

    cell = harness.load_cell(args.workload)
    modes = args.modes.split(",")
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for mode in (modes if i % 2 == 0 else modes[::-1]):
            row, _ = run(cell, seed, args.seconds, mode[0] == "1",
                         mode[1] != "n", t_start=time.perf_counter(),
                         alternate=mode[1] == "x")
            print(json.dumps(row), flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
