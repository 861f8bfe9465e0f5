"""One run of one cell: the port's paged ``ServingEngine`` driven on the
wall clock by the benchmark's own loop, its end-to-end or per-layer
metrics, and the check of what its timed path produced.

A run, in order:

1. set-up: the card is looked for, the build caches are pointed inside the
   checkout, the weights are drawn on the card from ``--seed``, the engine
   is built over them (``params=``), the mix's warm requests are submitted
   at once and served until each has its first token, and the schedule
   then runs ``preamble_s`` seconds at the cell's own traffic;
2. the window: ``--seconds`` of the same schedule, each request timed from
   when it was due; with ``--trace 1`` a few more steps run under
   ``torch.profiler`` once it has closed;
3. the check: the program's state is freed and the plain reference runs
   over a sample of the finished requests (``perfbench/check.py``).

Every metric is a reader of its own, ``perfbench/metrics/<name>.py``,
with ``read(ctx) -> float | None``; a cell reports the metrics that
``BENCHMARK.json`` gives it.
"""
from __future__ import annotations

import bisect
import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from perfbench import check, references, traffic, weights, yardstick

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names no run may hold: JAX, and the JAX package and its
# benchmarks, which the port's name ``repro_torch`` begins with
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
# the port's kernel build cache, at a fixed place inside the checkout
CACHE = ROOT / ".bench_cache"


class NoCard(RuntimeError):
    """The cell's chips are not there: the run prints no result."""


def forbidden_loaded() -> List[str]:
    """Forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def point_caches() -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so only the first run there builds."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(CACHE / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


@dataclass
class Cell:
    name: str
    config: Dict            # perfbench/configs/<config>.json
    mix: Dict               # perfbench/traffic/<traffic>.json
    chips: int
    limits: Dict            # perfbench/limits/<cell>.json
    end_to_end: List[Dict]  # BENCHMARK.json entries this cell reports
    per_layer: List[Dict]


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[Dict] = None) -> Cell:
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (w,) = [w for w in bench["workloads"] if w["name"] == name]
    (c,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    return Cell(
        name=name,
        config=json.loads((ROOT / c["file"]).read_text()),
        mix=traffic.load(w["traffic"]),
        chips=int(w["chips"]),
        limits=json.loads((BENCH / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def model_spec(config: Dict) -> Dict:
    """The model's sizes as run, with its dtype."""
    return dict(config["model"], dtype=config["dtype"])


def check_layout(plan, tree: Dict) -> None:
    """The benchmark's weight tree has the port's plan's leaves, shapes and
    dtypes."""
    from repro_torch.models.params import torch_dtype

    def walk(p, t, path):
        if isinstance(p, dict):
            if not isinstance(t, dict) or set(p) != set(t):
                raise ValueError(f"weight tree differs from the plan at "
                                 f"{path}")
            for k in p:
                walk(p[k], t[k], path + (k,))
        elif (tuple(t.shape) != tuple(p.shape)
              or t.dtype != torch_dtype(p.dtype)):
            raise ValueError(f"{'/'.join(path)}: {tuple(t.shape)} "
                             f"{t.dtype}, the plan {p.shape} {p.dtype}")
    walk(plan, tree, ())


# ---------------------------------------------------------------- records
@dataclass
class ReqRec:
    src: traffic.BenchRequest
    req: object = None                 # the port's Request
    refused: bool = False
    late: float = 0.0                  # submitted this long after due
    emits: List[float] = field(default_factory=list)  # one time a token
    finished: Optional[float] = None


@dataclass
class StepRec:
    start: float
    end: float
    compute_s: float
    prefix_hit: int
    positions: np.ndarray
    row_of: list
    block_tables: np.ndarray
    lanes: List[int]                   # request ids, in logit-row order
    admitted: List[int]                # requests whose first chunk this is
    profiled: bool = False


class Recorder:
    """Wraps the runtime instance's ``sched.plan``, ``_run_mixed`` and
    ``_mixed_impl`` (no edit of the port): which request each logit row
    belongs to, the step's packed host arrays, and a copy of each logit
    row's ``cols`` columns on the device for the check."""

    def __init__(self, runtime, cols, capacity: int, labels: bool):
        import torch
        self.cols = cols
        self.buf = torch.empty((capacity, cols.numel()), dtype=torch.float32,
                               device=cols.device)
        self.meta: List[tuple] = []       # (request id, position) a row
        self.lanes: List[int] = []
        self.admitted: List[int] = []
        self.hits: Dict[int, int] = {}    # prefix tokens read at admission
        self.packed = None
        plan, run, impl = (runtime.sched.plan, runtime._run_mixed,
                           runtime._mixed_impl)
        label = (torch.profiler.record_function if labels
                 else lambda _: contextlib.nullcontext())

        def plan_w():
            with label("sched.plan"):
                p = plan()
            self.lanes = ([s.req.req_id for s in p.decodes]
                          + [s.req.req_id for s, _, _ in p.prefills])
            self.admitted = [s.req.req_id for s, _, _ in p.prefills
                             if s.chunks_done == 0]
            for s, _, _ in p.prefills:
                if s.chunks_done == 0 and s.prefix_hit:
                    self.hits[s.req.req_id] = s.prefix_hit
            if any(s.draft for s in p.decodes):
                raise RuntimeError("speculative rows: one logit row a lane "
                                   "no longer holds")
            return p

        def run_w(tokens, positions, n_rows, bts, last_rows, row_of):
            self.packed = (positions, row_of, bts)
            with label("runtime.run_mixed"):
                return run(tokens, positions, n_rows, bts, last_rows, row_of)

        def impl_w(*args):
            with label("model.forward"):
                logits = impl(*args)
            positions, row_of, _ = self.packed
            n = len(self.lanes)
            k = len(self.meta)
            if k + n <= self.buf.shape[0]:
                self.buf[k:k + n] = logits[:n].index_select(1, self.cols)
                self.meta.extend(
                    (rid, int(positions[r0 + c - 1]))
                    for rid, (r0, c) in zip(self.lanes, row_of))
            return logits

        runtime.sched.plan = plan_w
        runtime._run_mixed = run_w
        runtime._mixed_impl = impl_w


# ------------------------------------------------------------------- loop
@dataclass
class Window:
    w0: float = 0.0
    w1: float = 0.0
    t_origin: float = 0.0              # perf_counter of the schedule's 0
    steps: List[StepRec] = field(default_factory=list)
    reqs: Dict[int, ReqRec] = field(default_factory=dict)
    profiled_from: Optional[int] = None    # index of the first traced step
    prof: object = None


def _submit(engine, rec: ReqRec, slo_ms, arrival: float) -> None:
    from repro_torch.serving.request import Request
    s = rec.src
    rec.req = Request(req_id=s.rid, tenant="bench",
                      prompt_len=int(s.tokens.size), max_new_tokens=s.max_new,
                      arrival=arrival, slo_ms=slo_ms,
                      prompt_tokens=s.tokens)
    rec.refused = not engine.submit(rec.req)


def _step(engine, recorder: Recorder, win: Window, src, now,
          warm: bool = False) -> None:
    """One engine step, stamped by the host clock, and its tokens.  In the
    warm phase a closed loop's next requests are due at the schedule's
    origin."""
    t0 = now()
    rep = engine.step()
    t1 = now()
    engine.finalize_step(rep, t1, t0)
    if rep.kind == "idle":
        return
    positions, row_of, bts = recorder.packed
    win.steps.append(StepRec(t0, t1, rep.compute_s, rep.prefix_hit_tokens,
                             positions, row_of, bts, recorder.lanes,
                             recorder.admitted))
    for req in {id(r): r for r in rep.decoded + rep.prefilled
                + rep.completed}.values():
        r = win.reqs[req.req_id]
        while len(r.emits) < req.generated:
            r.emits.append(t1)
    for req in rep.completed:
        r = win.reqs[req.req_id]
        r.finished = t1
        src.done(r.src, 0.0 if warm else t1)


def drive(engine, src, mix: Dict, seconds: float, recorder: Recorder,
          trace_steps: int = 0, warm_timeout_s: float = 240.0) -> Window:
    """Serve the warm requests until each has its first token, then run
    the schedule: ``preamble_s`` seconds, the window of ``seconds``, and
    with ``trace_steps`` that many steps under the profiler after it.
    Times are seconds after the schedule's origin."""
    win = Window()
    slo = mix.get("slo", {}).get("ttft_ms")
    clock0 = time.perf_counter()
    for s in src.warm():
        win.reqs[s.rid] = ReqRec(s)
        _submit(engine, win.reqs[s.rid], slo, -1.0)
    warm = [r for r in win.reqs.values() if not r.refused]

    def since0():
        return time.perf_counter() - clock0
    while any(not r.emits for r in warm):
        if since0() > warm_timeout_s:
            raise RuntimeError("the warm requests did not all start within "
                               f"{warm_timeout_s} s")
        _step(engine, recorder, win, src, since0, warm=True)
    win.t_origin = time.perf_counter()
    shift = win.t_origin - clock0

    def now():
        return time.perf_counter() - win.t_origin
    for r in win.reqs.values():             # warm requests predate time 0
        r.emits = [t - shift for t in r.emits]
        if r.finished is not None:
            r.finished -= shift
    win.w0 = float(mix["preamble_s"])
    win.w1 = win.w0 + seconds
    win.steps.clear()
    while True:
        t = now()
        for s in src.pop_due(t):
            win.reqs[s.rid] = ReqRec(s, late=t - s.due)
            _submit(engine, win.reqs[s.rid], slo, s.due)
        if t >= win.w1:
            if trace_steps and win.profiled_from is None:
                win.profiled_from = len(win.steps)
                win.prof = _start_profiler()
            if (win.profiled_from is None
                    or len(win.steps) - win.profiled_from >= trace_steps):
                break
        if engine.has_work():
            _step(engine, recorder, win, src, now)
            if win.profiled_from is not None and win.steps:
                win.steps[-1].profiled = len(win.steps) > win.profiled_from
        else:
            nxt = src.next_due()
            limit = win.w1 if win.profiled_from is None else t + 0.05
            wake = limit if nxt is None else min(nxt, limit)
            time.sleep(max(0.0, wake - now()))
    if win.prof is not None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        win.prof.stop()
    return win


def _start_profiler():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    if torch.cuda.is_available():
        # the device records of the launches made just after the start can
        # be lost (with torch 2.11.0+cu128, a trace's first few to first
        # 65): spend them on launches before the first traced step, which
        # owns none of them
        x = torch.zeros(1, device="cuda")
        for _ in range(64):
            x.add_(1)
        torch.cuda.synchronize()
    return prof


def warm_profiler() -> None:
    """The profiler's first start sets up its tracer; pay that in set-up."""
    _start_profiler().stop()


# ------------------------------------------------------------------ trace
LABELS = ("sched.plan", "runtime.run_mixed", "model.forward")
# host runtime calls that put work on the device: each device record
# carries the correlation id of the call that launched it (``FunctionEvent``
# ``id`` on both sides); a graph launch's kernels all carry its one id
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
            "cuLaunchKernel", "cuLaunchCooperativeKernel",
            "cudaGraphLaunch", "cuGraphLaunch",
            "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")


def read_trace(prof, steps: List[StepRec]) -> Dict:
    return read_events(prof.events(), steps)


def read_events(events, steps: List[StepRec]) -> Dict:
    """The traced steps' device records, each paired with the host launch
    that made it, and read over the **whole** steps alone.

    A traced step owns the host time from its ``sched.plan`` to the next
    step's (the last to the trace's end), and every launch made in it.  It
    is whole when its ``model.forward`` made at least one launch, every
    launch it made has its device record, and no device record without a
    launch falls among its device work.  A trace that lost records then
    reads the steps it holds whole, never their work over part of their
    time.

    Returns the whole steps' kernels (name, start, end, in microseconds),
    busy seconds (their union) and the host seconds they own (the whole
    trace's, where no step is whole), device seconds by kernel family, the
    idle gaps within whole steps by the innermost label the host was in
    when each began, the census, and ``steps`` with ``step_busy_s`` (each
    whole step's forward kernels, their union): empty unless at least
    half the traced steps are whole, so the readers of the device trace
    find nothing to read."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    records, launches, spans = [], [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not e.is_user_annotation:   # the labels' ranges on the device
                records.append((e.name, s, t, e.id))
        elif e.name in LABELS:
            spans.append((s, t, e.name))
        elif e.name.startswith(LAUNCHES):
            launches.append((s, e.id, e.name.startswith(GRAPH_LAUNCHES)))
    spans.sort()
    forwards = [(s, t) for s, t, name in spans if name == "model.forward"]
    plans = [s for s, _, name in spans if name == "sched.plan"]
    by_id: Dict[int, list] = {}
    for r in records:
        by_id.setdefault(r[3], []).append(r)
    launched = {cid for _, cid, _ in launches}
    unpaired = [r for r in records if r[3] not in launched]
    n = len(steps)
    own = [[] for _ in range(n)]         # records of the step's launches
    fwd = [[] for _ in range(n)]         # ... of its forward's launches
    whole = [False] * n
    starts: List[float] = []
    if n and len(forwards) == n:
        prev_end = float("-inf")
        for f0, f1 in forwards:
            k = bisect.bisect_right(plans, f0) - 1
            starts.append(plans[k] if k >= 0 and plans[k] > prev_end
                          else f0)
            prev_end = f1
        whole = [True] * n
        launched_fwd = [False] * n
        for t, cid, _ in launches:
            i = bisect.bisect_right(starts, t) - 1
            if i < 0:                    # before the first traced step
                continue
            inside = forwards[i][0] <= t < forwards[i][1]
            launched_fwd[i] |= inside
            got = by_id.get(cid)
            if not got:
                whole[i] = False
                continue
            own[i].extend(got)
            if inside:
                fwd[i].extend(got)
        # a record with no launch marks the step whose device work it is in
        firsts = sorted((min(r[1] for r in own[i]), i)
                        for i in range(n) if own[i])
        for r in unpaired:
            k = bisect.bisect_right(firsts, (r[1], n)) - 1
            if k >= 0:
                whole[firsts[k][1]] = False
        whole = [w and f for w, f in zip(whole, launched_fwd)]
    ok = [i for i in range(n) if whole[i]]
    kept = [r for i in ok for r in own[i]]
    if ok:
        busy = yardstick.busy_union([(s, t) for _, s, t, _ in kept]) / 1e6
        window = sum((steps[i + 1].start if i + 1 < n else steps[i].end)
                     - steps[i].start for i in ok)
    else:
        busy = yardstick.busy_union([(s, t) for _, s, t, _ in records]) / 1e6
        window = steps[-1].end - steps[0].start if steps else 0.0
    fam: Dict[str, float] = {}
    for name, s, t, _ in kept:
        f = yardstick.family(name)
        fam[f] = fam.get(f, 0.0) + (t - s) / 1e6
    gaps: Dict[str, float] = {}
    for g0, g1 in (yardstick.idle_gaps([(s, t) for _, s, t, _ in records])
                   if ok else ()):
        i0 = bisect.bisect_right(starts, g0) - 1
        i1 = bisect.bisect_right(starts, g1) - 1
        if i0 < 0 or not all(whole[i0:i1 + 1]):
            continue
        inside = [sp for sp in spans if sp[0] <= g0 < sp[1]]
        name = (min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside
                else "engine.step or loop")
        gaps[name] = gaps.get(name, 0.0) + (g1 - g0) / 1e6
    enough = bool(n) and 2 * len(ok) >= n
    read = ok if enough else []
    census = {"traced_steps": n, "host_forwards": len(forwards),
              "whole_steps": len(ok), "host_launches": len(launches),
              "device_records": len(records),
              "lost_records": sum(1 for _, cid, _ in launches
                                  if cid not in by_id),
              "unpaired_records": len(unpaired),
              "graph_launches": sum(1 for *_, g in launches if g)}
    return {"kernels": [(name, s, t) for name, s, t, _ in kept],
            "busy_s": busy, "window_s": window, "families": fam,
            "gaps": gaps, "census": census,
            "steps": [steps[i] for i in read],
            "step_busy_s": [yardstick.busy_union(
                [(s, t) for _, s, t, _ in fwd[i]]) / 1e6 for i in read]}


# ---------------------------------------------------------------- metrics
@dataclass
class Context:
    """What a metric reader reads."""
    kind: object                       # references/<kind>.py of the model
    model: Dict
    page_size: int
    w0: float
    w1: float
    steps: List[StepRec]               # the window's steps, none traced
    reqs: Dict[int, ReqRec]
    setup_s: float
    slo: Dict
    peak: Optional[Dict]               # the card's published peaks
    trace: Optional[Dict]

    def window_requests(self, until: Optional[float] = None):
        """Requests due in the window (up to ``until``), warm ones not."""
        end = self.w1 if until is None else until
        return [r for r in self.reqs.values()
                if not r.src.warm and self.w0 <= r.src.due < end]

    def ttfts(self):
        """Time to first token of every request due in the window, from
        when it was due; one with no first token by the close (or
        refused) enters at the close minus its due time."""
        return [min(r.emits[0] if r.emits and not r.refused else self.w1,
                    self.w1) - r.src.due for r in self.window_requests()]

    def gaps(self):
        """Every gap between consecutive tokens of a request whose second
        token came in the window."""
        out = []
        for r in self.reqs.values():
            for a, b in zip(r.emits, r.emits[1:]):
                if self.w0 <= b < self.w1:
                    out.append(b - a)
        return out


def load_metric(name: str):
    """The reader ``perfbench/metrics/<name>.py``; a name with a variant,
    ``<base>.<variant>``, falls back to ``<base>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{name.partition('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: List[Dict], ctx: Context) -> Dict:
    out = {}
    for m in entries:
        v = load_metric(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


# -------------------------------------------------------------------- run
def card_line() -> Dict:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        out = f"nvidia-smi failed: {err}"
    return {"nvidia_smi": out}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", port_cfg=None,
             rate: Optional[float] = None, control: bool = False,
             hook=None, log=print):
    """One run; returns the result line's object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, maybe
    ``breakdown``, and ``checks`` last) and every reading of the check.
    ``port_cfg`` (a reduced port configuration, the CPU tests), ``rate``
    (a sweep), ``control`` (the control's readings too) and ``hook``
    (called with the engine once it is built; the tests break the timed
    path through it) are not used by the benchmark's own runs."""
    point_caches()
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoCard("torch sees no CUDA card")
        if torch.cuda.device_count() < cell.chips:
            raise NoCard(f"{torch.cuda.device_count()} cards, the cell "
                         f"needs {cell.chips}")
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import model_plan
    from repro_torch.serving.engine import ServingEngine

    cfg_file, mix = cell.config, cell.mix
    m = model_spec(cfg_file)
    if port_cfg is None:
        port_cfg = get_config(cfg_file["arch"])
    kind = references.load(cfg_file["reference"])
    kind.check_port_config(port_cfg, m)
    dev = torch.device(device)
    if dev.type == "cuda":
        log(json.dumps({"card": card_line()}))
        if trace:
            warm_profiler()
    seed = int(seed) % (1 << 63)
    tree = weights.make(kind.layout(m), seed, dev)
    check_layout(model_plan(port_cfg), tree)
    eng = cfg_file["engine"]
    engine = ServingEngine(
        port_cfg, params=tree, max_slots=mix["engine"]["max_slots"],
        seq_cap=eng["seq_cap"], page_size=eng["page_size"],
        pool_pages=eng["pool_pages"],
        chunk_tokens=mix["engine"]["chunk_tokens"],
        prefix_cache=eng["prefix_cache"], seed=seed, backend="paged",
        device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed ^ 0x5EED)
    cols = torch.randperm(m["vocab_size"], generator=gen,
                          device=dev)[:check.COLUMNS]
    recorder = Recorder(engine.runtime, cols, check.CAPTURE_ROWS, trace)
    if hook is not None:
        hook(engine)
    horizon = mix["preamble_s"] + seconds + (5.0 if trace else 0.0)
    src = traffic.source(mix, m["vocab_size"], seed, horizon, rate)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    win = drive(engine, src, mix, seconds, recorder,
                trace_steps=int(mix["trace_steps"]) if trace else 0)
    setup_s = win.t_origin + win.w0 - t_start
    if dev.type == "cuda":
        torch.cuda.synchronize()
        card = torch.cuda.get_device_name(0)
        mem = int(torch.cuda.max_memory_allocated(0))
    else:
        card, mem = "cpu", 0
    window_steps = [s for s in win.steps
                    if win.w0 <= s.start and s.end <= win.w1]
    traced = [s for s in win.steps if s.profiled]
    tr = read_trace(win.prof, traced) if win.prof is not None else None
    if tr is not None:
        log(json.dumps({"trace_census": tr["census"]}))
    ctx = Context(kind=kind, model=m, page_size=eng["page_size"],
                  w0=win.w0, w1=win.w1, steps=window_steps,
                  reqs=win.reqs, setup_s=setup_s, slo=mix.get("slo", {}),
                  peak=yardstick.PEAKS.get(card), trace=tr)
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, ctx)
    due = ctx.window_requests()
    late = [r.late * 1e3 for r in due]
    walls = sorted((s.end - s.start) * 1e3 for s in window_steps)
    ttfts = [1e3 * t for t in ctx.ttfts()]
    itls = [1e3 * g for g in ctx.gaps()]
    alloc = (torch.cuda.memory_stats(dev) if dev.type == "cuda" else {})
    log(json.dumps({"schedule": {
        "step_ms_p50": _q(walls, 50), "step_ms_p99": _q(walls, 99),
        "step_ms_max": walls[-1] if walls else None,
        "alloc_retries": alloc.get("num_alloc_retries"),
        "gc_collections": [g["collections"] for g in gc.get_stats()],
        "requests_due_in_window": len(due),
        "ttft_ms": {q: _q(ttfts, q) for q in (50, 90, 95, 99)},
        "itl_ms": {q: _q(itls, q) for q in (50, 90, 95, 99)},
        "lateness_ms_p50": _q(late, 50), "lateness_ms_p99": _q(late, 99),
        "lateness_ms_max": max(late) if late else None,
        "steps_in_window": len(window_steps),
        "pages_read_in_window": pages_read(window_steps, eng["page_size"]),
        "pool_pages": eng["pool_pages"],
        "tokens_in_window": sum(
            1 for r in win.reqs.values() for t in r.emits
            if win.w0 <= t < win.w1),
        "finished": sum(1 for r in win.reqs.values()
                        if r.finished is not None),
        "waiting_at_close": len(engine.runtime.queue),
        "running_at_close": len(engine.runtime.running())}}))

    # the check, once the program's state is freed, on the weights drawn
    # again from the seed: nothing the program held reaches the reference
    captured = recorder.buf[:len(recorder.meta)].cpu()
    meta, hits = list(recorder.meta), dict(recorder.hits)
    del engine, recorder, src, tree
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = check.run(win.reqs, hits, captured, meta, cols.cpu(),
                       weights.make(kind.layout(m), seed, dev), m, kind,
                       seed, dev, control=control)
    found = forbidden_loaded()
    if found:
        raise RuntimeError(f"modules that no run may load: {found}")
    limits = cell.limits
    correct = passes(checks, limits)
    if control:
        # the control in the program's place, held to the same limits
        checks["control_correct"] = passes(
            {k: checks["control_" + k] for k in limits}, limits)
    attempted = len(due)
    failed = sum(1 for r in due if r.refused)
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": card, "count": cell.chips,
                   "memory_peak_bytes": mem}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        result["breakdown"] = {
            "device_ops": sorted(tr["families"].items(),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(tr["gaps"].items(),
                                key=lambda kv: -kv[1])[:10]}
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in limits}
    return result, checks


def pages_read(steps: List[StepRec], page_size: int) -> int:
    """Distinct K/V pages the steps' lanes read, each counted once."""
    pages = [st.block_tables[lane, :top // page_size + 1]
             for st in steps
             for lane, (_, _, top) in enumerate(
                 yardstick.lane_rows(st.positions, st.row_of))]
    return int(np.unique(np.concatenate(pages)).size) if pages else 0


def passes(readings: Dict, limits: Dict) -> bool:
    """Whether every reading is a number within its limit."""
    return bool(all(np.isfinite(readings[k]) and readings[k] <= limits[k]
                    for k in limits))


def _q(xs, q):
    from perfbench.stats import percentile
    return percentile(xs, q) if xs else None
