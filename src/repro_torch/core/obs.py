"""Observability substrate: trace events, engine step spans + Chrome
export.

This module is the layer-neutral half of the tracing subsystem (the
serving-specific per-request flight recorder lives in
``serving/trace.py``).  Core modules — the controller, the admission
controller, the cluster simulator — accept an optional :class:`Tracer`
and emit *instant* or *span* events onto a shared timeline; the serving
layer subclasses it to accrue per-request span timelines with a
conservation invariant.

Design contract (the reason this file exists at all):

* **A tracer reads only the clock it is given.**  Event timestamps are
  the caller's own stamps.  A tracer built with no ``clock`` (the
  virtual-clock harness) reads no clock at all and records no step
  spans, so a trace recorded under the virtual clock replays
  bit-identically.  A tracer built with ``clock`` (a callable returning
  seconds) lets the serving engine stamp its step spans
  (:class:`StepSpans`) with that clock and nothing else; handing it the
  clock the caller stamps its own steps with keeps one timeline.
* **Disabled tracing is free.**  Every call site is guarded
  (``if tracer is not None``): with no tracer attached, zero objects
  are allocated, no clock is read and zero branches beyond the guard
  run.
* **Export is Chrome ``trace_event`` JSON** (the format Perfetto /
  ``chrome://tracing`` load directly): tracks map to pids, lanes to
  tids, seconds to microseconds.
"""
from __future__ import annotations

import json
from array import array
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional


@dataclass
class TraceEvent:
    """One event on the shared timeline.

    ``ph`` follows the trace_event phase vocabulary: ``"X"`` is a
    complete span (``ts`` + ``dur``), ``"i"`` an instant.  ``track``
    groups events into a Perfetto process row (a tenant, or the
    ``"controller"`` track all actuator/controller events share);
    ``lane`` is the thread row within it (a request id, an actor name).
    """
    name: str
    ph: str                       # "X" complete span | "i" instant
    ts: float                     # seconds on the caller's clock
    dur: float = 0.0              # seconds ("X" only)
    track: str = ""
    lane: str = ""
    args: Dict[str, Any] = field(default_factory=dict)


class StepSpans:
    """The spans of one engine step on a tracer's clock.

    The root span, ``engine.step``, runs from ``t0`` (stamped when the
    record is opened) to ``t1`` (stamped by :meth:`close`); the spans
    inside it are kept as parallel ``names``, ``starts`` and ``ends``
    (float arrays, so a step's few hundred spans allocate no object
    each) in the order they closed.  ``args`` holds the step's counters.

    :meth:`phase` closes the span running from the cursor (the end of
    the previous span, or ``t0``) to now, so consecutive phases tile
    their parent; :meth:`restart` moves the cursor to now, to begin a
    run of nested phases; :meth:`span` closes a span from an explicit
    start."""

    __slots__ = ("clock", "t0", "t1", "cursor", "names", "starts", "ends",
                 "args")

    def __init__(self, clock: Callable[[], float]) -> None:
        self.clock = clock
        self.t0 = self.cursor = clock()
        self.t1: Optional[float] = None
        self.names: List[str] = []
        self.starts = array("d")
        self.ends = array("d")
        self.args: Dict[str, Any] = {}

    def span(self, name: str, t0: float) -> float:
        """Close span ``name`` from ``t0`` to now; returns now, which
        becomes the cursor."""
        t1 = self.clock()
        self.names.append(name)
        self.starts.append(t0)
        self.ends.append(t1)
        self.cursor = t1
        return t1

    def phase(self, name: str) -> float:
        """Close span ``name`` from the cursor to now; returns now."""
        return self.span(name, self.cursor)

    def restart(self) -> None:
        """Move the cursor to now (the start of nested phases)."""
        self.cursor = self.clock()

    def close(self) -> None:
        self.t1 = self.clock()

    def spans(self) -> List[tuple]:
        """(name, start, end) of the root and of every span inside it."""
        return ([("engine.step", self.t0, self.t1)]
                + list(zip(self.names, self.starts, self.ends)))

    def total(self, name: str) -> float:
        """Seconds of the spans named ``name`` in this step."""
        return sum(e - s for n, s, e in zip(self.names, self.starts,
                                              self.ends) if n == name)


class Tracer:
    """Event collector every instrumented layer can write to.

    The base class just accumulates :class:`TraceEvent` objects —
    enough for the controller/actuator/admission call sites, the
    actuator lint test, and the e5 pause-correlation analysis.  The
    serving flight recorder (``serving/trace.py``) extends it with
    per-request timelines and retention policy.

    ``actions`` additionally indexes every :meth:`action` event (the
    controller-plane subset) so request timelines can be checked for
    overlap with reconfigure pause windows without scanning the full
    event list.

    ``clock`` (a callable returning seconds) turns on the serving
    engine's step spans: each step opens a :class:`StepSpans` record
    (:meth:`open_step`), kept in ``steps``, a ring of the last
    ``max_steps`` records, so a clocked tracer left on a live server
    stays bounded.  With no clock the tracer reads none and ``steps``
    stays empty.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 max_steps: int = 1024) -> None:
        self.events: List[TraceEvent] = []
        self.actions: List[TraceEvent] = []
        self.clock = clock
        self.steps: Deque[StepSpans] = deque(maxlen=max_steps)

    def open_step(self) -> StepSpans:
        """Begin one engine step's span record (a tracer with a clock)."""
        rec = StepSpans(self.clock)
        self.steps.append(rec)
        return rec

    # ------------------------------------------------------------ emission
    def instant(self, name: str, t: float, track: str = "",
                lane: str = "", **args: Any) -> TraceEvent:
        ev = TraceEvent(name, "i", t, 0.0, track, lane, args)
        self.events.append(ev)
        return ev

    def span(self, name: str, t0: float, t1: float, track: str = "",
             lane: str = "", **args: Any) -> TraceEvent:
        ev = TraceEvent(name, "X", t0, max(0.0, t1 - t0), track, lane, args)
        self.events.append(ev)
        return ev

    def action(self, name: str, t: float, tenant: str, dur: float = 0.0,
               **args: Any) -> TraceEvent:
        """A controller/actuator action.  ``dur > 0`` records the pause
        window it imposes (a MIG reconfigure's re-lower, a move) as a
        span on the shared ``controller`` track; instantaneous knob
        turns (io throttle, MPS quota) land as instants."""
        args = {"tenant": tenant, **args}
        if dur > 0:
            ev = self.span(name, t, t + dur, track="controller",
                           lane=tenant, **args)
        else:
            ev = self.instant(name, t, track="controller", lane=tenant,
                              **args)
        self.actions.append(ev)
        return ev

    # ------------------------------------------------------------- queries
    def actions_overlapping(self, t0: float, t1: float,
                            tenant: Optional[str] = None
                            ) -> List[TraceEvent]:
        """Controller actions whose [ts, ts+dur] intersects [t0, t1].
        ``tenant`` restricts to actions aimed at that tenant; pass None
        for all (a reconfigure pauses one tenant but its fabric /
        arbiter side effects are cluster-wide, so callers often want
        every overlapping action)."""
        out = []
        for ev in self.actions:
            if tenant is not None and ev.args.get("tenant") != tenant:
                continue
            if ev.ts <= t1 and ev.ts + ev.dur >= t0:
                out.append(ev)
        return out


def chrome_trace(events: List[TraceEvent]) -> Dict[str, Any]:
    """Render events as a Chrome/Perfetto ``trace_event`` JSON object.

    Tracks become processes and lanes become threads (named via ``"M"``
    metadata records); virtual seconds become microseconds.  The result
    is ``json.dump``-able and loads directly in Perfetto's UI or
    ``chrome://tracing``.
    """
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    out: List[Dict[str, Any]] = []
    for ev in events:
        track = ev.track or "default"
        lane = ev.lane or "-"
        if track not in pids:
            pids[track] = len(pids) + 1
            out.append({"name": "process_name", "ph": "M",
                        "pid": pids[track], "tid": 0,
                        "args": {"name": track}})
        key = (track, lane)
        if key not in tids:
            tids[key] = len(tids) + 1
            out.append({"name": "thread_name", "ph": "M",
                        "pid": pids[track], "tid": tids[key],
                        "args": {"name": lane}})
        rec: Dict[str, Any] = {
            "name": ev.name, "ph": ev.ph, "ts": ev.ts * 1e6,
            "pid": pids[track], "tid": tids[key], "cat": track,
            "args": ev.args}
        if ev.ph == "X":
            rec["dur"] = ev.dur * 1e6
        else:
            rec["s"] = "t"        # instant scope: thread
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def dump_chrome_trace(events: List[TraceEvent], path: str) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(events), f)
