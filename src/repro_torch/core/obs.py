"""Observability substrate: virtual-clock trace events + Chrome export.

This module is the layer-neutral half of the tracing subsystem (the
serving-specific per-request flight recorder lives in
``serving/trace.py``).  Core modules — the controller, the admission
controller, the cluster simulator — accept an optional :class:`Tracer`
and emit *instant* or *span* events onto a shared virtual-clock
timeline; the serving layer subclasses it to accrue per-request span
timelines with a conservation invariant.

Design contract (the reason this file exists at all):

* **Timestamps are always caller-provided virtual-clock seconds.**
  Nothing in here reads a wall clock — tracing must never perturb the
  harness's virtual time, and a trace recorded under the virtual clock
  replays bit-identically.
* **Disabled tracing is free.**  Every call site is guarded
  (``if tracer is not None``): with no tracer attached, zero objects
  are allocated and zero branches beyond the guard run.
* **Export is Chrome ``trace_event`` JSON** (the format Perfetto /
  ``chrome://tracing`` load directly): tracks map to pids, lanes to
  tids, seconds to microseconds.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


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
    ts: float                     # virtual-clock seconds
    dur: float = 0.0              # seconds ("X" only)
    track: str = ""
    lane: str = ""
    args: Dict[str, Any] = field(default_factory=dict)


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
    """

    def __init__(self) -> None:
        self.events: List[TraceEvent] = []
        self.actions: List[TraceEvent] = []

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
