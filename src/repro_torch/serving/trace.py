"""Per-request flight recorder: tail attribution across door ->
scheduler -> runtime -> controller.

Every request accrues a *span timeline* — contiguous named segments that
tile ``[arrival, terminal]`` exactly:

    door_queued -> (admitted) -> sched_queued -> prefill_chunk[i]
        -> (preempted/requeued) -> decode -> (spec_verify/rollback)
        -> verdict

and every controller/actuator action (MIG reconfigure with its pause
window, move, MPS/io throttle, arbiter grant) lands on the shared
``controller`` track of the same timeline
(``core/obs.py``).  The contract mirrors the gateway's verdict ledger:

    **conservation invariant** — a request's named segments sum to its
    door-measured latency (terminal - arrival) within float tolerance,

asserted for every finished request (``RequestTimeline.check``), so a
missing instrumentation hook is a test failure, not a silent
attribution gap.  Segment semantics:

* ``door_queued``   — front-door arrival to engine submit (the gap
  between the door- and engine-measured TTFT windows, exactly).
* ``sched_queued``  — admitted but not computing: waiting in the
  scheduler queue, or an in-flight chunked prefill waiting for step
  budget.
* ``prefill_chunk`` — a fused-step window that computed a chunk of this
  request's prompt (args carry the chunk index/offset/length).
* ``preempted``     — evicted by SLO-aware preemption: from the evict
  to the restart prefill completing (the full price of the preemption,
  including recompute wait).
* ``decode``        — decode cadence: every inter-token span, wait and
  compute folded together (matches ``TenantMetrics.itl`` samples).
  Speculative verify/rollback ride as instant events on the segment.
* ``handoff``       — replica death to re-dispatch on a survivor: the
  request's ONE timeline carries across engines (span links across
  replicas), from the crash instant to the redriven submit landing.

The :class:`FlightRecorder` keeps *summaries* (segment sums) for every
request but full timelines only for the slowest-K per tenant per time
window (tail exemplars) plus every request overlapping a controller
action — the ring-buffer discipline that makes always-on tracing
affordable.  Export: Chrome/Perfetto ``trace_event`` JSON
(:meth:`FlightRecorder.dump`) and a per-tenant latency-breakdown table
(:meth:`FlightRecorder.table`: ``p99 = X ms door + Y ms sched + ...``).

Tracing is opt-in and zero-cost when off: every producer call site is
guarded by ``if tracer is not None``.  The recorder reads only the clock
it is given.  Request segments take the harness's own stamps (those it
hands ``finalize_step``); built with no ``clock`` (the virtual-clock
harness) the recorder reads no clock, so attaching it never perturbs
the clock and traced and untraced runs are token- and timing-identical.
Built with ``clock`` (a wall-clock harness), the engine also stamps each
step's spans with it (``core/obs.py::StepSpans``): give it the clock the
harness stamps its steps with, so both lie on one timeline.
:meth:`FlightRecorder.first_token_splits` gives each request's segment
sums up to its first token (its queue wait: ``sched_queued``).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.obs import Tracer, TraceEvent, chrome_trace, dump_chrome_trace


@dataclass
class Segment:
    name: str
    t0: float
    t1: float
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


@dataclass
class Instant:
    name: str
    t: float
    args: Dict[str, Any] = field(default_factory=dict)


class RequestTimeline:
    """Contiguous segment timeline of one request.

    ``span`` closes the current wait (labelled by the request's state)
    up to the span's start, then appends the named segment; ``finish``
    closes the final wait at the terminal stamp.  Contiguity is by
    construction, which is exactly what makes the conservation check
    meaningful: it fails iff a producer stamped out of order or a
    terminal landed twice — the same class of bug the gateway ledger
    catches for verdicts.
    """

    def __init__(self, req_id: int, tenant: str, arrival: float,
                 wait: str = "door_queued"):
        self.req_id = req_id
        self.tenant = tenant
        self.arrival = arrival
        self.segments: List[Segment] = []
        self.instants: List[Instant] = []
        self.cursor = arrival
        self.wait = wait              # label for time not inside a span
        self.verdict: Optional[str] = None
        self.end: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.preemptions = 0

    # ------------------------------------------------------------ building
    def _fill(self, t: float) -> None:
        if t < self.cursor - 1e-12:
            raise AssertionError(
                f"req {self.req_id} ({self.tenant}): stamp {t} precedes "
                f"cursor {self.cursor} — producer out of order")
        if t > self.cursor:
            self.segments.append(Segment(self.wait, self.cursor, t))
            self.cursor = t

    def span(self, name: str, t1: float, t0: Optional[float] = None,
             **args: Any) -> None:
        """Append a named segment ending at ``t1``.  ``t0`` is the span
        start (wait up to it is labelled with the current state); when
        None the span absorbs the wait from the cursor (decode cadence
        semantics)."""
        if self.end is not None:
            raise AssertionError(
                f"req {self.req_id}: span {name!r} after terminal "
                f"{self.verdict!r}")
        if t0 is not None and t0 > self.cursor:
            self._fill(t0)
        start = self.cursor
        if t1 < start - 1e-12:
            raise AssertionError(
                f"req {self.req_id}: span {name!r} ends at {t1} before "
                f"cursor {start}")
        self.segments.append(Segment(name, start, max(t1, start), args))
        self.cursor = max(t1, start)

    def event(self, name: str, t: float, **args: Any) -> None:
        self.instants.append(Instant(name, t, args))

    def mark(self, t: float, wait: str) -> None:
        """Close the current wait at ``t`` and enter a new wait state."""
        self._fill(t)
        self.wait = wait

    def finish(self, t: float, verdict: str) -> None:
        if self.end is not None:
            raise AssertionError(
                f"req {self.req_id} ({self.tenant}) finished twice: "
                f"{self.verdict!r} then {verdict!r}")
        self._fill(t)
        self.end = t
        self.verdict = verdict
        self.instants.append(Instant("verdict", t, {"verdict": verdict}))

    # ------------------------------------------------------------- queries
    @property
    def e2e(self) -> float:
        assert self.end is not None
        return self.end - self.arrival

    def seg_sums(self, until: Optional[float] = None) -> Dict[str, float]:
        """Per-segment-name duration totals, optionally clipped at
        ``until`` (pass the first-token stamp for the TTFT view)."""
        out: Dict[str, float] = {}
        for s in self.segments:
            t1 = s.t1 if until is None else min(s.t1, until)
            d = t1 - s.t0
            if d > 0:
                out[s.name] = out.get(s.name, 0.0) + d
        return out

    def check(self, tol: float = 1e-6) -> None:
        """Conservation: segments tile [arrival, end] and sum to the
        measured latency.  Mirrors ``Gateway.check()``."""
        assert self.end is not None, f"req {self.req_id} has no terminal"
        prev = self.arrival
        for s in self.segments:
            assert abs(s.t0 - prev) <= tol, (
                f"req {self.req_id} ({self.tenant}): gap before "
                f"{s.name!r} at {s.t0} (previous segment ended {prev})")
            assert s.t1 >= s.t0 - tol
            prev = s.t1
        assert abs(prev - self.end) <= tol, (
            f"req {self.req_id}: last segment ends {prev} != terminal "
            f"{self.end}")
        total = sum(s.dur for s in self.segments)
        assert abs(total - self.e2e) <= tol, (
            f"req {self.req_id} ({self.tenant}): segments sum to "
            f"{total} but measured latency is {self.e2e} "
            f"(conservation violated)")


@dataclass
class RequestSummary:
    """The always-kept per-request record (full timelines are retained
    only for tail exemplars / action overlaps)."""
    req_id: int
    tenant: str
    arrival: float
    end: float
    e2e: float
    verdict: str
    preemptions: int
    segs: Dict[str, float]
    ttft_segs: Dict[str, float]
    ttft: Optional[float]


class FlightRecorder(Tracer):
    """Ring-buffered per-request tracing across the whole serving stack.

    ``keep_slowest`` full timelines are retained per tenant per
    ``window_s`` bucket of terminal time (tail exemplars), plus every
    request whose lifetime overlapped a controller action; summaries
    (bounded deques) are kept for all requests.  Request stamps are the
    harness's values; ``clock`` is read only for the engine's step spans
    (``core/obs.py::Tracer``).
    """

    def __init__(self, keep_slowest: int = 8, window_s: float = 10.0,
                 max_summaries: int = 8192, max_action_exemplars: int = 512,
                 clock=None, max_steps: int = 1024):
        super().__init__(clock, max_steps)
        self.keep_slowest = keep_slowest
        self.window_s = window_s
        self._live: Dict[Tuple[str, int], RequestTimeline] = {}
        self.summaries: Dict[str, deque] = {}
        self._max_summaries = max_summaries
        # recently-finished keys: a producer stamping a request after its
        # terminal must not silently begin a SECOND timeline (the
        # double-terminal bug the gateway ledger catches for verdicts).
        # Bounded like the summaries so always-on tracing stays O(window).
        self._done: set = set()
        self._done_order: deque = deque()
        # (tenant, window index) -> [(e2e, timeline)] slowest-K heap-ish
        self._tail: Dict[Tuple[str, int], List[Tuple[float,
                                                     RequestTimeline]]] = {}
        self.action_exemplars: deque = deque(maxlen=max_action_exemplars)
        self.finished = 0

    # -------------------------------------------------------- lifecycle
    def _key(self, req) -> Tuple[str, int]:
        return (req.tenant, req.req_id)

    def _timeline(self, req, wait: str = "sched_queued") -> RequestTimeline:
        """Fetch-or-begin.  Requests fronted by a gateway begin in
        ``on_offer``; engine-only harnesses (no door) begin lazily at
        first contact, with the whole pre-compute wait labelled
        ``sched_queued``."""
        key = self._key(req)
        tl = self._live.get(key)
        if tl is None:
            if key in self._done:
                raise AssertionError(
                    f"req {req.req_id} ({req.tenant}): event after "
                    f"terminal — request already finished")
            tl = RequestTimeline(req.req_id, req.tenant, req.arrival,
                                 wait=wait)
            self._live[key] = tl
        return tl

    def on_offer(self, req, now: float, verdict) -> None:
        """Gateway front door: begin the timeline at front-door arrival;
        a terminal verdict at the door (SHED/REJECTED) finishes it on
        the spot — rejected requests conserve too."""
        tl = self._timeline(req, wait="door_queued")
        name = getattr(verdict, "value", str(verdict))
        if name != "accepted":
            self._finish(tl, max(now, tl.cursor), name)
        else:
            tl.event("offered", now)

    def on_admit(self, req, now: float, engine: int = 0) -> None:
        """Door queue -> engine submit landed: the ``door_queued``
        segment closes here, which is exactly ``submitted - arrival`` —
        the gap between the door- and engine-measured TTFT windows."""
        tl = self._timeline(req, wait="door_queued")
        # handoff admits clamp to the cursor: a redriven request's last
        # step on the dead replica may have ENDED past the global clock
        # (engines run in parallel virtual time), leaving the handoff
        # segment zero-length.  Everything else keeps strict ordering.
        t = max(now, tl.cursor) if tl.wait == "handoff" else now
        tl.mark(t, "sched_queued")
        tl.event("admitted", now, engine=engine)

    def on_redrive(self, req, now: float, from_engine: int = -1) -> None:
        """Replica death: the request's timeline survives the engine it
        was running on.  The current wait closes at the crash instant
        and an explicit ``handoff`` segment opens; the re-dispatch's
        ``on_admit`` closes it (span links across replicas — the ONE
        timeline carries across engines, it never restarts)."""
        tl = self._timeline(req)
        t = max(now, tl.cursor)
        tl.mark(t, "handoff")
        tl.event("handoff", t, from_engine=from_engine)

    def on_fault(self, now: float, kind: str, tenant: str = "",
                 **args) -> None:
        """Fault deliveries and recovery actions land as instants on the
        shared controller track, so request timelines can be correlated
        with the chaos schedule the same way they are with controller
        decisions."""
        self.instant(f"fault:{kind}", now, track="controller",
                     lane="faults", tenant=tenant, **args)

    def on_terminal(self, req, now: float, verdict: str,
                    reason: str = "") -> None:
        """A terminal verdict away from the engine (EXPIRED in the door
        queue, REJECTED after a failed submit)."""
        key = self._key(req)
        tl = self._live.get(key)
        if tl is None:
            tl = self._timeline(req, wait="door_queued")
        if reason:
            tl.event("reject", now, reason=reason)
        self._finish(tl, max(now, tl.cursor), verdict)

    def on_preempt(self, req, now: float, beneficiary: int = -1,
                   engine: str = "") -> None:
        """One preemption: close the victim's current phase and open the
        ``preempted`` wait.  Called from :meth:`on_step` for plan-time
        SLO preemptions and directly by the harness when the stuck-lane
        watchdog requeues a hung lane between steps."""
        tl = self._timeline(req)
        t = max(now, tl.cursor)
        tl.mark(t, "preempted")
        tl.preemptions += 1
        tl.event("preempted", t, beneficiary=beneficiary, engine=engine)

    # ------------------------------------------------------------- steps
    def on_step(self, report, start: Optional[float], end: float,
                engine: str = "") -> None:
        """Fold one finalized engine step into every participating
        request's timeline.  ``start``/``end`` are the harness's step
        window stamps (``end`` is the same value ``finalize_step``
        stamps into metrics, so segments and metrics windows agree
        sample-for-sample); ``start=None`` degrades gracefully — spans
        absorb from each request's cursor."""
        # preemptions happen at plan time (step start): the victim's
        # current phase closes and the preempted wait opens
        bene = {v: b for v, b in getattr(report, "preempt_pairs", [])}
        for req in report.preempted:
            self.on_preempt(req, start if start is not None else end,
                            beneficiary=bene.get(req.req_id, -1),
                            engine=engine)
        for req, tok_start, clen, idx in getattr(report, "chunks", []):
            tl = self._timeline(req)
            tl.span("prefill_chunk", end, t0=start, i=idx,
                    token_start=tok_start, tokens=clen,
                    restart=tl.preemptions > 0)
        for req in report.prefilled:
            tl = self._timeline(req)
            tl.mark(end, "decode")
            tl.first_token_t = end
            tl.event("first_token", end)
        spec = {id(r): (d, a) for r, d, a in getattr(report, "spec", [])}
        seen: Dict[int, int] = {}
        for req in report.decoded:
            seen[id(req)] = seen.get(id(req), 0) + 1
        done = set()
        for req in report.decoded:
            if id(req) in done:
                continue
            done.add(id(req))
            tl = self._timeline(req)
            if tl.first_token_t is None:
                # restart decode after preemption: TTFT kept its
                # original stamp, so the first regenerated emission
                # closes the preempted wait instead of re-marking decode
                tl.mark(max(tl.cursor, end), "decode")
                tl.first_token_t = tl.cursor
            tl.span("decode", end, tokens=seen[id(req)])
            if id(req) in spec:
                drafted, accepted = spec[id(req)]
                tl.event("spec_verify", end, drafted=drafted,
                         accepted=accepted)
                if accepted < drafted:
                    tl.event("spec_rollback", end,
                             rejected=drafted - accepted)
        for req in report.completed:
            tl = self._live.get(self._key(req))
            if tl is not None and tl.end is None:
                self._finish(tl, end, "completed")

    # ----------------------------------------------------- finish/retain
    def _finish(self, tl: RequestTimeline, t: float, verdict: str) -> None:
        tl.finish(t, verdict)
        tl.check()
        self.finished += 1
        ttft = (tl.first_token_t - tl.arrival
                if tl.first_token_t is not None else None)
        summ = RequestSummary(
            tl.req_id, tl.tenant, tl.arrival, tl.end, tl.e2e, verdict,
            tl.preemptions, tl.seg_sums(),
            tl.seg_sums(until=tl.first_token_t), ttft)
        dq = self.summaries.setdefault(
            tl.tenant, deque(maxlen=self._max_summaries))
        dq.append(summ)
        key = (tl.tenant, tl.req_id)
        self._live.pop(key, None)
        self._done.add(key)
        self._done_order.append(key)
        if len(self._done_order) > self._max_summaries:
            self._done.discard(self._done_order.popleft())
        # retention: requests overlapping a controller action keep the
        # full trace unconditionally (that correlation is the point)...
        if self.actions_overlapping(tl.arrival, tl.end):
            self.action_exemplars.append(tl)
            return
        # ...everything else competes for the slowest-K exemplar slots
        # of its (tenant, window) bucket
        key = (tl.tenant, int(tl.end // self.window_s))
        bucket = self._tail.setdefault(key, [])
        bucket.append((tl.e2e, tl))
        if len(bucket) > self.keep_slowest:
            bucket.sort(key=lambda p: -p[0])
            del bucket[self.keep_slowest:]

    def retained(self) -> List[RequestTimeline]:
        out = [tl for bucket in self._tail.values() for _, tl in bucket]
        out.extend(self.action_exemplars)
        return sorted(out, key=lambda tl: (tl.tenant, tl.arrival))

    def check(self) -> None:
        """Re-assert conservation on every retained timeline and verify
        every live request is still unterminated (ledger discipline)."""
        for tl in self.retained():
            tl.check()
        for tl in self._live.values():
            assert tl.end is None

    # ----------------------------------------------------------- analysis
    def breakdown(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Per-tenant latency attribution: ``p99 = X ms door + Y ms
        sched + Z ms preempted + ...``.  The tail composition averages
        the segment sums of the completed requests at or above the e2e
        p99 (the tail exemplar population); ``*_ttft`` attributes the
        first-token window the same way."""
        out: Dict[str, Any] = {}
        for tenant, dq in self.summaries.items():
            comp = [s for s in dq if s.verdict == "completed"]
            res: Dict[str, Any] = {
                "finished": len(dq), "completed": len(comp),
                "verdicts": {}, "preemptions": sum(s.preemptions
                                                   for s in dq)}
            for s in dq:
                res["verdicts"][s.verdict] = \
                    res["verdicts"].get(s.verdict, 0) + 1
            if comp:
                e2e = np.array([s.e2e for s in comp])
                p99 = float(np.quantile(e2e, 0.99))
                tail = [s for s in comp if s.e2e >= p99 - 1e-12]
                res.update(
                    e2e_p50_ms=float(np.quantile(e2e, 0.5)) * 1e3,
                    e2e_p99_ms=p99 * 1e3,
                    tail_n=len(tail),
                    tail_ms=_mean_segs(tail, "segs"),
                    mean_ms=_mean_segs(comp, "segs"))
                with_t = [s for s in comp if s.ttft is not None]
                if with_t:
                    ttft = np.array([s.ttft for s in with_t])
                    tp99 = float(np.quantile(ttft, 0.99))
                    ttail = [s for s in with_t if s.ttft >= tp99 - 1e-12]
                    res.update(ttft_p99_ms=tp99 * 1e3,
                               ttft_tail_ms=_mean_segs(ttail, "ttft_segs"))
            out[tenant] = res
        return out

    def first_token_splits(self) -> Dict[Tuple[str, int],
                                         Dict[str, float]]:
        """Each request with a first token, live or finished, keyed by
        (tenant, request id): its segment sums (seconds) up to that
        token.  ``sched_queued`` is the time from its arrival to its
        first token spent outside a step that computed one of its
        chunks."""
        out = {(s.tenant, s.req_id): s.ttft_segs
               for dq in self.summaries.values() for s in dq
               if s.ttft is not None}
        for key, tl in self._live.items():
            if tl.first_token_t is not None:
                out[key] = tl.seg_sums(until=tl.first_token_t)
        return out

    def table(self, now: Optional[float] = None) -> str:
        """Human-readable per-tenant breakdown table."""
        lines = []
        for tenant, res in sorted(self.breakdown(now).items()):
            if "e2e_p99_ms" not in res:
                lines.append(f"{tenant}: no completed requests "
                             f"({res['verdicts']})")
                continue
            parts = " + ".join(
                f"{ms:.1f} ms {name}" for name, ms in
                sorted(res["tail_ms"].items(), key=lambda kv: -kv[1]))
            lines.append(
                f"{tenant}: p99 = {res['e2e_p99_ms']:.1f} ms "
                f"[tail n={res['tail_n']}: {parts}] "
                f"(completed {res['completed']}/{res['finished']}, "
                f"preemptions {res['preemptions']})")
        return "\n".join(lines)

    # ------------------------------------------------------------- export
    def chrome_events(self) -> List[TraceEvent]:
        """Everything on one timeline: retained request timelines plus
        the shared controller/admission track."""
        evs: List[TraceEvent] = list(self.events)
        for tl in self.retained():
            lane = f"req {tl.req_id}"
            for s in tl.segments:
                evs.append(TraceEvent(s.name, "X", s.t0, s.dur,
                                      tl.tenant, lane, dict(s.args)))
            for i in tl.instants:
                evs.append(TraceEvent(i.name, "i", i.t, 0.0,
                                      tl.tenant, lane, dict(i.args)))
        return evs

    def chrome_trace(self) -> Dict[str, Any]:
        return chrome_trace(self.chrome_events())

    def dump(self, path: str) -> None:
        dump_chrome_trace(self.chrome_events(), path)


def _mean_segs(summaries, attr: str) -> Dict[str, float]:
    """Mean per-segment milliseconds over a summary population."""
    tot: Dict[str, float] = {}
    for s in summaries:
        for name, d in getattr(s, attr).items():
            tot[name] = tot.get(name, 0.0) + d
    n = max(1, len(summaries))
    return {name: d / n * 1e3 for name, d in sorted(tot.items())}
