"""Request-plane front door: bounded admission queues, explicit
backpressure, and a conservation ledger over request verdicts.

The serving loop used to hand arrivals straight to an engine and ignore
the submit result — a full pool silently *dropped* the request, so the
per-tenant accounting (`offered == completed + shed`) quietly stopped
balancing under pressure.  The gateway makes every request's fate
explicit.  Each request that passes the front door ends in **exactly
one** terminal verdict:

    OFFERED ──► REJECTED   (fast: queue full / rate limit / never fits)
        │
        ├────► SHED        (tenant paused by the controller at arrival)
        │
        └──► ACCEPTED ──► EXPIRED    (queued past its dispatch deadline)
                     ├──► COMPLETED  (final token delivered)
                     └──► (redriven) (replica died: re-enqueued, still
                                      ACCEPTED — not a verdict, and it
                                      keeps its full requeue credit)

and the per-tenant ledger maintains the conservation invariant

    offered == completed + rejected + shed + expired + in_flight

at every instant (``check()`` asserts it; the test-suite property test
drives random traffic + tenant churn against it).

Backpressure policy — the 429/503 split:

* **REJECT fast** (the 429 analogue) when waiting cannot help: the
  bounded door queue is full, the tenant's Kingman-derived rate limiter
  says the arrival rate alone would blow rho past the bound, or the
  engine reports a *structural* rejection (``never_fits`` /
  ``exceeds_seq_cap``).
* **QUEUE with a deadline** (the 503 analogue) when the shortage is
  transient: the request waits in the door queue for an engine slot,
  retried each dispatch round (requeue-once on a transient
  ``pool_exhausted``), and becomes EXPIRED if the deadline passes first.

Token streaming: the gateway mirrors every engine-side token emission
into a per-request :class:`TokenStream` with the *harness* timestamp, so
a client observing the stream measures exactly the inter-token gaps that
land in ``TenantMetrics.itl`` — including the preemption-restart
subtlety where the first regenerated token's gap is measured from the
original first emission (the stream rolls back, it does not forget).
"""
from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.serving.engine import ServingEngine, StepReport
from repro_torch.serving.request import Request


class Verdict(enum.Enum):
    ACCEPTED = "accepted"        # non-terminal: in the door queue / running
    REJECTED = "rejected"        # terminal, fast-fail (429 analogue)
    SHED = "shed"                # terminal, controller pause at arrival
    EXPIRED = "expired"          # terminal, queued past deadline (503)
    COMPLETED = "completed"      # terminal, final token delivered


TERMINAL = (Verdict.REJECTED, Verdict.SHED, Verdict.EXPIRED,
            Verdict.COMPLETED)


@dataclass(frozen=True)
class DoorConfig:
    """Per-tenant front-door policy."""
    max_queue: int = 1024        # bounded admission queue (429 past this)
    deadline_s: Optional[float] = None   # queue residency bound (503)
    max_attempts: int = 2        # submit tries per request (requeue once)
    rate_limiter: Optional[object] = None   # core.admission.RateLimiter


class TokenStream:
    """Client-visible token stream with per-token timestamps.

    ``gaps`` accumulates the inter-token latencies a streaming client
    would measure; by construction they match the samples the engine
    pushes into ``TenantMetrics.itl`` (same timestamps, same
    prev-emission bookkeeping, including across preemption restarts —
    pre-preemption gaps stay recorded, mirroring the metrics window).
    """

    def __init__(self, req: Request):
        self.req = req
        self.events: List[tuple] = []    # (token, time) in delivery order
        self.gaps: List[float] = []      # inter-token latencies observed
        self.first_time: Optional[float] = None
        self.sent = 0                    # tokens delivered this "attempt"
        self._last: Optional[float] = None

    def first(self, token: int, t: float) -> None:
        self.events.append((token, t))
        self.first_time = t
        self._last = t
        self.sent = 1

    def emit(self, token: int, t: float) -> None:
        self.events.append((token, t))
        if self._last is not None:
            self.gaps.append(t - self._last)
        self._last = t
        self.sent += 1

    def rollback(self) -> None:
        """Preemption: the engine will regenerate from the first token.

        The next emitted gap is measured from the *original* first
        emission — exactly how ``finalize_step`` measures it (cleared
        ``decode_times`` fall back to the retained ``prefill_done``).
        """
        if self.sent > 0:
            self.sent = 1
            self._last = self.first_time
        # never prefilled: nothing delivered, nothing to roll back


@dataclass
class _Entry:
    req: Request
    deadline: Optional[float]
    attempts: int = 0                    # pool-exhaustion submit tries
    # recovery bookkeeping, deliberately NOT ``attempts``: a request
    # redriven after a replica death keeps its full pool-exhaustion
    # requeue credit — backpressure and recovery must not alias
    redrives: int = 0
    last_attempt: float = float("-inf")


class TenantDoor:
    """Per-tenant admission queue + verdict ledger."""

    def __init__(self, name: str, cfg: DoorConfig = DoorConfig()):
        self.name = name
        self.cfg = cfg
        self.queue: deque = deque()          # _Entry, FIFO
        self.streams: Dict[int, TokenStream] = {}
        self._state: Dict[int, Verdict] = {}     # req_id -> latest verdict
        # the ledger
        self.offered = 0
        self.rejected = 0
        self.shed = 0
        self.expired = 0
        self.completed = 0
        self.in_flight = 0
        # non-terminal transition counter: requests re-enqueued after a
        # replica death (they stay ACCEPTED/in-flight, so conservation
        # is untouched — this only counts the recovery traffic)
        self.redriven = 0
        self.reject_reasons: Dict[str, int] = {}

    # ------------------------------------------------------------- verdicts
    def _terminal(self, req: Request, verdict: Verdict,
                  reason: str = "") -> None:
        prev = self._state.get(req.req_id)
        if prev in TERMINAL:
            raise AssertionError(
                f"request {req.req_id} ({self.name}) got a second terminal "
                f"verdict {verdict.value} after {prev.value}")
        self._state[req.req_id] = verdict
        if verdict is Verdict.REJECTED:
            self.rejected += 1
            self.reject_reasons[reason] = \
                self.reject_reasons.get(reason, 0) + 1
        elif verdict is Verdict.SHED:
            self.shed += 1
        elif verdict is Verdict.EXPIRED:
            self.expired += 1
        elif verdict is Verdict.COMPLETED:
            self.completed += 1
        if prev is Verdict.ACCEPTED:
            self.in_flight -= 1

    def verdict_of(self, req_id: int) -> Optional[Verdict]:
        return self._state.get(req_id)

    def check(self) -> None:
        """Conservation invariant — every offered request is accounted."""
        balance = (self.completed + self.rejected + self.shed
                   + self.expired + self.in_flight)
        assert self.offered == balance, (
            f"verdict conservation violated for {self.name!r}: offered="
            f"{self.offered} != completed={self.completed} + rejected="
            f"{self.rejected} + shed={self.shed} + expired={self.expired}"
            f" + in_flight={self.in_flight}")
        assert self.in_flight >= len(self.queue), (
            f"{self.name!r}: {len(self.queue)} queued but only "
            f"{self.in_flight} in flight")

    def counters(self) -> Dict[str, int]:
        return {"offered": self.offered, "completed": self.completed,
                "rejected": self.rejected, "shed": self.shed,
                "expired": self.expired, "in_flight": self.in_flight,
                "redriven": self.redriven, "queued": len(self.queue)}


class Gateway:
    """The request-plane front door over a fleet of per-tenant replicas.

    Shares the *live* ``engines`` / ``routers`` dicts with the serving
    loop, so tenants admitted mid-run (tenant-plane admission control)
    get doors on first offer without re-wiring.
    """

    def __init__(self, engines: Dict[str, List[ServingEngine]],
                 routers: Optional[Dict[str, object]] = None, *,
                 door_cfgs: Optional[Dict[str, DoorConfig]] = None,
                 default_cfg: DoorConfig = DoorConfig(),
                 paused_until: Optional[Callable[[str], float]] = None,
                 tracer: Optional[object] = None):
        self.engines = engines
        self.routers = routers if routers is not None else {}
        self.door_cfgs = door_cfgs or {}
        self.default_cfg = default_cfg
        self.paused_until = paused_until or (lambda name: 0.0)
        self.doors: Dict[str, TenantDoor] = {}
        # replicas declared dead by the recovery path: masked out of
        # routing (infinite load) and never submitted to again
        self._dead: Dict[str, set] = {}
        # serving.trace.FlightRecorder (or None): door-side span sources —
        # offer/admit/expire/reject; engine-side spans flow via
        # finalize_step's own hook
        self.tracer = tracer

    def door(self, name: str) -> TenantDoor:
        d = self.doors.get(name)
        if d is None:
            d = TenantDoor(name, self.door_cfgs.get(name, self.default_cfg))
            self.doors[name] = d
        return d

    # ---------------------------------------------------------------- offer
    def offer(self, req: Request, now: float) -> Verdict:
        """Front-door decision for one arrival.  Never blocks: the
        request is SHED (paused tenant), REJECTED fast, or ACCEPTED into
        the bounded queue for dispatch."""
        door = self.door(req.tenant)
        door.offered += 1
        verdict = Verdict.ACCEPTED
        if req.arrival < self.paused_until(req.tenant):
            door._terminal(req, Verdict.SHED)
            verdict = Verdict.SHED
        elif (lim := door.cfg.rate_limiter) is not None \
                and not lim.allow(now):
            door._terminal(req, Verdict.REJECTED, "rate_limit")
            verdict = Verdict.REJECTED
        elif len(door.queue) >= door.cfg.max_queue:
            door._terminal(req, Verdict.REJECTED, "queue_full")
            verdict = Verdict.REJECTED
        else:
            door._state[req.req_id] = Verdict.ACCEPTED
            door.in_flight += 1
            deadline = None if door.cfg.deadline_s is None \
                else now + door.cfg.deadline_s
            door.queue.append(_Entry(req, deadline))
            door.streams[req.req_id] = TokenStream(req)
        if self.tracer is not None:
            self.tracer.on_offer(req, now, verdict.value)
        return verdict

    # ------------------------------------------------------------ recovery
    def mark_dead(self, name: str, idx: int) -> None:
        """Stop routing/submitting tenant ``name`` to replica ``idx``."""
        self._dead.setdefault(name, set()).add(idx)

    def mark_live(self, name: str, idx: int) -> None:
        """Readmit a replica to routing — a gray-failed replica that was
        evacuated (quarantined) can come back once its slowdown window
        passes, unlike a crashed one."""
        self._dead.get(name, set()).discard(idx)

    def live_replicas(self, name: str) -> List[int]:
        dead = self._dead.get(name, ())
        return [j for j in range(len(self.engines.get(name, [])))
                if j not in dead]

    def redrive(self, name: str, reqs: List[Request], now: float, *,
                from_engine: int = -1) -> int:
        """Re-enqueue a dead replica's in-flight requests for dispatch
        to a survivor.  The requests stay ACCEPTED — no verdict is
        spent, so conservation holds by construction — and each fresh
        entry carries a **full** pool-exhaustion requeue credit
        (``attempts=0``): recovery must never eat into backpressure's
        budget.  Partially-streamed requests roll their stream back
        exactly like a preemption (regeneration re-emits from the
        original first-token clock).  Returns the number redriven."""
        door = self.door(name)
        n = 0
        for req in reversed(reqs):     # appendleft: preserve FIFO order
            if door._state.get(req.req_id) is not Verdict.ACCEPTED:
                continue               # already terminal: nothing to save
            st = door.streams.get(req.req_id)
            if st is not None:
                st.rollback()
            deadline = None if door.cfg.deadline_s is None \
                else now + door.cfg.deadline_s
            door.queue.appendleft(_Entry(req, deadline, redrives=1))
            door.redriven += 1
            n += 1
            if self.tracer is not None:
                self.tracer.on_redrive(req, now, from_engine=from_engine)
        return n

    def adopt_warm(self, name: str, reqs: List[Request], now: float,
                   arrive_time: float, *, from_engine: int = -1,
                   to_engine: int = -1) -> int:
        """Live migration landed: ``reqs`` are already resident on the
        destination replica (their KV pages shipped and verified), so
        unlike :meth:`redrive` they do NOT re-enter the door queue and
        their token streams do NOT roll back — the lane resumes where it
        left off, TTFT stamp conserved.  Still ACCEPTED, still in
        flight: conservation is untouched.  The flight recorder's
        handoff segment spans the transfer (``now`` → ``arrive_time``).
        Returns the number adopted."""
        door = self.door(name)
        n = 0
        for req in reqs:
            if door._state.get(req.req_id) is not Verdict.ACCEPTED:
                continue
            door.redriven += 1
            n += 1
            if self.tracer is not None:
                self.tracer.on_redrive(req, now, from_engine=from_engine)
                self.tracer.on_admit(req, arrive_time, engine=to_engine)
        return n

    def abandon(self, name: str, reqs: List[Request], now: float, *,
                reason: str = "replica_crash") -> int:
        """Recovery-off path: a dead replica's in-flight requests are
        SHED (their single terminal verdict) instead of redriven."""
        door = self.door(name)
        n = 0
        for req in reqs:
            if door._state.get(req.req_id) is not Verdict.ACCEPTED:
                continue
            door.streams.pop(req.req_id, None)
            door._terminal(req, Verdict.SHED)
            n += 1
            if self.tracer is not None:
                self.tracer.on_terminal(req, now, "shed", reason=reason)
        return n

    # ------------------------------------------------------------- dispatch
    def _route(self, name: str, req: Request) -> int:
        engs = self.engines[name]
        dead = self._dead.get(name, ())
        loads = [float("inf") if j in dead
                 else len(e.queue) + len(e.active())
                 for j, e in enumerate(engs)]
        router = self.routers.get(name)
        if router is not None:
            return router.route(req, loads)
        return int(np.argmin(loads))

    def dispatch(self, now: float) -> int:
        """Drain door queues into engines.  Returns submits that landed.

        Head-of-line per tenant: expired entries fall out first, then
        the head is submitted at most once per dispatch round; a
        transient rejection (pool exhausted) leaves it queued for a
        retry (bounded by ``max_attempts``), a structural one or an
        exhausted retry budget turns into a REJECTED verdict.
        """
        landed = 0
        for name, door in list(self.doors.items()):
            while door.queue:
                entry = door.queue[0]
                if entry.deadline is not None and now >= entry.deadline:
                    door.queue.popleft()
                    door.streams.pop(entry.req.req_id, None)
                    door._terminal(entry.req, Verdict.EXPIRED)
                    if self.tracer is not None:
                        self.tracer.on_terminal(entry.req, now, "expired")
                    continue
                if entry.last_attempt >= now:
                    break                   # already tried this instant
                if name not in self.engines or not self.engines[name]:
                    break                   # replicas not wired yet
                if not self.live_replicas(name):
                    break                   # every replica is dead
                entry.attempts += 1
                entry.last_attempt = now
                idx = self._route(name, entry.req)
                outcome = self.engines[name][idx].submit(entry.req)
                if outcome:
                    entry.req.submitted = now
                    door.queue.popleft()
                    landed += 1
                    if self.tracer is not None:
                        self.tracer.on_admit(entry.req, now, engine=idx)
                    continue
                if not outcome.transient \
                        or entry.attempts >= door.cfg.max_attempts:
                    door.queue.popleft()
                    door.streams.pop(entry.req.req_id, None)
                    door._terminal(entry.req, Verdict.REJECTED,
                                   outcome.reason)
                    if self.tracer is not None:
                        self.tracer.on_terminal(entry.req, now, "rejected",
                                                reason=outcome.reason)
                    continue
                break       # transient shortage: hold the line, retry later
        return landed

    # ------------------------------------------------------------- finalize
    def finalize(self, name: str, eng: ServingEngine, report: StepReport,
                 end_time: float,
                 start_time: Optional[float] = None) -> None:
        """Timestamp an engine step *and* mirror it into door state:
        engine metrics first (the authoritative clocks), then streams
        (first token / per-token emissions / preemption rollbacks) and
        terminal COMPLETED verdicts.  ``start_time`` (the step's launch
        instant on the virtual clock) flows to the engine's trace hook so
        prefill-chunk spans cover the step window rather than a point."""
        eng.finalize_step(report, end_time, start_time)
        door = self.doors.get(name)
        if door is None:
            return
        for req in report.preempted:
            st = door.streams.get(req.req_id)
            if st is not None:
                st.rollback()
        for req in report.prefilled:
            st = door.streams.get(req.req_id)
            if st is not None and req.output_tokens:
                st.first(req.output_tokens[0], end_time)
        for req in report.decoded:
            # one entry per committed token (spec bursts repeat the
            # request) — emit each, preserving multiplicity so stream
            # gaps match the metrics window sample-for-sample
            st = door.streams.get(req.req_id)
            if st is not None:
                idx = min(st.sent, len(req.output_tokens) - 1)
                st.emit(req.output_tokens[idx], end_time)
        for req in report.completed:
            if door._state.get(req.req_id) is Verdict.ACCEPTED:
                door._terminal(req, Verdict.COMPLETED)

    # ------------------------------------------------------------ inventory
    def queued_total(self) -> int:
        return sum(len(d.queue) for d in self.doors.values())

    def check(self) -> None:
        for door in self.doors.values():
            door.check()

    def counters(self) -> Dict[str, Dict[str, int]]:
        return {name: d.counters() for name, d in self.doors.items()}

    # ----------------------------------------------------------- prometheus
    @staticmethod
    def _pool_p99(windows, now: Optional[float]) -> float:
        vals: List[float] = []
        for w in windows:
            vals.extend(v for _, v in w.samples)
        if not vals:
            return 0.0
        return float(np.quantile(np.asarray(vals), 0.99))

    def prometheus(self, now: Optional[float] = None) -> str:
        """Prometheus text exposition of the gateway's view of the
        fleet: verdict ledger, queue/lane gauges, cache-efficacy rates,
        and the door- vs engine-measured TTFT tails."""
        lines: List[str] = []

        def emit(metric: str, help_: str, typ: str, rows) -> None:
            lines.append(f"# HELP {metric} {help_}")
            lines.append(f"# TYPE {metric} {typ}")
            for labels, value in rows:
                lab = ",".join(f'{k}="{v}"' for k, v in labels.items())
                lines.append(f"{metric}{{{lab}}} {value:g}")

        names = sorted(set(self.doors) | set(self.engines))
        doors = {n: self.door(n) for n in names}
        engs = {n: self.engines.get(n, []) for n in names}

        emit("gateway_offered_total", "Requests offered at the front door.",
             "counter", [({"tenant": n}, doors[n].offered) for n in names])
        emit("gateway_verdict_total", "Terminal verdicts by type.", "counter",
             [({"tenant": n, "verdict": v}, getattr(doors[n], v))
              for n in names
              for v in ("completed", "rejected", "shed", "expired")]
             + [({"tenant": n, "verdict": "accepted"},
                 doors[n].in_flight + doors[n].completed) for n in names])
        emit("gateway_queue_depth", "Requests waiting in the door queue.",
             "gauge", [({"tenant": n}, len(doors[n].queue)) for n in names])
        emit("gateway_in_flight", "Accepted requests not yet terminal.",
             "gauge", [({"tenant": n}, doors[n].in_flight) for n in names])

        active = {n: sum(len(e.active()) for e in engs[n]) for n in names}
        cap = {n: sum(e.max_slots for e in engs[n]) for n in names}
        emit("gateway_active_lanes", "Decode lanes currently occupied.",
             "gauge", [({"tenant": n}, active[n]) for n in names])
        emit("gateway_saturation", "Active lanes / lane capacity.", "gauge",
             [({"tenant": n}, active[n] / cap[n] if cap[n] else 0.0)
              for n in names])

        def rate(n: str, num_attr: str, den_attr: str,
                 den_plus_num: bool = False) -> float:
            num = sum(getattr(e.metrics, num_attr) for e in engs[n])
            den = sum(getattr(e.metrics, den_attr) for e in engs[n])
            if den_plus_num:
                den += num
            return num / den if den else 0.0

        emit("gateway_prefix_hit_rate",
             "Prompt tokens served from the shared prefix cache.", "gauge",
             [({"tenant": n},
               rate(n, "prefix_hit_tokens_total", "prefill_tokens_total",
                    den_plus_num=True)) for n in names])
        emit("gateway_spec_accept_rate",
             "Speculative draft tokens accepted by the model.", "gauge",
             [({"tenant": n},
               rate(n, "accepted_tokens_total", "drafted_tokens_total"))
              for n in names])
        emit("gateway_response_cache_hit_rate",
             "Submits self-primed from the response cache.", "gauge",
             [({"tenant": n},
               rate(n, "response_cache_hits", "response_cache_lookups"))
              for n in names])

        emit("gateway_door_ttft_p99_seconds",
             "TTFT p99 measured from front-door arrival.", "gauge",
             [({"tenant": n},
               self._pool_p99([e.metrics.latency for e in engs[n]], now))
              for n in names])
        emit("gateway_engine_ttft_p99_seconds",
             "TTFT p99 measured from engine submit.", "gauge",
             [({"tenant": n},
               self._pool_p99([e.metrics.engine_ttft for e in engs[n]], now))
              for n in names])

        # cumulative histograms: unlike the windowed p99 gauges above,
        # bucket counts are never trimmed, so they aggregate correctly
        # across replicas and scrape intervals (rate() / histogram_quantile)
        def emit_hist(metric: str, help_: str, attr: str) -> None:
            lines.append(f"# HELP {metric} {help_}")
            lines.append(f"# TYPE {metric} histogram")
            for n in names:
                windows = [getattr(e.metrics, attr) for e in engs[n]]
                acc: List[List[float]] = []
                total_sum = 0.0
                # per-bucket exemplar: slowest retained sample across the
                # tenant's replicas (OpenMetrics `# {req_id="..."} v ts`
                # suffix on the bucket line) — the request a dashboard
                # drill-down from this bucket should land on
                exemplars: List[Optional[tuple]] = []
                for w in windows:
                    h = w.hist()
                    if not acc:
                        acc = [[le, float(c)] for le, c in h]
                        exemplars = list(w.exemplars)
                    else:
                        for i, (_, c) in enumerate(h):
                            acc[i][1] += c
                        for i, ex in enumerate(w.exemplars):
                            if ex is not None and (exemplars[i] is None
                                                   or ex[0] > exemplars[i][0]):
                                exemplars[i] = ex
                    total_sum += w.sum
                count = acc[-1][1] if acc else 0.0
                for i, (le, c) in enumerate(acc):
                    tag = "+Inf" if le == float("inf") else f"{le:g}"
                    line = f'{metric}_bucket{{tenant="{n}",le="{tag}"}} {c:g}'
                    ex = exemplars[i] if i < len(exemplars) else None
                    if ex is not None:
                        val, rid, ts = ex
                        line += f' # {{req_id="{rid}"}} {val:g} {ts:g}'
                    lines.append(line)
                lines.append(f'{metric}_sum{{tenant="{n}"}} {total_sum:g}')
                lines.append(f'{metric}_count{{tenant="{n}"}} {count:g}')

        emit_hist("gateway_door_ttft_seconds",
                  "TTFT from front-door arrival to first token.", "latency")
        emit_hist("gateway_engine_ttft_seconds",
                  "TTFT from engine submit to first token.", "engine_ttft")
        emit_hist("gateway_itl_seconds",
                  "Inter-token latency between streamed emissions.", "itl")
        return "\n".join(lines) + "\n"
