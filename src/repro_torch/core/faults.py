"""Deterministic fault injection + the recovery-side actuator wrapper.

Failure-domain machinery for the serving stack.  Three pieces:

- ``FaultInjector`` — a seeded, virtual-clock fault schedule (replica
  crashes, actuator-call failures/timeouts, transient fabric
  degradation, stuck decode lanes).  The schedule is a pure function of
  its seed and plan arguments, every delivery is appended to ``log``,
  and no wall-clock or unseeded randomness is consulted anywhere — so a
  chaos run replays bit-identically from the same seed (property-tested
  in ``tests/test_faults.py``).

- ``RetryingActuator`` — wraps any ``Actuator`` (ServingActuator or
  ClusterSim) with bounded retries, virtual-time exponential backoff
  (backoff is *charged to the returned pause* for pause-returning
  methods — retrying is downtime, not free), and rollback to the last
  known-good setting when retries exhaust.  Retry cycles are gated by
  the controller's dwell/cooldown FSM: once a (method, tenant) pair
  exhausts, further cycles are refused for a cooldown window, and a
  cooling-down FSM stops a cycle after its first failed attempt — the
  wrapper can never thrash an actuator the control law already decided
  to leave alone.

- ``StuckLaneWatchdog`` — observes per-lane token progress and reports
  lanes that have made none for longer than a timeout; the caller
  requeues them through the scheduler's refcount-safe preemption path.

Crash recovery itself (redrive, directory retraction, ledger release)
lives with the dispatcher in ``launch/serve.py``; this module only
decides *when* things break and how actuation heals.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class ActuatorFault(RuntimeError):
    """An injected (or real) failure of a single actuator call."""


@dataclass(frozen=True)
class Fault:
    """One scheduled fault.  ``kind`` selects which fields matter:

    - ``replica_crash``: tenant, replica
    - ``actuator_fail``: method, count (consecutive failing calls),
      timeout_s (virtual time each failed call burns before erroring)
    - ``fabric_degrade``: factor (>1 inflates step durations), duration_s
    - ``lane_stuck``: tenant, replica (the harness picks the victim lane
      deterministically; the lane stays stuck until recovered)
    - ``replica_slow``: tenant, replica, factor (>1 inflates that one
      replica's step durations), duration_s — a gray failure: the
      replica keeps answering, just slowly, so the crash detector and
      the watchdog both stay quiet while the tail degrades
    """
    time: float
    kind: str
    tenant: str = ""
    replica: int = -1
    method: str = ""
    count: int = 1
    timeout_s: float = 0.0
    factor: float = 1.0
    duration_s: float = 0.0


class FaultInjector:
    """Seeded virtual-clock fault schedule every layer consults.

    The harness drains ``due(now)`` each loop iteration and handles
    ``replica_crash`` / ``lane_stuck`` events itself; ``actuator_fail``
    and ``fabric_degrade`` events arm injector-internal state that the
    :class:`RetryingActuator` and the step loop query.  All queries are
    pure functions of (schedule, query times), so two runs driving the
    same virtual clock produce identical ``log`` contents.
    """

    def __init__(self, schedule: Sequence[Fault] = ()):
        self.schedule: List[Fault] = sorted(schedule,
                                            key=lambda f: (f.time, f.kind,
                                                           f.tenant,
                                                           f.replica,
                                                           f.method))
        self._cursor = 0
        # armed state from delivered events
        self._armed_fail: Dict[str, int] = {}       # method -> calls left
        self._fail_timeout: Dict[str, float] = {}   # method -> timeout_s
        self._fabric: List[Tuple[float, float, float]] = []  # (t0, t1, fac)
        # (t0, t1, tenant, replica, factor) gray-failure windows
        self._slow: List[Tuple[float, float, str, int, float]] = []
        # replay-identity record: (time, kind, detail)
        self.log: List[Tuple[float, str, str]] = []

    # ---------------------------------------------------------- planning
    @classmethod
    def plan(cls, seed: int, duration_s: float, *,
             tenants: Sequence[str], replicas: int,
             crashes: int = 1, actuator_failures: int = 2,
             stuck_lanes: int = 1, fabric_windows: int = 0,
             methods: Sequence[str] = ("reconfigure", "move"),
             fail_count: int = 2, fail_timeout_s: float = 0.5,
             fabric_factor: float = 2.0,
             fabric_duration_s: float = 5.0,
             slow_replicas: int = 0,
             slow_factor: float = 4.0,
             slow_duration_s: float = 5.0) -> "FaultInjector":
        """Generate a schedule deterministically from ``seed`` and the
        plan arguments — no other entropy source exists."""
        rng = np.random.default_rng(seed)
        tenants = list(tenants)
        events: List[Fault] = []
        for _ in range(crashes):
            events.append(Fault(
                time=float(rng.uniform(0.25, 0.65) * duration_s),
                kind="replica_crash",
                tenant=tenants[int(rng.integers(len(tenants)))],
                replica=int(rng.integers(replicas))))
        for _ in range(actuator_failures):
            events.append(Fault(
                time=float(rng.uniform(0.1, 0.9) * duration_s),
                kind="actuator_fail",
                method=str(methods[int(rng.integers(len(methods)))]),
                count=fail_count, timeout_s=fail_timeout_s))
        for _ in range(stuck_lanes):
            events.append(Fault(
                time=float(rng.uniform(0.15, 0.75) * duration_s),
                kind="lane_stuck",
                tenant=tenants[int(rng.integers(len(tenants)))],
                replica=int(rng.integers(replicas))))
        for _ in range(fabric_windows):
            events.append(Fault(
                time=float(rng.uniform(0.1, 0.8) * duration_s),
                kind="fabric_degrade",
                factor=fabric_factor, duration_s=fabric_duration_s))
        for _ in range(slow_replicas):
            events.append(Fault(
                time=float(rng.uniform(0.15, 0.6) * duration_s),
                kind="replica_slow",
                tenant=tenants[int(rng.integers(len(tenants)))],
                replica=int(rng.integers(replicas)),
                factor=slow_factor, duration_s=slow_duration_s))
        return cls(events)

    # ---------------------------------------------------------- delivery
    def due(self, now: float) -> List[Fault]:
        """Deliver every scheduled fault with ``time <= now`` (in
        schedule order), arming internal state for the armed kinds."""
        out: List[Fault] = []
        while self._cursor < len(self.schedule) and \
                self.schedule[self._cursor].time <= now:
            f = self.schedule[self._cursor]
            self._cursor += 1
            if f.kind == "actuator_fail":
                self._armed_fail[f.method] = \
                    self._armed_fail.get(f.method, 0) + f.count
                self._fail_timeout[f.method] = f.timeout_s
            elif f.kind == "fabric_degrade":
                self._fabric.append((f.time, f.time + f.duration_s,
                                     f.factor))
            elif f.kind == "replica_slow":
                self._slow.append((f.time, f.time + f.duration_s,
                                   f.tenant, f.replica, f.factor))
            self.log.append((f.time, f.kind,
                             f"{f.tenant}/{f.replica}/{f.method}"))
            out.append(f)
        return out

    def pending(self) -> int:
        return len(self.schedule) - self._cursor

    # ------------------------------------------------------- armed kinds
    def actuator_fault(self, method: str, now: float) -> Optional[Fault]:
        """Consume one armed failure for ``method`` (None if healthy)."""
        left = self._armed_fail.get(method, 0)
        if left <= 0:
            return None
        self._armed_fail[method] = left - 1
        timeout = self._fail_timeout.get(method, 0.0)
        self.log.append((now, "actuator_fault_delivered", method))
        return Fault(time=now, kind="actuator_fail", method=method,
                     timeout_s=timeout)

    def fabric_factor(self, now: float) -> float:
        """Step-duration multiplier from any active degradation window
        (windows multiply if they overlap)."""
        factor = 1.0
        for t0, t1, fac in self._fabric:
            if t0 <= now < t1:
                factor *= fac
        return factor

    def replica_factor(self, tenant: str, replica: int,
                       now: float) -> float:
        """Step-duration multiplier for one replica from any active
        ``replica_slow`` window (overlapping windows multiply), on top
        of the global :meth:`fabric_factor`."""
        factor = 1.0
        for t0, t1, ten, rep, fac in self._slow:
            if ten == tenant and rep == replica and t0 <= now < t1:
                factor *= fac
        return factor

    # ------------------------------------------------------------ replay
    def replay_key(self) -> Tuple[Tuple[float, str, str], ...]:
        """Canonical record of every delivery, for determinism asserts."""
        return tuple(self.log)


class StuckLaneWatchdog:
    """Detects lanes that stopped emitting tokens.

    The harness feeds it every active lane's ``generated`` counter after
    each engine step; ``stale(now)`` returns the keys that have made no
    progress for longer than ``timeout_s`` so the caller can requeue
    them through the scheduler's refcount-safe preemption path.
    """

    def __init__(self, timeout_s: float = 1.0):
        self.timeout_s = timeout_s
        self._progress: Dict[object, Tuple[int, float]] = {}
        self.fired: int = 0

    def observe(self, key, generated: int, now: float) -> None:
        prev = self._progress.get(key)
        if prev is None or generated > prev[0]:
            self._progress[key] = (generated, now)

    def forget(self, key) -> None:
        self._progress.pop(key, None)

    def prune(self, live_keys) -> None:
        """Drop tracking for every lane not in ``live_keys`` — lanes
        that completed, preempted or drained must never be reported
        stale just because they stopped appearing."""
        live = set(live_keys)
        for k in [k for k in self._progress if k not in live]:
            del self._progress[k]

    def stale(self, now: float) -> List[object]:
        out = [k for k, (_, since) in self._progress.items()
               if now - since >= self.timeout_s]
        if out:
            self.fired += len(out)
            for k in out:
                self._progress.pop(k, None)
        return out


@dataclass(frozen=True)
class RetryConfig:
    max_attempts: int = 3            # total tries per call (1 + retries)
    base_backoff_s: float = 0.05     # virtual-time delay before retry 1
    backoff_mult: float = 2.0        # exponential growth per retry
    exhaustion_cooldown_s: float = 10.0   # refuse new cycles this long


class RetryingActuator:
    """Bounded-retry wrapper over the controller's ``Actuator`` protocol.

    Implements every protocol method (lint-enforced over
    ``vars(Actuator)`` in ``tests/test_faults.py``) by delegating to the
    wrapped actuator through one retry loop:

    - each attempt first consults the :class:`FaultInjector` (and also
      treats an :class:`ActuatorFault` raised by the inner actuator as a
      failure), backing off exponentially in *virtual* time;
    - backoff + injected timeouts are charged to the returned pause for
      pause-returning methods (``reconfigure`` / ``move``) — a retried
      reconfigure pauses the tenant longer, it is not free;
    - on exhaustion the wrapper rolls the (method, tenant) pair back to
      its last known-good setting (recorded on every success) and gates
      further retry cycles for ``exhaustion_cooldown_s``;
    - a cooling-down :class:`~repro.core.policy.DecisionFSM` (via
      ``fsm_for``) stops a cycle after its first failed attempt, so
      retries never thrash a lane the control law is holding still.
    """

    def __init__(self, inner, clock: Callable[[], float],
                 faults: Optional[FaultInjector] = None,
                 cfg: RetryConfig = RetryConfig(),
                 fsm_for: Optional[Callable[[str], object]] = None,
                 tracer=None):
        self.inner = inner
        self.clock = clock
        self.faults = faults
        self.cfg = cfg
        self.fsm_for = fsm_for
        self.tracer = tracer
        self._last_good: Dict[Tuple[str, str], tuple] = {}
        self._gate_until: Dict[Tuple[str, str], float] = {}
        self.stats: Dict[str, int] = {
            "calls": 0, "faults": 0, "retried_calls": 0,
            "exhausted": 0, "rollbacks": 0, "rollback_failed": 0,
            "gated": 0,
        }
        self.time_lost_s: float = 0.0

    # ------------------------------------------------------------ helpers
    def _trace(self, name: str, tenant: str, **args) -> None:
        if self.tracer is not None:
            self.tracer.action(name, self.clock(), tenant, **args)

    def _fsm_cooling(self, tenant: str) -> bool:
        if self.fsm_for is None or not tenant:
            return False
        fsm = self.fsm_for(tenant)
        return fsm is not None and fsm.is_cooling_down()

    def _call(self, method: str, tenant: str, args: tuple, *,
              charge_pause: bool = False, default=None):
        self.stats["calls"] += 1
        now = self.clock()
        key = (method, tenant)
        if self._gate_until.get(key, -math.inf) > now:
            # a previous cycle exhausted for this pair and we are still
            # inside its cooldown: don't start another storm
            self.stats["gated"] += 1
            self._trace("actuator_gated", tenant, method=method)
            return default
        delay = self.cfg.base_backoff_s
        lost = 0.0
        for attempt in range(self.cfg.max_attempts):
            fault = (self.faults.actuator_fault(method, now + lost)
                     if self.faults is not None else None)
            if fault is None:
                try:
                    val = getattr(self.inner, method)(*args)
                except ActuatorFault as exc:
                    fault = Fault(time=now + lost, kind="actuator_fail",
                                  method=method)
                    self._trace("actuator_fault", tenant, method=method,
                                error=str(exc))
                else:
                    if attempt > 0:
                        self.stats["retried_calls"] += 1
                    self._last_good[key] = args
                    if charge_pause and lost > 0:
                        self.time_lost_s += lost
                        return float(val) + lost
                    return val
            self.stats["faults"] += 1
            self._trace("actuator_retry", tenant, method=method,
                        attempt=attempt + 1, backoff_s=delay)
            lost += fault.timeout_s + delay
            delay *= self.cfg.backoff_mult
            if self._fsm_cooling(tenant):
                break   # FSM says hold still: no further retries
        # ---- exhausted: roll back to last known-good and gate
        self.stats["exhausted"] += 1
        self.time_lost_s += lost
        self._gate_until[key] = now + self.cfg.exhaustion_cooldown_s
        good = self._last_good.get(key)
        if good is not None and good != args:
            blocked = (self.faults.actuator_fault(method, now + lost)
                       if self.faults is not None else None)
            if blocked is None:
                try:
                    getattr(self.inner, method)(*good)
                    self.stats["rollbacks"] += 1
                    self._trace("actuator_rollback", tenant, method=method)
                except ActuatorFault:
                    self.stats["rollback_failed"] += 1
            else:
                self.stats["rollback_failed"] += 1
        return default

    # ------------------------------------------- Actuator protocol surface
    def reconfigure(self, tenant, profile):
        return self._call("reconfigure", tenant, (tenant, profile),
                          charge_pause=True, default=0.0)

    def move(self, tenant, slot):
        return self._call("move", tenant, (tenant, slot),
                          charge_pause=True, default=0.0)

    def set_io_throttle(self, tenant, bytes_per_s):
        return self._call("set_io_throttle", tenant, (tenant, bytes_per_s))

    def set_mps_quota(self, tenant, frac):
        return self._call("set_mps_quota", tenant, (tenant, frac))

    def pin_cpu_away_from_irq(self, tenant):
        return self._call("pin_cpu_away_from_irq", tenant, (tenant,))

    def free_slots(self):
        return self._call("free_slots", "", (), default=[])

    def headroom_units(self, device):
        return self._call("headroom_units", "", (device,), default=0)

    def migrate(self, tenant, replica_from, replica_to):
        return self._call("migrate", tenant,
                          (tenant, replica_from, replica_to),
                          charge_pause=True, default=0.0)
