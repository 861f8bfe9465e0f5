"""Discrete-event cluster simulator — registry-driven multi-tenant model.

Implements the paper's evaluation environment generalized to N
latency-sensitive tenants with R >= 1 replicas each: a p4d-style cluster
topology, background interferers (bandwidth-heavy ETL, compute-heavy
training) toggled by an interference schedule, and the PS-fabric latency
law from §2.5.1 applied per replica on its PCIe root complex:

    L = wait_in_queue + c(profile, batch, compute-contention) + s / b(t) + eps

The tenant set is data (`TenantRegistry`), not code: the paper's exact
3-tenant scenario is `TenantRegistry.paper_default(params)` (the default
when `SimParams.tenants` is None), so E1/E2 calibration is unchanged,
while `benchmarks/e5_multitenant.py` instantiates 2-8 competing SLO
tenants through the same machinery.

The simulator implements the controller's Actuator protocol, so the *same*
Controller object that manages the JAX serving stack drives the simulation:
moves and MIG reconfigurations pause the affected tenant (requests
load-shed), throttles change a background tenant's effective fabric
demand, MPS quotas scale compute interference.
"""
from __future__ import annotations

import heapq
import itertools
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import psmodel
from repro_torch.core.faults import ActuatorFault
from repro_torch.core.ledger import DeviceLedger
from repro_torch.core.profiles import A100_MIG, ProfileLattice, SliceProfile
from repro_torch.core.signals import Snapshot, SystemSignals, TenantSignals
from repro_torch.core.tenancy import TenantRegistry, TenantSpec
from repro_torch.core.topology import ClusterTopology, Slot, make_p4d_cluster
from repro_torch.serving.metrics import LatencyWindow
from repro_torch.sim.params import SimParams


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    kind: str = field(compare=False)
    payload: dict = field(compare=False, default_factory=dict)


@dataclass
class _Replica:
    """One serving instance of a latency tenant."""
    slot: Slot
    queue: Deque[Tuple[float, float]] = field(default_factory=deque)
    in_service: int = 0

    @property
    def load(self) -> int:
        return self.in_service + len(self.queue)


@dataclass
class _LatencyTenant:
    """Runtime state of a latency-sensitive tenant (spec + replicas)."""
    spec: TenantSpec
    profile: SliceProfile
    replicas: List[_Replica]
    window: LatencyWindow
    all_latencies: List[float] = field(default_factory=list)
    completions: Deque[float] = field(default_factory=lambda: deque(
        maxlen=4096))
    completed: int = 0
    offered: int = 0
    dropped: int = 0
    paused_until: float = 0.0
    pinned: bool = False
    pause_total: float = 0.0
    _size_probs: Optional[np.ndarray] = None
    _size_vals: Optional[np.ndarray] = None

    def __post_init__(self):
        probs = np.array([p for p, _ in self.spec.sizes])
        self._size_probs = probs / probs.sum()
        self._size_vals = np.array([s for _, s in self.spec.sizes])

    def in_flight(self) -> int:
        return sum(r.load for r in self.replicas)


@dataclass
class _BackgroundTenant:
    """Runtime state of a background interferer."""
    spec: TenantSpec
    slot: Slot
    active: bool = False
    io_throttle: Optional[float] = None
    mps_quota: float = 1.0


@dataclass
class TenantSimResult:
    """Per-tenant outcome of one simulation run."""
    latencies: np.ndarray
    miss_rate: float
    p95: float
    p99: float
    p999: float
    completed: int
    offered: int
    dropped: int
    throughput_rps: float
    slo_s: float
    replicas: int


@dataclass
class SimResult:
    """Top-level fields describe the *primary* (first latency) tenant so
    the seed's E1/E2 readers keep working; ``tenants`` carries every
    latency tenant's numbers."""
    latencies: np.ndarray                 # primary tenant latencies (s)
    miss_rate: float
    p95: float
    p99: float
    p999: float
    completed: int
    offered: int
    dropped: int
    throughput_rps: float
    actions: Dict[str, int]
    reconfig_times: List[float]
    controller_cpu_frac: float
    timeline: List[Tuple[float, str]]     # (time, action) for Fig-3 plots
    tenants: Dict[str, TenantSimResult] = field(default_factory=dict)
    aggregate_rps: float = 0.0            # all latency tenants combined
    arbiter_max_units: int = 0            # peak per-GPU units (audit)
    arbiter_budget: int = 7
    # controller wall-clock per sample tick (the fleet-scaling signal:
    # Table 4's controller CPU% analogue, measured per decision round)
    controller_ticks: int = 0
    controller_tick_ms_mean: float = 0.0
    controller_tick_ms_max: float = 0.0


class ClusterSim:
    """Event-driven simulation implementing the controller Actuator."""

    def __init__(self, params: SimParams, controller_factory=None,
                 topo: Optional[ClusterTopology] = None,
                 lattice: ProfileLattice = A100_MIG,
                 tracer=None, faults=None):
        self.p = params
        self.rng = np.random.default_rng(params.seed)
        self.topo = topo or make_p4d_cluster(2)
        self.lattice = lattice
        self.now = 0.0
        # core.obs.Tracer (or None): the sim implements the same
        # one-trace-event-per-actuator-method contract as ServingActuator
        self.tracer = tracer
        # core.faults.FaultInjector (or None): armed actuator failures
        # make the sim's Actuator methods raise ActuatorFault before any
        # state changes — wrap the sim in a RetryingActuator to recover
        self.faults = faults
        self._eseq = itertools.count()
        self.events: List[_Event] = []
        # --- tenant model (registry-driven) ---
        self.registry = (TenantRegistry(params.tenants)
                         if params.tenants is not None
                         else TenantRegistry.paper_default(params))
        placements = self.registry.resolve_placements(self.topo)
        self.lat: Dict[str, _LatencyTenant] = {}
        self.bg: Dict[str, _BackgroundTenant] = {}
        for spec in self.registry:
            slots = placements[spec.name]
            if spec.is_latency:
                self.lat[spec.name] = _LatencyTenant(
                    spec=spec,
                    profile=self._initial_profile(spec),
                    replicas=[_Replica(slot=s) for s in slots],
                    window=LatencyWindow(max_samples=1 << 16, horizon_s=30.0))
            else:
                self.bg[spec.name] = _BackgroundTenant(spec=spec,
                                                       slot=slots[0])
        if not self.lat:
            raise ValueError("registry has no latency tenant")
        self.primary = next(iter(self.lat))
        # shared placement/budget bookkeeping: slot occupancy, per-GPU
        # unit use and per-root fabric demand all live in the ledger (the
        # serving actuator builds the identical view — see the parity
        # suite).  Ambient co-tenants on non-home devices reduce headroom
        # exactly as the old inline scan did.
        self.ledger = DeviceLedger.from_registry(
            self.topo, self.registry, self.lattice, placements,
            home_devices=params.home_devices,
            ambient_units=params.ambient_units)
        # --- run state ---
        self.reconfig_times: List[float] = []
        self.controller = None
        self._controller_factory = controller_factory
        self.timeline: List[Tuple[float, str]] = []

    def _initial_profile(self, spec: TenantSpec) -> SliceProfile:
        try:
            return self.lattice[spec.profile]
        except KeyError:      # non-MIG lattice (e.g. TPU slices): 2nd rung
            return self.lattice.profiles[min(1, len(self.lattice) - 1)]

    # ------------------------------------------------------------- access
    def tenant(self, name: str) -> _LatencyTenant:
        return self.lat[name]

    def background(self, name: str) -> _BackgroundTenant:
        return self.bg[name]

    def in_flight(self, name: str) -> int:
        return self.lat[name].in_flight()

    def placements(self, tenant: str) -> List[Slot]:
        if tenant in self.lat:
            return [r.slot for r in self.lat[tenant].replicas]
        return [self.bg[tenant].slot]

    def register_tenants(self, controller) -> None:
        """Register every tenant of this sim's registry (with the sim's
        resolved placements and live profiles) into a Controller."""
        for spec in self.registry:
            if spec.is_latency:
                lt = self.lat[spec.name]
                slots = [r.slot for r in lt.replicas]
                controller.register_tenant(
                    spec.name, "latency", slots[0], lt.profile,
                    priority=spec.priority, slo_s=spec.slo_s,
                    replicas=slots)
            else:
                bg = self.bg[spec.name]
                controller.register_tenant(
                    spec.name, "background", bg.slot,
                    self._initial_profile(spec))

    # ---------------------------------------------------------- Actuator
    def _trace(self, name: str, tenant: str, dur: float = 0.0,
               **args) -> None:
        if self.tracer is not None:
            self.tracer.action(name, self.now, tenant, dur=dur, **args)

    def _maybe_fault(self, method: str) -> None:
        """Injected actuator failure: raise BEFORE any state changes so
        a failed call is a clean no-op the retry wrapper can repeat."""
        if self.faults is not None and \
                self.faults.actuator_fault(method, self.now) is not None:
            raise ActuatorFault(
                f"injected {method} failure at t={self.now:.3f}")

    def reconfigure(self, tenant: str, profile: SliceProfile) -> float:
        self._maybe_fault("reconfigure")
        lt = self.lat[tenant]
        pause = max(self.p.mig_reconfig_min_s,
                    self.rng.normal(self.p.mig_reconfig_mean_s,
                                    self.p.mig_reconfig_std_s))
        self.ledger.set_units(tenant, profile.compute_units)
        lt.profile = profile
        self._pause(tenant, pause)
        self.reconfig_times.append(pause)
        self.timeline.append((self.now, f"mig:{tenant}:{profile.name}"))
        self._trace("reconfigure", tenant, dur=pause, profile=profile.name,
                    units=profile.compute_units)
        return pause

    def move(self, tenant: str, slot: Slot) -> float:
        """Relocate the tenant's primary replica (the controller's
        placement lever steers one replica per decision)."""
        self._maybe_fault("move")
        lt = self.lat[tenant]
        self.ledger.move(tenant, 0, slot)
        lt.replicas[0].slot = slot
        self._pause(tenant, self.p.move_pause_s)
        self.timeline.append((self.now, f"move:{tenant}:{slot.key}"))
        self._trace("move", tenant, dur=self.p.move_pause_s, slot=slot.key)
        return self.p.move_pause_s

    def set_io_throttle(self, tenant: str, bytes_per_s: Optional[float]) -> None:
        self._maybe_fault("set_io_throttle")
        bg = self.bg.get(tenant)
        if bg is not None:
            bg.io_throttle = bytes_per_s
            self.timeline.append(
                (self.now, f"throttle:{tenant}:{bytes_per_s or 'off'}"))
        self._trace("set_io_throttle", tenant, bytes_per_s=bytes_per_s)

    def set_mps_quota(self, tenant: str, frac: float) -> None:
        self._maybe_fault("set_mps_quota")
        bg = self.bg.get(tenant)
        if bg is not None:
            bg.mps_quota = frac
            self.timeline.append((self.now, f"mps:{tenant}:{frac:.2f}"))
        self._trace("set_mps_quota", tenant, frac=frac)

    def pin_cpu_away_from_irq(self, tenant: str) -> None:
        self._maybe_fault("pin_cpu_away_from_irq")
        self.lat[tenant].pinned = True
        self._trace("pin_cpu_away_from_irq", tenant)

    def free_slots(self) -> List[Slot]:
        self._maybe_fault("free_slots")
        self._trace("query_free_slots", "")
        return self.ledger.free_slots()

    def headroom_units(self, device: str) -> int:
        """Free compute units on a device (budget per A100 minus all
        occupants, the asking tenant's own slice included —
        greedy_upgrade asks for the *extra*), read from the ledger."""
        self._maybe_fault("headroom_units")
        self._trace("query_headroom_units", "", device=device)
        return self.ledger.headroom_units(device)

    def migrate(self, tenant: str, replica_from: int,
                replica_to: int) -> float:
        """Live lane migration: ship the source replica's *queued* work
        to the destination (jobs already in service finish where they
        started — their completion events are scheduled).  In the
        discrete-event model the KV transfer collapses to a short pause;
        the serving stack prices it against fabric demand for real."""
        self._maybe_fault("migrate")
        lt = self.lat[tenant]
        src = lt.replicas[replica_from]
        dst = lt.replicas[replica_to]
        moved = len(src.queue)
        dst.queue.extend(src.queue)
        src.queue.clear()
        self._pause(tenant, self.p.migrate_pause_s)
        self.timeline.append(
            (self.now, f"migrate:{tenant}:r{replica_from}->r{replica_to}"))
        self._trace("migrate", tenant, dur=self.p.migrate_pause_s,
                    replica_from=replica_from, replica_to=replica_to,
                    moved=moved)
        return self.p.migrate_pause_s

    # -------------------------------------------------------- fabric state
    def _bg_effective_pcie(self, bg: _BackgroundTenant) -> float:
        if not bg.active or bg.spec.pcie_demand <= 0:
            return 0.0
        if bg.io_throttle is None:
            return bg.spec.pcie_demand
        # io.max caps the NVMe->host stage; page-cache hits keep part of the
        # host->GPU stream alive (residual), so relief is partial (§4:
        # guardrails give the smallest single-component gain).
        return (bg.spec.pcie_demand * bg.spec.throttle_residual
                + bg.io_throttle)

    def _ambient_pcie(self, root: str) -> float:
        for r, v in self.p.ambient_pcie:
            if r == root:
                return v
        return 0.0

    def _bandwidth(self, name: str, replica: _Replica) -> float:
        """This replica's PS-fabric share on its PCIe root complex."""
        device = replica.slot.device
        root = self.topo.root_of(device)
        demands = {name: psmodel.Demand(weight=1.0)}
        for bname, bg in self.bg.items():
            if bg.active and bg.spec.pcie_demand > 0 and \
                    self.topo.same_root(bg.slot.device, device):
                demands[bname] = psmodel.Demand(
                    weight=bg.spec.ps_weight,
                    throttle=self._bg_effective_pcie(bg))
        # competing latency tenants' replicas on this root contribute
        # their average offered demand (they are mostly-idle DMA streams,
        # not saturating ones — model them as throttled flows)
        for oname, olt in self.lat.items():
            per_rep = (olt.spec.rate * olt.spec.mean_size /
                       max(1, len(olt.replicas)))
            for j, orep in enumerate(olt.replicas):
                if orep is replica:
                    continue
                if self.topo.same_root(orep.slot.device, device):
                    demands[f"{oname}/r{j}"] = psmodel.Demand(
                        weight=1.0, throttle=per_rep)
        amb = self._ambient_pcie(root)
        if amb > 0:
            demands["ambient"] = psmodel.Demand(weight=1.0, throttle=amb)
        return psmodel.ps_shares_waterfill(demands,
                                           self.p.pcie_capacity)[name]

    def _compute(self, lt: _LatencyTenant, replica: _Replica) -> float:
        units = lt.profile.compute_units
        spec = lt.spec
        c = spec.c0_s * (spec.ref_units / units) ** spec.gamma
        # MIG isolates SMs but HBM bandwidth is partially shared; bigger
        # slices own more of the HBM and suffer less.
        sensitivity = max(0.0, 1.0 - units / 7.0)
        device = replica.slot.device
        hot = [bg for bg in self.bg.values()
               if bg.active and bg.spec.sm_util > 0
               and bg.slot.device == device]
        if hot:
            quota = max(bg.mps_quota for bg in hot)
            c *= 1.0 + self.p.hbm_interference * quota * sensitivity
        elif device not in self.p.home_devices:
            # ambient co-tenants on the rest of the shared cluster
            c *= 1.0 + self.p.ambient_hbm * sensitivity
        return c

    def _irq_noise(self) -> bool:
        return any(bg.active and bg.spec.io_demand > 0
                   for bg in self.bg.values())

    def _service_time(self, name: str, replica: _Replica,
                      size: float) -> float:
        lt = self.lat[name]
        b = self._bandwidth(name, replica)
        c = self._compute(lt, replica)
        # batch-aware: extra in-flight requests on this replica inflate the
        # per-request compute component (continuous-batching slowdown)
        c *= 1.0 + lt.spec.batch_penalty * max(0, replica.in_service - 1)
        eps = self.rng.lognormal(math.log(self.p.noise_mu_s),
                                 self.p.noise_sigma)
        if not lt.pinned and self._irq_noise():
            eps *= self.p.irq_noise_mult   # IRQ jitter until pinned away
        return psmodel.latency(c, size, b, eps)

    # ------------------------------------------------------------- events
    def _push(self, time: float, kind: str, **payload) -> None:
        heapq.heappush(self.events,
                       _Event(time, next(self._eseq), kind, payload))

    def _pause(self, tenant: str, pause: float) -> None:
        lt = self.lat[tenant]
        lt.paused_until = max(lt.paused_until, self.now + pause)
        lt.pause_total += pause
        self._push(lt.paused_until, "resume", tenant=tenant)

    def _draw_size(self, lt: _LatencyTenant) -> float:
        return float(self.rng.choice(lt._size_vals, p=lt._size_probs))

    def _start_service(self, name: str, ridx: int, arrival: float,
                       size: float) -> None:
        replica = self.lat[name].replicas[ridx]
        replica.in_service += 1
        dur = self._service_time(name, replica, size)
        self._push(self.now + dur, "complete", tenant=name, replica=ridx,
                   arrival=arrival)

    def _drain(self, name: str, ridx: int) -> None:
        lt = self.lat[name]
        if self.now < lt.paused_until:
            return
        replica = lt.replicas[ridx]
        while replica.queue and replica.in_service < lt.spec.max_batch:
            arrival, size = replica.queue.popleft()
            self._start_service(name, ridx, arrival, size)

    def _dispatch(self, name: str, size: float) -> None:
        """Least-loaded replica dispatch."""
        lt = self.lat[name]
        ridx = min(range(len(lt.replicas)),
                   key=lambda i: (lt.replicas[i].load, i))
        replica = lt.replicas[ridx]
        if replica.in_service < lt.spec.max_batch and not replica.queue:
            self._start_service(name, ridx, self.now, size)
        else:
            replica.queue.append((self.now, size))

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Snapshot:
        tenants: Dict[str, TenantSignals] = {}
        for name, lt in self.lat.items():
            tenants[name] = TenantSignals(
                p95=lt.window.quantile(0.95, self.now),
                p99=lt.window.quantile(0.99, self.now),
                p999=lt.window.quantile(0.999, self.now),
                miss_rate=lt.window.miss_rate(lt.spec.slo_s, self.now),
                rps=sum(1 for t in lt.completions
                        if t >= self.now - 10.0) / 10.0,
            )
        sys = SystemSignals()
        for root in self.topo.roots():
            v = self._ambient_pcie(root)
            for bg in self.bg.values():
                if self.topo.root_of(bg.slot.device) == root:
                    v += self._bg_effective_pcie(bg)
            for lt in self.lat.values():
                per_rep = (lt.spec.rate * lt.spec.mean_size /
                           max(1, len(lt.replicas)))
                v += per_rep * sum(
                    1 for r in lt.replicas
                    if self.topo.root_of(r.slot.device) == root)
            sys.pcie_bytes[root] = v
        for numa in self.topo.numas():
            total = 0.0
            for bg in self.bg.values():
                if self.topo.numa_of(bg.slot.device) != numa:
                    continue
                io = bg.spec.io_demand if bg.active else 0.0
                if bg.io_throttle is not None and bg.active:
                    io = min(io, bg.io_throttle)
                total += io
            sys.host_io[numa] = total
        for dev in self.topo.devices():
            util = [bg.spec.sm_util * bg.mps_quota for bg in self.bg.values()
                    if bg.active and bg.spec.sm_util > 0
                    and bg.slot.device == dev]
            sys.sm_util[dev] = max(util) if util else 0.1
        for bg in self.bg.values():
            if bg.spec.io_demand > 0:
                host = f"h{self.topo.host_of(bg.slot.device)}"
                rate = 30_000.0 if bg.active else 500.0
                sys.irq_rate[host] = max(sys.irq_rate.get(host, 0.0), rate)
        return Snapshot(self.now, tenants, sys)

    # ----------------------------------------------------------------- run
    def run(self) -> SimResult:
        import time as _time
        p = self.p
        if self._controller_factory is not None:
            self.controller = self._controller_factory(self)
        # seed arrivals / schedule / sampling
        for name, lt in self.lat.items():
            self._push(self.rng.exponential(1.0 / lt.spec.rate), "arrival",
                       tenant=name)
        for w in p.schedule:
            self._push(w.start, "toggle", tenant=w.tenant, on=True)
            self._push(w.end, "toggle", tenant=w.tenant, on=False)
        if self.controller is not None:
            self._push(p.sample_period_s, "sample")
        ctl_cpu = 0.0
        tick_s: List[float] = []    # controller wall-clock per sample tick

        while self.events:
            ev = heapq.heappop(self.events)
            if ev.time > p.duration_s:
                break
            self.now = ev.time
            if ev.kind == "arrival":
                name = ev.payload["tenant"]
                lt = self.lat[name]
                lt.offered += 1
                size = self._draw_size(lt)
                if self.now < lt.paused_until:
                    # load-shed during reconfig/move (503-style): counts
                    # against throughput, not latency
                    lt.dropped += 1
                else:
                    self._dispatch(name, size)
                self._push(self.now +
                           self.rng.exponential(1.0 / lt.spec.rate),
                           "arrival", tenant=name)
            elif ev.kind == "complete":
                name = ev.payload["tenant"]
                ridx = ev.payload["replica"]
                lt = self.lat[name]
                lat = self.now - ev.payload["arrival"]
                lt.window.observe(self.now, lat, slo=lt.spec.slo_s)
                lt.all_latencies.append(lat)
                lt.completions.append(self.now)
                lt.completed += 1
                lt.replicas[ridx].in_service -= 1
                self._drain(name, ridx)
            elif ev.kind == "resume":
                name = ev.payload["tenant"]
                for i in range(len(self.lat[name].replicas)):
                    self._drain(name, i)
            elif ev.kind == "toggle":
                bg = self.bg.get(ev.payload["tenant"])
                if bg is not None:
                    bg.active = ev.payload["on"]
            elif ev.kind == "sample":
                t0 = _time.perf_counter()
                self.controller.on_snapshot(self.snapshot())
                dt = _time.perf_counter() - t0
                ctl_cpu += dt
                tick_s.append(dt)
                self._push(self.now + p.sample_period_s, "sample")

        per_tenant: Dict[str, TenantSimResult] = {}
        for name, lt in self.lat.items():
            lats = np.asarray(lt.all_latencies)
            per_tenant[name] = TenantSimResult(
                latencies=lats,
                miss_rate=(float(np.mean(lats > lt.spec.slo_s))
                           if lats.size else 0.0),
                p95=float(np.quantile(lats, 0.95)) if lats.size else 0.0,
                p99=float(np.quantile(lats, 0.99)) if lats.size else 0.0,
                p999=float(np.quantile(lats, 0.999)) if lats.size else 0.0,
                completed=lt.completed,
                offered=lt.offered,
                dropped=lt.dropped,
                throughput_rps=lt.completed / p.duration_s,
                slo_s=lt.spec.slo_s,
                replicas=len(lt.replicas),
            )
        prim = per_tenant[self.primary]
        actions = (self.controller.audit.counts()
                   if self.controller is not None else {})
        arb = getattr(self.controller, "arbiter", None)
        return SimResult(
            latencies=prim.latencies,
            miss_rate=prim.miss_rate,
            p95=prim.p95,
            p99=prim.p99,
            p999=prim.p999,
            completed=prim.completed,
            offered=prim.offered,
            dropped=prim.dropped,
            throughput_rps=prim.throughput_rps,
            actions=actions,
            reconfig_times=self.reconfig_times,
            controller_cpu_frac=ctl_cpu / p.duration_s,
            timeline=self.timeline,
            tenants=per_tenant,
            aggregate_rps=sum(t.throughput_rps for t in per_tenant.values()),
            arbiter_max_units=arb.max_used() if arb is not None else 0,
            arbiter_budget=arb.budget if arb is not None else 7,
            controller_ticks=len(tick_s),
            controller_tick_ms_mean=(float(np.mean(tick_s)) * 1e3
                                     if tick_s else 0.0),
            controller_tick_ms_max=(float(np.max(tick_s)) * 1e3
                                    if tick_s else 0.0),
        )
