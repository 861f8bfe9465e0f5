"""The multi-tenancy controller (paper §2, Algorithm 1, Figure 1),
generalized to N latency-sensitive tenant lanes.

Integrates: signal smoothing -> per-tenant decision FSMs (dwell/cool-down/
persistence) -> tiered decision space (guardrails -> PCIe-aware placement
-> dynamic MIG/slice reconfiguration) -> execution via an Actuator ->
post-change validation with rollback to last-known-good.

Tenant identity is data, not code: each registered latency tenant gets its
own decision lane (FSM, predictor, throughput baseline, SLO threshold),
while a shared ComputeArbiter resolves conflicting isolation upgrades
under a cluster-wide per-GPU compute-unit budget — priority-weighted,
highest miss-rate first (the multi-SLO-tenant regime of MIG-serving /
ParvaGPU).  With exactly one latency tenant the control law reduces to
the paper's single-T1 loop.

The Actuator abstracts the execution backend: the discrete-event cluster
simulator (faithful reproduction) and the JAX serving stack (engine quotas,
pipeline throttles, slice re-lowering) implement the same protocol.

Ablation flags (enable_mig / enable_placement / enable_guardrails)
reproduce the paper's E2 configurations.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Protocol, Tuple

from repro_torch.core.audit import AuditLog, Decision, TenantConfig
from repro_torch.core.guardrails import GuardrailBounds, GuardrailManager
from repro_torch.core.placement import (PlacementWeights, intra_device_first,
                                  placement_score)
from repro_torch.core.predictor import PredictorConfig, TailTrendPredictor
from repro_torch.core.policy import DecisionFSM, PolicyConfig, Trigger
from repro_torch.core.profiles import ProfileLattice, SliceProfile
from repro_torch.core.optimizer import greedy_upgrade, relax_step
from repro_torch.core.signals import SignalSmoother, Snapshot, TenantSignals
from repro_torch.core.tenancy import (ComputeArbiter, UpgradeRequest,
                                lane_weight)
from repro_torch.core.topology import ClusterTopology, Slot


class Actuator(Protocol):
    def reconfigure(self, tenant: str, profile: SliceProfile) -> float: ...
    def move(self, tenant: str, slot: Slot) -> float: ...
    def set_io_throttle(self, tenant: str, bytes_per_s: Optional[float]) -> None: ...
    def set_mps_quota(self, tenant: str, frac: float) -> None: ...
    def pin_cpu_away_from_irq(self, tenant: str) -> None: ...
    def free_slots(self) -> List[Slot]: ...
    def headroom_units(self, device: str) -> int: ...
    def migrate(self, tenant: str, replica_from: int,
                replica_to: int) -> float: ...


@dataclass(frozen=True)
class ControllerConfig:
    policy: PolicyConfig = field(default_factory=PolicyConfig)
    bounds: GuardrailBounds = field(default_factory=GuardrailBounds)
    weights: PlacementWeights = field(default_factory=PlacementWeights)
    enable_mig: bool = True
    enable_placement: bool = True
    enable_guardrails: bool = True
    placement_improvement: float = 0.25   # min score delta to justify a move
    relax_score_threshold: float = 0.5    # §2.2.1: conservative threshold
    pcie_busy_frac: float = 0.35          # root "hot" above this utilisation
    io_busy_bytes: float = 0.8e9
    fabric_capacity: float = 25e9
    ema_alpha: float = 0.35
    ema_hysteresis: float = 0.02
    units_per_gpu: int = 7                # arbiter budget per device
    # beyond-paper: proactive trend-predictive triggering (paper §5's
    # "richer predictors" future work); structural gates still apply
    proactive: bool = False
    predictor: PredictorConfig = field(default_factory=PredictorConfig)


@dataclass
class TenantState:
    role: str                  # "latency" | "background"
    slot: Slot                 # primary replica's slot
    profile: SliceProfile
    config: TenantConfig
    throttle_level: int = 0    # escalation counter for repeated throttles
    priority: float = 1.0
    slo_s: Optional[float] = None
    replicas: List[Slot] = field(default_factory=list)

    @property
    def devices(self) -> Tuple[str, ...]:
        return tuple(dict.fromkeys(s.device for s in self.replicas))


class Controller:
    def __init__(self, topo: ClusterTopology, lattice: ProfileLattice,
                 actuator: Actuator, cfg: ControllerConfig = ControllerConfig(),
                 primary: Optional[str] = None, tracer=None):
        self.topo = topo
        self.lattice = lattice
        self.actuator = actuator
        self.cfg = cfg
        # core.obs.Tracer (or None): every audited Decision also lands as
        # an instant on the shared "controller" track, so request
        # timelines can be correlated with the control loop's choices
        # (the actuator separately traces the actions it executes)
        self.tracer = tracer
        self._primary = primary            # None: first registered latency
        self.fsms: Dict[str, DecisionFSM] = {}
        self.smoother = SignalSmoother(cfg.ema_alpha, cfg.ema_hysteresis)
        self.guardrails = GuardrailManager(cfg.bounds)
        self.audit = AuditLog()
        self.arbiter = ComputeArbiter(lattice, cfg.units_per_gpu)
        self.tenants: Dict[str, TenantState] = {}
        self._baseline_rps: Dict[str, float] = {}
        self._last_throttle_time: Dict[str, float] = {}
        self.throttle_grace_s = 10.0
        self.cpu_overhead_s = 0.0          # controller's own cost (Table 4)
        self.predictors: Dict[str, TailTrendPredictor] = {}

    # ------------------------------------------------------------ identity
    @property
    def primary(self) -> Optional[str]:
        if self._primary is not None:
            return self._primary
        for name, st in self.tenants.items():
            if st.role == "latency":
                return name
        return None

    @property
    def fsm(self) -> Optional[DecisionFSM]:
        """Primary lane's FSM (single-tenant back-compat)."""
        p = self.primary
        return self.fsms.get(p) if p else None

    def fsm_for(self, tenant: str) -> Optional[DecisionFSM]:
        """One tenant's dwell/cooldown FSM (None if unregistered).  The
        RetryingActuator binds this so its retry cycles respect the same
        hold-still windows the control law does (a cooling-down lane is
        never thrashed by actuator retries)."""
        return self.fsms.get(tenant)

    def latency_tenants(self) -> List[str]:
        return [n for n, st in self.tenants.items() if st.role == "latency"]

    # -------------------------------------------------------------- set-up
    def register_tenant(self, name: str, role: str, slot: Slot,
                        profile: SliceProfile, *, priority: float = 1.0,
                        slo_s: Optional[float] = None,
                        replicas: Optional[List[Slot]] = None) -> None:
        cfg = TenantConfig(profile=profile.name, device=slot.device,
                           slot=slot.index)
        reps = list(replicas) if replicas else [slot]
        self.tenants[name] = TenantState(role, reps[0], profile, cfg,
                                         priority=priority, slo_s=slo_s,
                                         replicas=reps)
        if role == "latency":
            # Per-lane tail threshold: the tenant's SLO, unless the
            # operator explicitly overrode the policy's tau (e.g. the E3
            # sensitivity sweep or a TTFT-domain controller) — an explicit
            # tau applies to every lane.
            policy = self.cfg.policy
            if slo_s is not None and policy.tau_s == PolicyConfig().tau_s:
                policy = replace(policy, tau_s=slo_s)
            self.fsms[name] = DecisionFSM(policy)
            if self.cfg.proactive:
                self.predictors[name] = TailTrendPredictor(self.cfg.predictor)
            for i, s in enumerate(reps):
                self.arbiter.occupy(name, s.device, profile.compute_units,
                                    replica=i)
            self.audit.mark_good(name, cfg)

    def register_registry(self, registry, placements=None) -> None:
        """Register every tenant from a TenantRegistry.  ``placements``
        maps name -> [Slot]; resolved from the registry if omitted."""
        if placements is None:
            placements = registry.resolve_placements(self.topo)
        for spec in registry:
            slots = placements[spec.name]
            self.register_tenant(
                spec.name, spec.role, slots[0], self.lattice[spec.profile],
                priority=spec.priority,
                slo_s=spec.slo_s if spec.is_latency else None,
                replicas=slots)

    # ------------------------------------------------------------- helpers
    def _record(self, decision: Decision) -> Decision:
        """Audit-log a decision and mirror it onto the trace timeline."""
        self.audit.record(decision)
        if self.tracer is not None:
            self.tracer.instant(
                f"decision:{decision.action}", decision.time,
                track="controller", lane=decision.tenant, **decision.args)
        return decision

    def _tau(self, name: str) -> float:
        fsm = self.fsms.get(name)
        return fsm.cfg.tau_s if fsm is not None else self.cfg.policy.tau_s

    def _summary(self, name: str, snap: Snapshot) -> Dict[str, float]:
        t = snap.tenants.get(name)
        root = self.topo.root_of(self.tenants[name].slot.device)
        return {
            "p99": t.p99 if t else 0.0,
            "miss": t.miss_rate if t else 0.0,
            "pcie_root": snap.system.pcie_bytes.get(root, 0.0),
        }

    def _offenders(self, name: str) -> Tuple[Optional[str], Optional[str]]:
        """(bandwidth offender on the tenant's root, compute offender on
        the tenant's device)."""
        prim = self.tenants[name]
        same_root = [
            (n, st) for n, st in self.tenants.items()
            if st.role == "background"
            and self.topo.same_root(st.slot.device, prim.slot.device)]
        comp = next((n for n, st in same_root
                     if st.slot.device == prim.slot.device), None)
        # bandwidth offender: prefer the sibling-device tenant (the
        # ETL/bandwidth class) over a same-device compute tenant
        bw = next((n for n, st in same_root
                   if st.slot.device != prim.slot.device),
                  same_root[0][0] if same_root else None)
        return bw, comp

    def _diagnose(self, name: str, snap: Snapshot) -> str:
        """Root-cause: "pcie_io" vs "compute_mem" (paper §2.3)."""
        prim = self.tenants[name]
        root = self.topo.root_of(prim.slot.device)
        numa = self.topo.numa_of(prim.slot.device)
        pcie = snap.system.pcie_bytes.get(root, 0.0)
        io = snap.system.host_io.get(numa, 0.0)
        if pcie > self.cfg.pcie_busy_frac * self.cfg.fabric_capacity or \
                io > self.cfg.io_busy_bytes:
            return "pcie_io"
        return "compute_mem"

    # ---------------------------------------------------------------- loop
    def on_snapshot(self, raw: Snapshot) -> List[Decision]:
        decisions: List[Decision] = []
        snap = self.smoother.smooth(raw)
        now = snap.time
        self.guardrails.tick(self.actuator, now)

        lanes = [(n, self.tenants[n]) for n in self.latency_tenants()
                 if n in snap.tenants]
        # -------- phase 1: per-lane validation verdicts + gated triggers
        triggered: List[Tuple[str, Trigger, TenantSignals]] = []
        for name, st in lanes:
            tsig = snap.tenants[name]
            fsm = self.fsms[name]
            p99 = tsig.p99

            # throughput budget bookkeeping (T_i >= 0.95 T_base)
            base = max(self._baseline_rps.get(name, 0.0), tsig.rps)
            self._baseline_rps[name] = base
            throughput_ok = (base <= 0 or tsig.rps >=
                             self.cfg.policy.throughput_budget * base)

            # -------- post-change validation / rollback (paper §2.4)
            verdict = fsm.validation_result(p99)
            if verdict is True:
                self.audit.mark_good(name, st.config)
                self.audit.set_validation(True, name)
            elif verdict is False:
                self.audit.set_validation(False, name)
                decisions.append(self._rollback(name, snap))

            trig = fsm.observe(p99, throughput_ok)
            predictor = self.predictors.get(name)
            if trig == Trigger.NONE and predictor is not None \
                    and fsm.phase.value == "monitor":
                # proactive path: act on the predicted breach, same gates
                predictor.update(now, p99)
                if predictor.should_preact(now, p99, self._tau(name),
                                           rps=tsig.rps):
                    trig = Trigger.BREACH
            elif predictor is not None:
                predictor.update(now, p99)
            if trig != Trigger.NONE:
                triggered.append((name, trig, tsig))

        # -------- phase 2: arbitration order across competing lanes
        # (priority-weighted, highest miss-rate first — the shared arbiter
        # then enforces the per-GPU unit budget on each structural grant)
        breaching = [(n, t) for n, trig, t in triggered
                     if trig == Trigger.BREACH]
        breaching.sort(key=lambda nt: (
            -lane_weight(self.tenants[nt[0]].priority, nt[1].miss_rate),
            nt[0]))
        for name, tsig in breaching:
            decisions.extend(self._mitigate(name, snap, tsig.p99))
        for name, trig, tsig in triggered:
            if trig == Trigger.STABLE:
                d = self._relax(name, snap, tsig.p99)
                if d is not None:
                    decisions.append(d)
        return decisions

    # ------------------------------------------------------------- actions
    def _mitigate(self, name: str, snap: Snapshot, p99: float
                  ) -> List[Decision]:
        out: List[Decision] = []
        now = snap.time
        fsm = self.fsms[name]
        cause = self._diagnose(name, snap)
        bw_off, comp_off = self._offenders(name)

        # Tier 1 — guardrails: throttle the offending background tenant for
        # a bounded window Z when PCIe/IO pressure is the diagnosis.
        # Lightweight: not dwell-gated (only structural actions are).
        # Escalation memory (§2.3: "if throttling does not resolve the
        # issue, the controller proceeds to upgrade the tenant's
        # isolation"): once throttling has been tried repeatedly while a
        # structural lever exists, go structural instead.
        structural_available = self.cfg.enable_mig or self.cfg.enable_placement
        throttle_exhausted = (structural_available and bw_off is not None and
                              self.tenants[bw_off].throttle_level >= 3)
        if (self.cfg.enable_guardrails and cause == "pcie_io"
                and bw_off is not None and not throttle_exhausted
                and not self.guardrails.is_throttled(bw_off)
                and not self.guardrails.in_refractory(bw_off, now)):
            st = self.tenants[bw_off]
            lo, hi = self.cfg.bounds.io_throttle
            value = hi if st.throttle_level % 2 == 0 else lo
            st.throttle_level += 1
            self._last_throttle_time[name] = now
            applied = self.guardrails.throttle_io(self.actuator, bw_off,
                                                  value, now)
            out.append(self._record(Decision(
                now, "throttle_io", bw_off, {"bytes_per_s": applied,
                                             "for": name},
                self._summary(name, snap))))
            return out

        # Structural tiers are gated by Algorithm 1's dwell/cool-down and a
        # grace period after a throttle (give the guardrail time to work).
        if not fsm.at_reconfig_boundary() or fsm.is_cooling_down():
            return out
        if (self.cfg.enable_guardrails and bw_off is not None
                and self.guardrails.is_throttled(bw_off)
                and now - self._last_throttle_time.get(name, -1e9)
                < self.throttle_grace_s):
            return out

        # Tier 2/3 — upgrade isolation (placement move first, then slice
        # enlargement; paper §2.2.1 ordering), plus CPU pinning and a
        # stricter MPS quota on the compute offender.
        prim = self.tenants[name]
        before = prim.config.copy()

        if self.cfg.enable_placement:
            need = prim.profile.compute_units
            free = [
                s for s in self.actuator.free_slots()
                # a move carries the tenant's current slice: the target
                # device must have unit headroom for it (intra-device
                # moves keep the same units and are always feasible)
                if s.device == prim.slot.device
                or min(self.actuator.headroom_units(s.device),
                       self.arbiter.headroom(s.device)) >= need]
            ranked = intra_device_first(self.topo, prim.slot, free, snap,
                                        self.cfg.weights)
            cur_score = placement_score(self.topo, prim.slot, snap,
                                        self.cfg.weights)
            if ranked and ranked[0][1] < cur_score - \
                    self.cfg.placement_improvement:
                slot = ranked[0][0]
                old_device = prim.slot.device
                pause = self.actuator.move(name, slot)
                prim.slot = slot
                prim.replicas[0] = slot
                prim.config.device, prim.config.slot = slot.device, slot.index
                self.arbiter.move(name, old_device, slot.device,
                                  prim.profile.compute_units, now, replica=0)
                fsm.action_taken(p99)
                out.append(self._record(Decision(
                    now, "move", name,
                    {"to": slot.key, "score": ranked[0][1],
                     "from_score": cur_score, "pause_s": pause},
                    self._summary(name, snap), before.__dict__,
                    prim.config.copy().__dict__)))
                self._side_effects(out, name, snap, comp_off)
                return out

        if self.cfg.enable_mig:
            devices = prim.devices
            ext = {d: self.actuator.headroom_units(d) for d in devices}
            per_dev = []
            for d in devices:
                n_here = sum(1 for s in prim.replicas if s.device == d)
                have = min(ext[d], self.arbiter.headroom(d))
                per_dev.append(have // max(1, n_here))
            headroom = min(per_dev) if per_dev else 0
            target = greedy_upgrade(self.lattice, prim.profile, headroom)
            if target is not None:
                tsig = snap.tenants.get(name)
                req = UpgradeRequest(
                    tenant=name, priority=prim.priority,
                    miss_rate=tsig.miss_rate if tsig else 0.0,
                    devices=devices, current=prim.profile, target=target)
                if self.arbiter.grant(req, now, external_headroom=ext):
                    pause = self.actuator.reconfigure(name, target)
                    prim.profile = target
                    prim.config.profile = target.name
                    fsm.action_taken(p99)
                    out.append(self._record(Decision(
                        now, "reconfigure", name,
                        {"profile": target.name, "pause_s": pause},
                        self._summary(name, snap), before.__dict__,
                        prim.config.copy().__dict__)))
                    self._side_effects(out, name, snap, comp_off)
                    return out

        # last resort when structural levers are disabled/exhausted:
        # guardrail the compute offender
        if self.cfg.enable_guardrails and comp_off is not None:
            st = self.tenants[comp_off]
            new_q = max(self.cfg.bounds.mps_quota[0],
                        st.config.mps_quota - 0.25)
            if new_q < st.config.mps_quota:
                applied = self.guardrails.set_mps_quota(self.actuator,
                                                        comp_off, new_q)
                st.config.mps_quota = applied
                fsm.action_taken(p99)
                out.append(self._record(Decision(
                    now, "mps", comp_off, {"quota": applied, "for": name},
                    self._summary(name, snap))))
        return out

    def _side_effects(self, out: List[Decision], name: str, snap: Snapshot,
                      comp_off: Optional[str]) -> None:
        """Pin CPU away from IRQ-hot cores + stricter MPS quota (§2.3)."""
        now = snap.time
        prim = self.tenants[name]
        if not prim.config.cpu_pinned_away_from_irq:
            self.actuator.pin_cpu_away_from_irq(name)
            prim.config.cpu_pinned_away_from_irq = True
            out.append(self._record(Decision(
                now, "pin_cpu", name, {}, self._summary(name, snap))))
        if self.cfg.enable_guardrails and comp_off is not None:
            st = self.tenants[comp_off]
            new_q = max(self.cfg.bounds.mps_quota[0],
                        st.config.mps_quota - 0.25)
            if new_q < st.config.mps_quota:
                applied = self.guardrails.set_mps_quota(self.actuator,
                                                        comp_off, new_q)
                st.config.mps_quota = applied
                out.append(self._record(Decision(
                    now, "mps", comp_off, {"quota": applied, "for": name},
                    self._summary(name, snap))))

    def _relax(self, name: str, snap: Snapshot, p99: float
               ) -> Optional[Decision]:
        """Relax isolation when stable (smaller profile whose placement
        score remains below a conservative threshold, §2.2.1)."""
        if not self.cfg.enable_mig:
            return None
        fsm = self.fsms[name]
        if not fsm.at_reconfig_boundary() or fsm.is_cooling_down():
            return None
        prim = self.tenants[name]
        smaller = relax_step(self.lattice, prim.profile)
        if smaller is None:
            return None
        score = placement_score(self.topo, prim.slot, snap, self.cfg.weights)
        if score > self.cfg.relax_score_threshold:
            return None
        before = prim.config.copy()
        pause = self.actuator.reconfigure(name, smaller)
        prim.profile = smaller
        prim.config.profile = smaller.name
        self.arbiter.set_profile(name, smaller.compute_units, snap.time,
                                 action="relax")
        fsm.action_taken(p99)
        return self._record(Decision(
            snap.time, "relax", name,
            {"profile": smaller.name, "pause_s": pause},
            self._summary(name, snap), before.__dict__,
            prim.config.copy().__dict__))

    def _rollback(self, tenant: str, snap: Snapshot) -> Decision:
        prim = self.tenants[tenant]
        good = self.audit.last_known_good(tenant)
        before = prim.config.copy()
        pause = 0.0
        if good is not None:
            if good.profile != prim.config.profile:
                profile = self.lattice[good.profile]
                # restoring a *larger* profile needs the extra units to
                # still be free on every replica device (another lane may
                # have claimed them since): the actuator's ledger enforces
                # the budget, so check before asking
                extra = profile.compute_units - prim.profile.compute_units
                fits = extra <= 0 or all(
                    min(self.actuator.headroom_units(d),
                        self.arbiter.headroom(d))
                    >= extra * sum(1 for s in prim.replicas
                                   if s.device == d)
                    for d in prim.devices)
                if fits:
                    pause += self.actuator.reconfigure(tenant, profile)
                    prim.profile = profile
                    self.arbiter.set_profile(tenant, profile.compute_units,
                                             snap.time, action="rollback")
                else:
                    good = good.copy()
                    good.profile = prim.config.profile
            if (good.device, good.slot) != (prim.config.device,
                                            prim.config.slot):
                slot = Slot(self.topo.host_of(good.device), good.device,
                            good.slot)
                # the old home may have been claimed meanwhile: only move
                # back if the slot is still free and the device still has
                # unit headroom for us
                feasible = (
                    any(s.key == slot.key
                        for s in self.actuator.free_slots())
                    and (slot.device == prim.slot.device or
                         min(self.actuator.headroom_units(slot.device),
                             self.arbiter.headroom(slot.device))
                         >= prim.profile.compute_units))
                if feasible:
                    old_device = prim.slot.device
                    pause += self.actuator.move(tenant, slot)
                    prim.slot = slot
                    prim.replicas[0] = slot
                    self.arbiter.move(tenant, old_device, slot.device,
                                      prim.profile.compute_units, snap.time,
                                      replica=0)
                else:
                    good = good.copy()
                    good.device = prim.config.device
                    good.slot = prim.config.slot
            prim.config = good.copy()
        return self._record(Decision(
            snap.time, "rollback", tenant, {"pause_s": pause},
            self._summary(tenant, snap), before.__dict__,
            prim.config.copy().__dict__))
