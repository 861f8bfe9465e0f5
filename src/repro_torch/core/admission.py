"""Admission control (paper §2.3): "In cases where no safe placement can be
found for a new tenant without violating the SLOs of existing tenants, an
admission control mechanism will queue or reject the new workload."

Registry-driven: a new workload arrives as a TenantSpec; admission scores
candidate slots with the *same* PCIe-aware placement scorer the controller
uses (core/placement.py), reads occupancy/headroom/fabric load from the
shared DeviceLedger, and — on admit — commits the placement: the spec
joins the TenantRegistry (with its chosen slot keys pinned, so a later
``resolve_placements`` over the expanded registry is stable) and the
ledger is updated.  Safety is assessed with the paper's formal substrate:

  * Claim-1 stability — the new tenant's sustained demand must keep
    sum_j g_j < B on every fabric (PCIe root complex) it touches;
  * Kingman guidance — predicted utilisation rho must stay below a
    conservative bound, both for the newcomer itself and for every
    existing latency-sensitive tenant whose fabric share would shrink;
  * unit feasibility — the new tenant's slice must fit the per-GPU
    compute-unit budget the ledger tracks.

QUEUE'd tenants are retried (``retry_queued``) whenever capacity frees —
a departure releases its ledger slots and the next retry admits.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.ledger import DeviceLedger
from repro_torch.core.placement import PlacementWeights, rank_candidates
from repro_torch.core.profiles import A100_MIG, ProfileLattice
from repro_torch.core.signals import Snapshot, SystemSignals
from repro_torch.core.tenancy import TenantRegistry, TenantSpec
from repro_torch.core.topology import ClusterTopology, Slot


class AdmissionVerdict(enum.Enum):
    ADMIT = "admit"
    QUEUE = "queue"
    REJECT = "reject"


@dataclass(frozen=True)
class AdmissionConfig:
    fabric_capacity: float = 25e9     # per root complex (PCIe gen4 x16-ish)
    rho_bound: float = 0.85           # conservative utilisation bound
    max_queue: int = 8


@dataclass
class RateLimiter:
    """Per-tenant token bucket for *request-plane* admission.

    The tenant-plane controller above admits whole workloads; the gateway
    needs the same Kingman safety argument applied per request.  A bucket
    built by :meth:`kingman` refills at exactly the arrival rate that
    keeps the tenant's predicted utilisation rho = lambda E[S] at the
    configured bound — requests beyond that rate are the ones the G/G/1
    analysis says would blow up the queue, so the gateway REJECTs them
    fast (the 429 path) instead of letting them rot in a deadline queue.
    """
    rate: float                 # sustained tokens (requests) per second
    burst: float = 8.0          # bucket depth: tolerated arrival burst
    tokens: float = field(default=-1.0)
    _t: float = 0.0             # last refill time

    def __post_init__(self) -> None:
        if self.tokens < 0:
            self.tokens = self.burst

    def allow(self, now: float) -> bool:
        """Consume one token if available (refilling first)."""
        if now > self._t:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t) * self.rate)
            self._t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    @classmethod
    def kingman(cls, spec: "TenantSpec",
                cfg: AdmissionConfig = AdmissionConfig(), *,
                n_flows: int = 1, burst: float = 8.0) -> "RateLimiter":
        """Bucket whose sustained rate holds rho at ``cfg.rho_bound``.

        Uses the same service-time estimate as the tenant-plane
        controller (E[S] = c0 + size/share under a fair fabric share
        split ``n_flows`` ways), so the per-request limit and the
        placement-time safety check agree about what "too fast" means.
        """
        share = cfg.fabric_capacity / max(1, n_flows)
        es = spec.c0_s + spec.mean_size / max(share, 1e-9)
        return cls(rate=cfg.rho_bound / max(es, 1e-9), burst=burst)


@dataclass
class AdmissionRecord:
    """One line of the admission audit trail."""
    time: float
    tenant: str
    verdict: AdmissionVerdict
    slots: Tuple[str, ...] = ()
    reason: str = ""


class AdmissionController:
    """Admit/queue/reject new TenantSpecs against the shared ledger."""

    def __init__(self, topo: ClusterTopology, registry: TenantRegistry,
                 ledger: DeviceLedger,
                 cfg: AdmissionConfig = AdmissionConfig(), *,
                 lattice: ProfileLattice = A100_MIG,
                 weights: PlacementWeights = PlacementWeights(),
                 tracer=None):
        self.topo = topo
        self.registry = registry
        self.ledger = ledger
        self.cfg = cfg
        self.lattice = lattice
        self.weights = weights
        self.queue: List[TenantSpec] = []
        self.records: List[AdmissionRecord] = []
        # core.obs.Tracer (or None): tenant-plane verdicts land as
        # instants on the controller track alongside actuator actions
        self.tracer = tracer

    def _record(self, rec: AdmissionRecord) -> None:
        self.records.append(rec)
        if self.tracer is not None:
            self.tracer.instant(
                f"admission:{rec.verdict.value}", rec.time,
                track="controller", lane=rec.tenant,
                slots=list(rec.slots), reason=rec.reason)

    # ------------------------------------------------------------- scoring
    def _snapshot(self, now: float) -> Snapshot:
        """Ledger-derived system view for the placement scorer (the live
        controller passes its smoothed telemetry instead)."""
        sys = SystemSignals(
            pcie_bytes={r: self.ledger.root_demand(r)
                        for r in self.topo.roots()})
        return Snapshot(now, {}, sys)

    def _demand_of(self, spec: TenantSpec, n_replicas: int) -> float:
        """Per-replica sustained fabric demand (bytes/s)."""
        if spec.is_latency:
            return spec.rate * spec.mean_size / max(1, n_replicas)
        return spec.pcie_demand

    def _units_of(self, spec: TenantSpec) -> int:
        if not spec.is_latency:
            return spec.units
        return DeviceLedger._profile_units(self.lattice, spec.profile)

    def _service_estimate(self, spec: TenantSpec, share: float) -> float:
        """E[S] under a given fabric share (compute + transfer)."""
        return spec.c0_s + spec.mean_size / max(share, 1e-9)

    def _rho_ok(self, spec: TenantSpec, root: str, extra_flows: int) -> bool:
        """Kingman guidance: with ``extra_flows`` new PS flows on ``root``,
        every resident latency tenant — and the newcomer itself — must
        keep rho = lambda E[S] below the bound."""
        resident = self.ledger.latency_on_root(root)
        n = max(1, len(resident))
        share_after = self.cfg.fabric_capacity / (n + extra_flows)
        for entry in resident:
            if entry.tenant not in self.registry:
                continue
            t = self.registry[entry.tenant]
            if not t.is_latency:
                continue
            lam = t.rate / max(1, t.replicas)
            if lam * self._service_estimate(t, share_after) \
                    > self.cfg.rho_bound:
                return False
        if spec.is_latency:
            lam = spec.rate / max(1, spec.replicas)
            if lam * self._service_estimate(spec, share_after) \
                    > self.cfg.rho_bound:
                return False
        return True

    def safe_slots_for(self, spec: TenantSpec,
                       snap: Optional[Snapshot] = None,
                       now: float = 0.0) -> Optional[List[Slot]]:
        """A full replica set of safe slots (scorer-ranked), or None.

        Slots are claimed tentatively while iterating so multi-replica
        tenants account for their own earlier replicas' demand and units.
        """
        want = spec.replicas if spec.is_latency else 1
        units = self._units_of(spec)
        demand = self._demand_of(spec, want)
        snap = snap if snap is not None else self._snapshot(now)
        ranked = rank_candidates(self.topo, self.ledger.free_slots(), snap,
                                 self.weights)
        chosen: List[Slot] = []
        extra_units: Dict[str, int] = {}      # device -> tentative units
        extra_demand: Dict[str, float] = {}   # root -> tentative demand
        extra_flows: Dict[str, int] = {}      # root -> tentative PS flows
        for slot, _score in ranked:
            dev = slot.device
            root = self.topo.root_of(dev)
            # unit feasibility under the per-GPU budget
            if self.ledger.headroom_units(dev) - extra_units.get(dev, 0) \
                    < units:
                continue
            # Claim-1: aggregate sustained demand stays under capacity
            load = self.ledger.root_demand(root) + extra_demand.get(root, 0.0)
            if load + demand >= self.cfg.fabric_capacity:
                continue
            # Kingman: bounded rho for residents and for the newcomer
            if not self._rho_ok(spec, root, 1 + extra_flows.get(root, 0)):
                continue
            chosen.append(slot)
            extra_units[dev] = extra_units.get(dev, 0) + units
            extra_demand[root] = extra_demand.get(root, 0.0) + demand
            extra_flows[root] = extra_flows.get(root, 0) + 1
            if len(chosen) == want:
                return chosen
        return None

    # ------------------------------------------------------------ verdicts
    def _commit(self, spec: TenantSpec, slots: List[Slot]) -> TenantSpec:
        """Admit: pin the placement into the registry + ledger."""
        placed = spec.with_(placement=tuple(s.key for s in slots))
        self.registry.add(placed)
        units = self._units_of(spec)
        demand = self._demand_of(spec, len(slots))
        for i, s in enumerate(slots):
            self.ledger.occupy(spec.name, s, units, replica=i,
                               demand=demand, role=spec.role)
        return placed

    def decide(self, spec: TenantSpec, snap: Optional[Snapshot] = None,
               now: float = 0.0
               ) -> Tuple[AdmissionVerdict, Optional[List[Slot]]]:
        if spec.name in self.registry:
            raise ValueError(f"tenant {spec.name!r} already admitted")
        if any(q.name == spec.name for q in self.queue):
            raise ValueError(f"tenant {spec.name!r} already queued")
        slots = self.safe_slots_for(spec, snap, now)
        if slots is not None:
            self._commit(spec, slots)
            self._record(AdmissionRecord(
                now, spec.name, AdmissionVerdict.ADMIT,
                tuple(s.key for s in slots)))
            return AdmissionVerdict.ADMIT, slots
        if len(self.queue) < self.cfg.max_queue:
            self.queue.append(spec)
            self._record(AdmissionRecord(
                now, spec.name, AdmissionVerdict.QUEUE,
                reason="no safe placement"))
            return AdmissionVerdict.QUEUE, None
        self._record(AdmissionRecord(
            now, spec.name, AdmissionVerdict.REJECT, reason="queue full"))
        return AdmissionVerdict.REJECT, None

    def retry_queued(self, snap: Optional[Snapshot] = None, now: float = 0.0
                     ) -> List[Tuple[TenantSpec, List[Slot]]]:
        """Re-score the queue (call when capacity frees); admits in FIFO
        order, leaves the rest queued."""
        admitted: List[Tuple[TenantSpec, List[Slot]]] = []
        still: List[TenantSpec] = []
        for spec in self.queue:
            if spec.name in self.registry:   # admitted out-of-band: drop
                continue
            slots = self.safe_slots_for(spec, snap, now)
            if slots is not None:
                placed = self._commit(spec, slots)
                self._record(AdmissionRecord(
                    now, spec.name, AdmissionVerdict.ADMIT,
                    tuple(s.key for s in slots), reason="retry"))
                admitted.append((placed, slots))
            else:
                still.append(spec)
        self.queue = still
        return admitted

    def release(self, name: str, now: float = 0.0) -> None:
        """Tenant departure: free its ledger slots, registry entry, and
        any still-queued copy."""
        self.ledger.release(name)
        if name in self.registry:
            self.registry.remove(name)
        self.queue = [q for q in self.queue if q.name != name]

    # --------------------------------------------------------------- audit
    def counts(self) -> Dict[str, int]:
        out = {v.value: 0 for v in AdmissionVerdict}
        for r in self.records:
            out[r.verdict.value] += 1
        return out
