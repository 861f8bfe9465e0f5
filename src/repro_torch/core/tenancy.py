"""Tenant identity as data: TenantSpec / TenantRegistry, and the shared
placement/MIG arbiter that resolves conflicting isolation upgrades under a
cluster-wide per-GPU compute-unit budget.

The seed reproduction hard-coded the paper's evaluation shape — exactly one
latency-sensitive tenant ("T1") against two fixed interferers — into the
simulator's attributes and the controller's assumptions.  This module makes
the tenant set a first-class value: any number of latency-sensitive SLO
tenants, each with R >= 1 batched replicas, plus any number of background
interferers, all described by specs and driven through the same controller.
This is the regime studied by MIG-serving (arXiv:2109.11067) and ParvaGPU
(arXiv:2409.14447), where reconfiguration must arbitrate *between*
competing SLO tenants rather than shield a single one.

Layout of a slot key: ``"h0:g3:s1"`` = host 0, device g3, slot index 1 —
the same string `Slot.key` produces.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.profiles import ProfileLattice, SliceProfile
from repro_torch.core.topology import ClusterTopology, Slot

LATENCY = "latency"
BACKGROUND = "background"


@dataclass(frozen=True)
class TenantSpec:
    """Everything the stack needs to know about one tenant.

    Latency tenants use the workload block (rate/SLO/size mix/compute law)
    and run ``replicas`` serving instances, each on its own placement slot
    with up to ``max_batch`` requests in flight.  Background tenants use
    the interference block (PCIe/IO/SM demands) and are the targets of the
    controller's guardrails.
    """
    name: str
    role: str = LATENCY
    priority: float = 1.0          # arbiter weight (higher wins conflicts)
    replicas: int = 1
    # --- workload (latency tenants) ---
    rate: float = 12.0             # Poisson arrivals /s (tenant aggregate)
    slo_s: float = 0.015
    sizes: Tuple[Tuple[float, float], ...] = ((1.0, 12e6),)  # (prob, bytes)
    c0_s: float = 0.007            # compute at the reference profile
    ref_units: int = 2
    gamma: float = 0.35            # compute ~ (ref/units)^gamma
    profile: str = "2g.20gb"       # initial isolation profile
    max_batch: int = 1             # per-replica concurrent requests
    batch_penalty: float = 0.20    # service inflation per extra in-flight req
    # --- interference (background tenants) ---
    pcie_demand: float = 0.0       # bytes/s on the root complex when active
    ps_weight: float = 1.0         # PS-fabric weight (DMA queues/streams)
    io_demand: float = 0.0         # host block-I/O bytes/s when active
    sm_util: float = 0.0           # SM occupancy on its device when active
    units: int = 0                 # compute units it pins on its device
    throttle_residual: float = 0.7  # PCIe demand surviving an io.max cap
    # --- placement (slot keys; empty = auto-placed) ---
    placement: Tuple[str, ...] = ()

    @property
    def is_latency(self) -> bool:
        return self.role == LATENCY

    @property
    def mean_size(self) -> float:
        return sum(p * s for p, s in self.sizes)

    def with_(self, **kw) -> "TenantSpec":
        return replace(self, **kw)


def parse_slot_key(topo: ClusterTopology, key: str) -> Slot:
    """Inverse of Slot.key: "h0:g3:s1" -> Slot(0, "h0:g3", 1)."""
    device, _, sidx = key.rpartition(":s")
    return Slot(topo.host_of(device), device, int(sidx))


class TenantRegistry:
    """Ordered, named collection of TenantSpecs + placement resolution."""

    def __init__(self, specs: Iterable[TenantSpec] = ()):
        self._specs: Dict[str, TenantSpec] = {}
        for s in specs:
            self.add(s)

    # ----------------------------------------------------------- container
    def add(self, spec: TenantSpec) -> "TenantRegistry":
        if spec.name in self._specs:
            raise ValueError(f"duplicate tenant {spec.name!r}")
        self._specs[spec.name] = spec
        return self

    def remove(self, name: str) -> TenantSpec:
        """Retire a tenant (admission churn: departures free their slots)."""
        return self._specs.pop(name)

    def __iter__(self) -> Iterator[TenantSpec]:
        return iter(self._specs.values())

    def __len__(self) -> int:
        return len(self._specs)

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def __getitem__(self, name: str) -> TenantSpec:
        return self._specs[name]

    def names(self) -> List[str]:
        return list(self._specs)

    def latency(self) -> List[TenantSpec]:
        return [s for s in self if s.is_latency]

    def background(self) -> List[TenantSpec]:
        return [s for s in self if not s.is_latency]

    # ---------------------------------------------------------- placement
    def resolve_placements(self, topo: ClusterTopology
                           ) -> Dict[str, List[Slot]]:
        """Fixed placements first, then deterministic auto-placement of the
        remaining replicas: spread across PCIe roots/devices round-robin so
        co-tenancy (the thing the controller manages) isn't accidental."""
        out: Dict[str, List[Slot]] = {}
        taken = set()
        todo: List[Tuple[TenantSpec, int]] = []   # (spec, replicas to place)
        for spec in self:
            want = spec.replicas if spec.is_latency else max(
                1, len(spec.placement))
            slots = [parse_slot_key(topo, k) for k in spec.placement[:want]]
            for s in slots:
                if s.key in taken:
                    raise ValueError(f"slot {s.key} double-assigned "
                                     f"(tenant {spec.name})")
                taken.add(s.key)
            out[spec.name] = slots
            if len(slots) < want:
                todo.append((spec, want - len(slots)))
        if todo:
            # interleave devices across roots: r0 of each host, r1, ...
            devices = sorted(topo.devices(),
                             key=lambda d: (topo.root_of(d), d))
            by_root: Dict[str, List[str]] = {}
            for d in devices:
                by_root.setdefault(topo.root_of(d), []).append(d)
            roots = sorted(by_root)
            order: List[Slot] = []
            for idx in range(topo.slots_per_device):
                for pos in range(max(len(v) for v in by_root.values())):
                    for r in roots:
                        devs = by_root[r]
                        if pos < len(devs):
                            d = devs[pos]
                            order.append(Slot(topo.host_of(d), d, idx))
            free = iter([s for s in order if s.key not in taken])
            for spec, n in todo:
                for _ in range(n):
                    try:
                        s = next(free)
                    except StopIteration:
                        raise ValueError(
                            f"cluster out of slots placing {spec.name}")
                    taken.add(s.key)
                    out[spec.name].append(s)
        return out

    # ----------------------------------------------------------- builders
    @classmethod
    def paper_default(cls, params) -> "TenantRegistry":
        """The paper's 3-tenant evaluation scenario (§3.3.1) expressed as
        data: one latency-sensitive inference tenant against a
        bandwidth-heavy ETL tenant on its PCIe root and a compute-heavy
        trainer on its GPU.  Field values come from SimParams so the E1/E2
        calibration is unchanged."""
        return cls([
            TenantSpec(
                name="T1", role=LATENCY, priority=1.0, replicas=1,
                rate=params.t1_rate, slo_s=params.t1_slo_s,
                sizes=tuple(params.t1_sizes), c0_s=params.t1_c0_s,
                ref_units=params.t1_ref_units, gamma=params.t1_gamma,
                profile="2g.20gb", max_batch=1,
                placement=("h0:g0:s0",)),
            TenantSpec(
                name="T2", role=BACKGROUND, profile="7g.80gb",
                pcie_demand=params.t2_pcie_demand,
                ps_weight=params.t2_ps_weight,
                io_demand=params.t2_io_demand,
                throttle_residual=params.t2_throttle_residual,
                units=0,                      # folded into the device model
                placement=("h0:g1:s0",)),
            TenantSpec(
                name="T3", role=BACKGROUND, profile="2g.20gb",
                sm_util=params.t3_sm_util, units=params.t3_units,
                placement=("h0:g0:s1",)),
        ])

    @classmethod
    def slo_fleet(cls, n_tenants: int, replicas: int = 1, *,
                  base_rate: float = 6.0, slo_s: float = 0.015,
                  profile: str = "2g.20gb", max_batch: int = 1,
                  priorities: Optional[Sequence[float]] = None,
                  with_interferers: bool = True,
                  etl_demand: float = 20e9, trainer_sm: float = 0.95,
                  ) -> "TenantRegistry":
        """N competing SLO tenants (the multi-tenant regime), optionally
        with the paper's two interferer classes.  Priorities default to a
        mild gradient so arbitration order is exercised."""
        reg = cls()
        for i in range(n_tenants):
            pr = (priorities[i] if priorities is not None
                  else 1.0 + 0.25 * (n_tenants - 1 - i))
            reg.add(TenantSpec(
                name=f"L{i}", role=LATENCY, priority=pr, replicas=replicas,
                rate=base_rate, slo_s=slo_s, profile=profile,
                max_batch=max_batch,
                sizes=((0.75, 12e6), (0.20, 24e6), (0.05, 32e6))))
        if with_interferers:
            reg.add(TenantSpec(
                name="ETL", role=BACKGROUND, profile="7g.80gb",
                pcie_demand=etl_demand, ps_weight=4.0, io_demand=2.5e9,
                units=0, placement=("h0:g1:s0",)))
            reg.add(TenantSpec(
                name="TRAIN", role=BACKGROUND, profile="2g.20gb",
                sm_util=trainer_sm, units=2, placement=("h0:g0:s1",)))
        return reg


# ======================================================================
# The shared placement/MIG arbiter
# ======================================================================
@dataclass
class ArbiterEntry:
    """One line of the arbiter's audit trail.  ``used_after`` is the
    arbiter's accounting of compute units on ``device`` after the action —
    the e5 budget check asserts used_after <= budget on every entry."""
    time: float
    action: str                    # register|release|grant|deny|move
    tenant: str
    device: str
    units: int                     # units requested / registered / moved
    used_after: int
    budget: int


def lane_weight(priority: float, miss_rate: float) -> float:
    """Priority-weighted urgency of a tenant lane: highest-miss-rate-first
    within a priority class, higher priority classes first overall.  The
    single source for both the controller's mitigation order and the
    arbiter's request ranking."""
    return priority * (1.0 + miss_rate)


@dataclass(frozen=True)
class UpgradeRequest:
    """A tenant lane asking for a bigger slice on its replica devices."""
    tenant: str
    priority: float
    miss_rate: float
    devices: Tuple[str, ...]
    current: SliceProfile
    target: SliceProfile

    @property
    def weight(self) -> float:
        return lane_weight(self.priority, self.miss_rate)


class ComputeArbiter:
    """Cluster-wide compute-unit bookkeeping for latency tenants.

    Each A100-class device exposes ``budget`` (7) compute units.  Every
    latency replica occupies its tenant's profile units on its device; an
    isolation upgrade asks for the delta on *every* device hosting one of
    the tenant's replicas.  When several lanes breach in the same control
    round, `rank()` orders them priority-weighted highest-miss-first and
    grants greedily — the rest are denied (and logged) rather than
    oversubscribing a GPU.
    """

    def __init__(self, lattice: ProfileLattice, budget_per_gpu: int = 7):
        self.lattice = lattice
        self.budget = budget_per_gpu
        self._used: Dict[str, Dict[str, int]] = {}   # device -> owner -> units
        self.log: List[ArbiterEntry] = []

    # -------------------------------------------------------- bookkeeping
    def used(self, device: str) -> int:
        return sum(self._used.get(device, {}).values())

    def headroom(self, device: str) -> int:
        return self.budget - self.used(device)

    def owners(self, device: str) -> Dict[str, int]:
        return dict(self._used.get(device, {}))

    def _log(self, time: float, action: str, tenant: str, device: str,
             units: int) -> None:
        self.log.append(ArbiterEntry(time, action, tenant, device, units,
                                     self.used(device), self.budget))

    def occupy(self, tenant: str, device: str, units: int,
               time: float = 0.0, replica: int = 0) -> None:
        owner = f"{tenant}/r{replica}"
        dev = self._used.setdefault(device, {})
        # check before mutating so a rejected registration leaves the
        # accounting table untouched
        would_use = self.used(device) - dev.get(owner, 0) + units
        if would_use > self.budget:
            raise ValueError(
                f"registering {owner} ({units}u) oversubscribes {device}: "
                f"{would_use}/{self.budget}")
        dev[owner] = units
        self._log(time, "register", tenant, device, units)

    def vacate(self, tenant: str, device: str, time: float = 0.0,
               replica: int = 0) -> None:
        owner = f"{tenant}/r{replica}"
        dev = self._used.get(device, {})
        if owner in dev:
            units = dev.pop(owner)
            self._log(time, "release", tenant, device, units)

    def move(self, tenant: str, src_device: str, dst_device: str,
             units: int, time: float = 0.0, replica: int = 0) -> None:
        self.vacate(tenant, src_device, time, replica)
        owner = f"{tenant}/r{replica}"
        self._used.setdefault(dst_device, {})[owner] = units
        self._log(time, "move", tenant, dst_device, units)

    # -------------------------------------------------------- arbitration
    @staticmethod
    def rank(requests: Sequence[UpgradeRequest]) -> List[UpgradeRequest]:
        return sorted(requests, key=lambda r: (-r.weight, r.tenant))

    def grant(self, req: UpgradeRequest, time: float = 0.0,
              external_headroom: Optional[Dict[str, int]] = None) -> bool:
        """Atomically grant (or deny) an upgrade across all replica
        devices.  ``external_headroom`` lets the caller fold in occupancy
        the arbiter cannot see (ambient co-tenants, background slices) —
        the effective headroom per device is min(arbiter, external)."""
        extra = req.target.compute_units - req.current.compute_units
        if extra <= 0:
            return False
        prefix = f"{req.tenant}/"
        for dev in set(req.devices):
            n_here = sum(1 for o in self._used.get(dev, {})
                         if o.startswith(prefix))
            need = extra * max(1, n_here)
            have = self.headroom(dev)
            if external_headroom is not None and dev in external_headroom:
                have = min(have, external_headroom[dev])
            if need > have:
                self._log(time, "deny", req.tenant, dev, extra)
                return False
        for dev in set(req.devices):
            for owner in list(self._used.get(dev, {})):
                if owner.startswith(prefix):
                    self._used[dev][owner] = req.target.compute_units
            self._log(time, "grant", req.tenant, dev, extra)
        return True

    def set_profile(self, tenant: str, units: int, time: float = 0.0,
                    action: str = "register") -> None:
        """Resync every replica of ``tenant`` to ``units`` (relax path)."""
        for dev, owners in self._used.items():
            hit = False
            for owner in owners:
                if owner.startswith(f"{tenant}/"):
                    owners[owner] = units
                    hit = True
            if hit:
                self._log(time, action, tenant, dev, units)

    # ------------------------------------------------------------- checks
    def max_used(self) -> int:
        """Peak per-GPU occupancy over the whole audit trail."""
        return max((e.used_after for e in self.log), default=0)

    def audit_ok(self) -> bool:
        return all(e.used_after <= e.budget for e in self.log)
