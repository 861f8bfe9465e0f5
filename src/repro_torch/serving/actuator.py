"""Serving-side controller actuator: live PyTorch engines + PS fabric (the
twin of ``repro/serving/actuator.py``).

FabricState models the shared PCIe/ICI path with the paper's PS law, now
per-tenant: every latency tenant that still sits on the contended root
complex shares the fabric with the ETL stream *and with each other*, and
cgroup-style io.max throttles are tracked per background tenant (a
throttle aimed at one offender no longer clobbers another's guardrail).
ServingActuator implements the controller Actuator protocol over one or
more live ServingEngines — one engine per tenant-replica, all sharing the
FabricState — mapping quota <-> MPS, io throttle <-> pipeline cap,
move <-> fabric path, reconfigure <-> slice compute scale with a paused
re-lower.  Placement state (slot occupancy, per-GPU unit budget, per-root
demand) lives in a shared DeviceLedger — the same bookkeeping the cluster
simulator reads — so ``free_slots``/``headroom_units`` report real fabric
state instead of constants, and moves/reconfigures are budget-checked.
Used by repro_torch.launch.serve.  ``FabricState`` is the reference's,
unedited; ``ServingActuator`` drives the port's ``ServingEngine``, and its
live lane migration (``migrate``) ships KV pages through the port's
``serving/migrate.py``.

Single-tenant call sites keep working: passing one engine wraps it as
tenant "T1" over a paper-default ledger (T1 on h0:g0:s0 against the
ETL/trainer slots), and the legacy ``compute_scale`` / ``pause_until`` /
``t1_bandwidth`` views read that tenant's state.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.core import psmodel
from repro_torch.core.ledger import DeviceLedger
from repro_torch.core.profiles import A100_MIG
from repro_torch.serving.engine import ServingEngine


@dataclass
class FabricState:
    pcie_capacity: float = 25e9
    t2_demand: float = 20e9
    t2_ps_weight: float = 3.0
    t2_active: bool = False
    throttle_residual: float = 0.6
    on_shared_root: bool = True           # legacy single-tenant flag ("T1")
    # per-tenant root membership: tenant -> still on the contended root
    shared_tenants: Dict[str, bool] = field(default_factory=dict)
    # per-tenant io.max caps (bytes/s, None = uncapped): the guardrail
    # throttles a *specific* background offender, so the caps must not
    # share one global knob
    io_throttles: Dict[str, Optional[float]] = field(default_factory=dict)
    # offered PCIe demand of a sibling latency tenant: they are mostly-
    # idle DMA streams, so they compete as *throttled* flows (the same
    # modelling choice as ClusterSim._bandwidth), not saturating ones
    sibling_demand: float = 5e9

    def set_on_root(self, tenant: str, on: bool) -> None:
        self.shared_tenants[tenant] = on
        if tenant == "T1":
            self.on_shared_root = on

    def _on_root(self, tenant: str) -> bool:
        return self.shared_tenants.get(tenant, self.on_shared_root)

    def set_io_throttle(self, tenant: str,
                        bytes_per_s: Optional[float]) -> None:
        if bytes_per_s is None:
            self.io_throttles.pop(tenant, None)
        else:
            self.io_throttles[tenant] = bytes_per_s

    def io_throttle_of(self, tenant: str) -> Optional[float]:
        return self.io_throttles.get(tenant)

    @property
    def io_throttle(self) -> Optional[float]:
        """Legacy view: the ETL stream's cap."""
        return self.io_throttles.get("T2")

    def bandwidth(self, tenant: str) -> float:
        """PS share of ``tenant`` on its current root complex."""
        demands = {tenant: psmodel.Demand(weight=1.0)}
        if self._on_root(tenant):
            if self.t2_active:
                thr = self.io_throttles.get("T2")
                eff = self.t2_demand if thr is None else \
                    self.t2_demand * self.throttle_residual + thr
                demands["T2"] = psmodel.Demand(weight=self.t2_ps_weight,
                                               throttle=eff)
            # sibling latency tenants still on the shared root compete too
            for other, on in self.shared_tenants.items():
                if on and other != tenant:
                    demands[other] = psmodel.Demand(
                        weight=1.0, throttle=self.sibling_demand)
        else:
            demands["amb"] = psmodel.Demand(weight=1.0, throttle=10e9)
        return psmodel.ps_shares_waterfill(demands,
                                           self.pcie_capacity)[tenant]

    def t1_bandwidth(self) -> float:
        return self.bandwidth("T1")


EngineMap = Dict[str, List[ServingEngine]]


class ServingActuator:
    """Controller Actuator over live engines + the shared fabric model.

    ``engines`` is either a single ServingEngine (wrapped as tenant "T1")
    or a dict tenant -> engine | [engine per replica].  ``ledger`` is the
    shared DeviceLedger placement bookkeeping; when omitted, a paper-
    default ledger is synthesized (each engine tenant auto-placed against
    the ETL/trainer background slots).  ``rng`` seeds the reconfiguration-
    pause draw — pass the run's generator so repeated reconfigs sample
    the paper's 18 +- 6 s distribution instead of one frozen value.
    """

    def __init__(self, engines: Union[ServingEngine, EngineMap],
                 fabric: FabricState, topo, clock, ref_units: int = 2,
                 ledger: Optional[DeviceLedger] = None,
                 rng: Optional[np.random.Generator] = None,
                 tracer: Optional[object] = None):
        if isinstance(engines, ServingEngine):
            engines = {"T1": [engines]}
        # every Actuator protocol method emits exactly one trace event
        # (no silent actions) — asserted by the trace lint test
        self.tracer = tracer
        self.engines: EngineMap = {
            t: list(e) if isinstance(e, (list, tuple)) else [e]
            for t, e in engines.items()}
        self.fabric = fabric
        self.topo = topo
        self.clock = clock
        self.ref_units = ref_units
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.ledger = ledger if ledger is not None else self._default_ledger()
        self.compute_scales: Dict[str, float] = {
            t: 1.0 for t in self.engines}     # MIG-profile compute multiplier
        self.pauses: Dict[str, float] = {t: 0.0 for t in self.engines}
        self.reconfigs: List[float] = []
        # completed migrate() results (dicts), appended per call for the
        # serving loop to pop: the actuator re-homes lanes engine-side
        # but holds no gateway reference, so the caller finishes the
        # request-plane half (warm adoption / cold redrive)
        self.migrations: List[Dict] = []
        # the hot fabric path is the root hosting the heaviest bandwidth
        # (ETL-class) background stream, whatever it is named
        bw = [e for e in self.ledger.entries()
              if e.role != "latency" and e.demand > 0]
        self.contended_root = (
            self.topo.root_of(max(bw, key=lambda e: e.demand).slot.device)
            if bw else "h0:r0")

    def _default_ledger(self) -> DeviceLedger:
        """Paper-default bookkeeping for legacy call sites: engine tenants
        plus the ETL (h0:g1:s0) / trainer (h0:g0:s1) background slots,
        ambient co-tenants on every other device (mirrors SimParams)."""
        from repro_torch.core.tenancy import (BACKGROUND, TenantRegistry,
                                              TenantSpec)
        reg = TenantRegistry()
        single = len(self.engines) == 1
        for name, engs in self.engines.items():
            placement = ("h0:g0:s0",) if single else ()
            reg.add(TenantSpec(name=name, replicas=len(engs),
                               placement=placement))
        if "T2" not in reg:
            reg.add(TenantSpec(name="T2", role=BACKGROUND,
                               profile="7g.80gb", units=0,
                               pcie_demand=self.fabric.t2_demand,
                               placement=("h0:g1:s0",)))
        if "T3" not in reg:
            reg.add(TenantSpec(name="T3", role=BACKGROUND,
                               profile="2g.20gb", units=2,
                               placement=("h0:g0:s1",)))
        return DeviceLedger.from_registry(
            self.topo, reg, A100_MIG,
            home_devices=("h0:g0",), ambient_units=3)

    # ------------------------------------------------- single-tenant views
    @property
    def _first(self) -> str:
        return next(iter(self.engines))

    @property
    def engine(self) -> ServingEngine:
        return self.engines[self._first][0]

    @property
    def compute_scale(self) -> float:
        return self.compute_scales.get("T1",
                                       self.compute_scales[self._first])

    @property
    def pause_until(self) -> float:
        return self.pauses.get("T1", self.pauses[self._first])

    # --------------------------------------------------- per-tenant access
    def tenant_engines(self, tenant: str) -> List[ServingEngine]:
        return self.engines.get(tenant, self.engines[self._first])

    def compute_scale_of(self, tenant: str) -> float:
        return self.compute_scales.get(tenant, 1.0)

    def paused_until(self, tenant: str) -> float:
        return self.pauses.get(tenant, 0.0)

    def _key(self, tenant: str) -> str:
        return tenant if tenant in self.engines else self._first

    def _sync_root_membership(self, tenant: str) -> None:
        on = any(self.topo.root_of(s.device) == self.contended_root
                 for s in self.ledger.slots_of(tenant))
        self.fabric.set_on_root(tenant, on)

    def _trace(self, name: str, tenant, dur: float = 0.0, **args) -> None:
        if self.tracer is not None:
            self.tracer.action(name, self.clock(), str(tenant),
                               dur=dur, **args)

    # ------------------------------------------------------------ Actuator
    def reconfigure(self, tenant, profile):
        pause = max(8.0, self.rng.normal(18.0, 3.0))
        scale = (self.ref_units / profile.compute_units) ** 0.35
        key = self._key(tenant)
        self.ledger.set_units(key, profile.compute_units)   # budget-checked
        self.compute_scales[key] = scale
        self.pauses[key] = max(self.pauses.get(key, 0.0),
                               self.clock() + pause)
        self.reconfigs.append(pause)
        self._trace("reconfigure", key, dur=pause,
                    profile=profile.name, units=profile.compute_units)
        return pause

    def move(self, tenant, slot):
        key = self._key(tenant)
        self.ledger.move(key, 0, slot)                      # budget-checked
        self._sync_root_membership(key)
        self.pauses[key] = max(self.pauses.get(key, 0.0),
                               self.clock() + 2.0)
        self._trace("move", key, dur=2.0, slot=str(slot))
        return 2.0

    def set_io_throttle(self, tenant, bytes_per_s):
        self.fabric.set_io_throttle(tenant, bytes_per_s)
        self._trace("set_io_throttle", tenant, bytes_per_s=bytes_per_s)

    def set_mps_quota(self, tenant, frac):
        for eng in self.tenant_engines(tenant):
            eng.set_quota(max(frac, 0.5))
        self._trace("set_mps_quota", tenant, frac=frac)

    def pin_cpu_away_from_irq(self, tenant):
        self._trace("pin_cpu_away_from_irq", tenant)

    def free_slots(self):
        self._trace("query_free_slots", "")
        return self.ledger.free_slots()

    def headroom_units(self, device: str) -> int:
        self._trace("query_headroom_units", "", device=device)
        return self.ledger.headroom_units(device)

    def _replica_device(self, tenant: str, replica: int) -> Optional[str]:
        for e in self.ledger.entries():
            if e.tenant == tenant and e.replica == replica:
                return e.slot.device
        return None

    def migrate(self, tenant: str, replica_from: int,
                replica_to: int) -> float:
        """Live lane migration: ship ``replica_from``'s resident lanes
        (KV pages + cursors, chain-hashed) to ``replica_to`` and resume
        them there.  The transfer is priced against the ledger's
        per-root fabric demand — migration is PS traffic like any tenant
        flow — and returned as the pause the victim's lanes observe.
        Lanes that fail the importer's verify-then-commit handshake (or
        never held pages) land in the result's ``cold`` list: the caller
        must finish those through ``Gateway.redrive`` — the recompute
        path — so a corrupted transfer degrades to latency,
        never a wrong token.  The engine-side re-homing happens here;
        the request-plane half (warm adoption / cold redrive) is the
        caller's, via the appended ``self.migrations`` record."""
        from repro_torch.serving.migrate import MigrationPlanner, PageImporter
        key = self._key(tenant)
        engs = self.engines[key]
        src, dst = engs[replica_from], engs[replica_to]
        manifests = src.drain_requests(ship_state=True)
        planner = MigrationPlanner(self.fabric, self.topo, self.ledger)
        plan = planner.price(manifests,
                             src_device=self._replica_device(key,
                                                             replica_from),
                             dst_device=self._replica_device(key,
                                                             replica_to))
        warm: List = []
        cold: List = []
        importer = PageImporter(dst.runtime) if dst.runtime is not None \
            else None
        for man in manifests:
            if importer is not None and importer.import_lane(man):
                warm.append(man.req)
            else:
                cold.append(man.req)
        self.migrations.append({
            "tenant": key, "from": replica_from, "to": replica_to,
            "warm": warm, "cold": cold, "transfer_s": plan.transfer_s,
            "pages": plan.pages, "bytes": plan.bytes,
            "attached_pages": importer.attached_pages if importer else 0,
            "copied_pages": importer.copied_pages if importer else 0,
            "verify_failures": importer.verify_failures if importer else 0})
        self._trace("migrate", key, dur=plan.transfer_s,
                    replica_from=replica_from, replica_to=replica_to,
                    lanes=plan.lanes, warm=len(warm), cold=len(cold),
                    pages=plan.pages, bytes=plan.bytes)
        return plan.transfer_s

    # ------------------------------------------------------- KV observability
    def kv_pressure(self, tenant: str) -> Dict[str, float]:
        """Aggregate KV page-pool pressure across a tenant's replicas
        (works on either engine backend; the paged runtime's reserved ==
        live pages, the dense backend reserves prompt+max_new up front).
        Distinguishing reserved from used is what lets admission see
        headroom the dense reservation hides."""
        engs = self.tenant_engines(tenant)
        used = sum(e.metrics.kv_used_pages for e in engs)
        reserved = sum(e.metrics.kv_reserved_pages for e in engs)
        total = sum(e.metrics.kv_total_pages for e in engs)
        return {"used_pages": used, "reserved_pages": reserved,
                "total_pages": total,
                "reserved_frac": reserved / total if total else 0.0,
                "used_frac": used / total if total else 0.0}
