"""DeviceLedger — the shared placement/budget source of truth (paper §2.3).

The paper's controller acts on an explicit model of the fabric: which MIG
slot every tenant-replica occupies, how many of each A100's 7 compute
units are spoken for, and how much sustained DMA demand each PCIe root
complex carries.  "In cases where no safe placement can be found for a new
tenant without violating the SLOs of existing tenants, an admission
control mechanism will queue or reject the new workload" (§2.3) — that
safety judgement, the placement scorer's candidate set, and the
reconfiguration optimizer's headroom all read the *same* bookkeeping.

Before this module, that bookkeeping was triplicated: ClusterSim rescanned
its replica lists, ServingActuator returned hard-coded constants, and the
AdmissionController took ad-hoc mappings.  DeviceLedger owns it once:

  * slot occupancy      — slot key -> owning tenant-replica,
  * per-GPU unit budget — device -> owner -> compute units (<= 7),
  * per-root demand     — root complex -> offered bytes/s per owner.

It is constructed from ``ClusterTopology`` + ``TenantRegistry.
resolve_placements()`` and mutated only through budget-checked operations
(`occupy` / `release` / `move` / `set_units`), so the invariants the
property suite asserts — no slot double-occupied, per-GPU use <= budget,
moves occupancy-conserving, release idempotent — hold by construction.
Both actuators (sim and serving) and the admission controller share one
instance; `view()` returns a canonical snapshot the sim<->serving parity
harness compares step-for-step.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.profiles import ProfileLattice, SliceProfile
from repro_torch.core.topology import ClusterTopology, Slot


@dataclass
class LedgerEntry:
    """One tenant-replica's placement record."""
    tenant: str
    replica: int
    slot: Slot
    units: int                 # compute units pinned on slot.device
    demand: float = 0.0        # sustained bytes/s offered on slot's root
    role: str = "latency"

    @property
    def owner(self) -> str:
        return f"{self.tenant}/r{self.replica}"


class LedgerError(ValueError):
    """A budget-checked operation would violate a ledger invariant."""


class DeviceLedger:
    """Cluster-wide slot/unit/fabric bookkeeping, one instance per cluster.

    ``home_devices`` / ``ambient_units`` mirror the simulator's shared-
    cluster model: devices outside the modelled scenario carry ambient
    co-tenants whose units reduce *headroom* (decision-making) without
    being ledger entries (they are unmodelled, so they never move).  The
    hard budget check on mutations uses only real entries, exactly like
    the ComputeArbiter's accounting.
    """

    def __init__(self, topo: ClusterTopology, budget_per_gpu: int = 7,
                 home_devices: Sequence[str] = (), ambient_units: int = 0):
        self.topo = topo
        self.budget = budget_per_gpu
        self.home_devices = tuple(home_devices)
        self.ambient_units = ambient_units
        self._entries: Dict[str, LedgerEntry] = {}     # owner -> entry
        self._slot_owner: Dict[str, str] = {}          # slot key -> owner

    # ------------------------------------------------------------ builders
    @classmethod
    def from_registry(cls, topo: ClusterTopology, registry,
                      lattice: ProfileLattice,
                      placements: Optional[Mapping[str, List[Slot]]] = None,
                      *, budget_per_gpu: int = 7,
                      home_devices: Sequence[str] = (),
                      ambient_units: int = 0) -> "DeviceLedger":
        """Seed a ledger from a TenantRegistry's resolved placements.

        Latency tenants occupy ``profile`` units per replica and offer
        their mean DMA demand (rate x mean size, split across replicas);
        background tenants occupy ``spec.units`` and offer their
        ``pcie_demand``.
        """
        ledger = cls(topo, budget_per_gpu, home_devices, ambient_units)
        if placements is None:
            placements = registry.resolve_placements(topo)
        for spec in registry:
            slots = placements[spec.name]
            if spec.is_latency:
                units = ledger._profile_units(lattice, spec.profile)
                per_rep = spec.rate * spec.mean_size / max(1, len(slots))
                for i, s in enumerate(slots):
                    ledger.occupy(spec.name, s, units, replica=i,
                                  demand=per_rep, role=spec.role)
            else:
                for i, s in enumerate(slots):
                    ledger.occupy(spec.name, s, spec.units, replica=i,
                                  demand=spec.pcie_demand, role=spec.role)
        return ledger

    @staticmethod
    def _profile_units(lattice: ProfileLattice, name: str) -> int:
        try:
            return lattice[name].compute_units
        except KeyError:       # non-MIG lattice (e.g. TPU slices): 2nd rung
            return lattice.profiles[min(1, len(lattice) - 1)].compute_units

    # ----------------------------------------------------------- mutations
    def occupy(self, tenant: str, slot: Slot, units: int, *,
               replica: int = 0, demand: float = 0.0,
               role: str = "latency") -> LedgerEntry:
        """Claim a slot for one tenant-replica (budget- and slot-checked)."""
        owner = f"{tenant}/r{replica}"
        if owner in self._entries:
            raise LedgerError(f"{owner} already placed at "
                              f"{self._entries[owner].slot.key}")
        holder = self._slot_owner.get(slot.key)
        if holder is not None:
            raise LedgerError(f"slot {slot.key} already occupied by {holder}")
        if self.used_units(slot.device) + units > self.budget:
            raise LedgerError(
                f"placing {owner} ({units}u) oversubscribes {slot.device}: "
                f"{self.used_units(slot.device) + units}/{self.budget}")
        entry = LedgerEntry(tenant, replica, slot, units, demand, role)
        self._entries[owner] = entry
        self._slot_owner[slot.key] = owner
        return entry

    def release(self, tenant: str, replica: Optional[int] = None) -> int:
        """Free a tenant-replica's slot (all replicas when ``replica`` is
        None).  Idempotent: releasing an absent owner is a no-op.  Returns
        the number of entries released."""
        owners = [o for o, e in self._entries.items()
                  if e.tenant == tenant
                  and (replica is None or e.replica == replica)]
        for o in owners:
            entry = self._entries.pop(o)
            self._slot_owner.pop(entry.slot.key, None)
        return len(owners)

    def move(self, tenant: str, replica: int, slot: Slot) -> None:
        """Relocate one replica (occupancy-conserving, budget-checked on
        the destination device, destination slot must be free)."""
        owner = f"{tenant}/r{replica}"
        entry = self._entries.get(owner)
        if entry is None:
            raise LedgerError(f"{owner} is not placed")
        if slot.key == entry.slot.key:
            return
        holder = self._slot_owner.get(slot.key)
        if holder is not None:
            raise LedgerError(f"slot {slot.key} already occupied by {holder}")
        dst_used = sum(e.units for e in self._entries.values()
                       if e.slot.device == slot.device and e is not entry)
        if dst_used + entry.units > self.budget:
            raise LedgerError(
                f"moving {owner} ({entry.units}u) oversubscribes "
                f"{slot.device}: {dst_used + entry.units}/{self.budget}")
        del self._slot_owner[entry.slot.key]
        entry.slot = slot
        self._slot_owner[slot.key] = owner

    def set_units(self, tenant: str, units: int,
                  replica: Optional[int] = None) -> None:
        """Resize a tenant's slices (reconfigure/relax/rollback), budget-
        checked per device with replace semantics."""
        targets = [e for e in self._entries.values()
                   if e.tenant == tenant
                   and (replica is None or e.replica == replica)]
        if not targets:
            raise LedgerError(f"{tenant} is not placed")
        by_dev: Dict[str, int] = {}
        for e in targets:
            by_dev[e.slot.device] = by_dev.get(e.slot.device, 0) + 1
        for dev, n_here in by_dev.items():
            others = sum(e.units for e in self._entries.values()
                         if e.slot.device == dev and e not in targets)
            if others + units * n_here > self.budget:
                raise LedgerError(
                    f"resizing {tenant} to {units}u oversubscribes {dev}: "
                    f"{others + units * n_here}/{self.budget}")
        for e in targets:
            e.units = units

    def set_demand(self, tenant: str, demand: float,
                   replica: Optional[int] = None) -> None:
        for e in self._entries.values():
            if e.tenant == tenant and (replica is None
                                       or e.replica == replica):
                e.demand = demand

    # ------------------------------------------------------------- queries
    def entries(self) -> List[LedgerEntry]:
        return list(self._entries.values())

    def tenants(self) -> List[str]:
        return sorted({e.tenant for e in self._entries.values()})

    def owner_of(self, slot_key: str) -> Optional[str]:
        return self._slot_owner.get(slot_key)

    def slots_of(self, tenant: str) -> List[Slot]:
        return [e.slot for e in sorted(self._entries.values(),
                                       key=lambda e: e.replica)
                if e.tenant == tenant]

    def devices_of(self, tenant: str) -> Tuple[str, ...]:
        return tuple(dict.fromkeys(
            e.slot.device for e in sorted(self._entries.values(),
                                          key=lambda e: e.replica)
            if e.tenant == tenant))

    def free_slots(self) -> List[Slot]:
        return [s for s in self.topo.slots()
                if s.key not in self._slot_owner]

    def used_units(self, device: str) -> int:
        """Units claimed by ledger entries on ``device`` (ambient excluded,
        like the arbiter's accounting)."""
        return sum(e.units for e in self._entries.values()
                   if e.slot.device == device)

    def headroom_units(self, device: str) -> int:
        """Free units available for decisions: budget minus entries minus
        the ambient co-tenants carried by non-home devices."""
        used = self.used_units(device)
        if device not in self.home_devices:
            used += self.ambient_units
        return max(0, self.budget - used)

    def root_demand(self, root: str) -> float:
        """Sustained offered bytes/s on a PCIe root complex."""
        return sum(e.demand for e in self._entries.values()
                   if self.topo.root_of(e.slot.device) == root)

    def latency_on_root(self, root: str) -> List[LedgerEntry]:
        return [e for e in self._entries.values()
                if e.role == "latency"
                and self.topo.root_of(e.slot.device) == root]

    # ---------------------------------------------------------- invariants
    def check(self) -> None:
        """Raise LedgerError if any invariant is violated (the property
        suite calls this after every random operation)."""
        seen: Dict[str, str] = {}
        for owner, e in self._entries.items():
            if owner != e.owner:
                raise LedgerError(f"owner index mismatch: {owner}")
            if e.slot.key in seen:
                raise LedgerError(f"slot {e.slot.key} double-occupied by "
                                  f"{seen[e.slot.key]} and {owner}")
            seen[e.slot.key] = owner
            if self._slot_owner.get(e.slot.key) != owner:
                raise LedgerError(f"slot index out of sync at {e.slot.key}")
        for key in self._slot_owner:
            if key not in seen:
                raise LedgerError(f"dangling slot index entry {key}")
        for dev in {e.slot.device for e in self._entries.values()}:
            if self.used_units(dev) > self.budget:
                raise LedgerError(f"{dev} oversubscribed: "
                                  f"{self.used_units(dev)}/{self.budget}")

    def check_ok(self) -> bool:
        try:
            self.check()
        except LedgerError:
            return False
        return True

    def view(self) -> Dict[str, Dict]:
        """Canonical comparable snapshot for the sim<->serving parity
        harness: occupancy, per-device unit use + headroom, root demand."""
        devices = self.topo.devices()
        return {
            "occupancy": dict(sorted(self._slot_owner.items())),
            "units": {d: self.used_units(d) for d in devices},
            "headroom": {d: self.headroom_units(d) for d in devices},
            "root_demand": {r: round(self.root_demand(r), 3)
                            for r in self.topo.roots()},
        }
