"""Topology-aware placement heuristic (paper §2.2.1).

The score penalises a candidate slot for
  (i)   sharing a PCIe root complex with a bandwidth-heavy tenant,
  (ii)  colocating with a NUMA domain exhibiting high block I/O,
  (iii) recent IRQ bursts on adjacent CPU cores,
and (beyond-paper, for the cluster case) (iv) crossing to another host,
which costs a full state transfer.  Lower is better.  "When upgrading
isolation, we first attempt an intra-GPU move to the least-penalised MIG
instance; only if insufficient do we enlarge the MIG slice."
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.signals import Snapshot
from repro_torch.core.topology import ClusterTopology, Slot


@dataclass(frozen=True)
class PlacementWeights:
    pcie: float = 1.0          # (i) shared busy root complex
    numa_io: float = 0.6       # (ii) NUMA block-I/O pressure
    irq: float = 0.3           # (iii) adjacent IRQ bursts
    cross_host: float = 0.5    # (iv) inter-host move penalty
    # normalisation constants (units -> dimensionless)
    pcie_scale: float = 12.5e9      # bytes/s at which the root is "busy"
    io_scale: float = 2.0e9
    irq_scale: float = 10_000.0


def placement_score(topo: ClusterTopology, slot: Slot, snap: Snapshot,
                    weights: PlacementWeights = PlacementWeights(),
                    current_host: Optional[int] = None) -> float:
    root = topo.root_of(slot.device)
    numa = topo.numa_of(slot.device)
    host = f"h{topo.host_of(slot.device)}"
    s = snap.system
    score = 0.0
    score += weights.pcie * (s.pcie_bytes.get(root, 0.0) / weights.pcie_scale)
    score += weights.numa_io * (s.host_io.get(numa, 0.0) / weights.io_scale)
    score += weights.irq * (s.irq_rate.get(host, 0.0) / weights.irq_scale)
    if current_host is not None and topo.host_of(slot.device) != current_host:
        score += weights.cross_host
    return score


def rank_candidates(topo: ClusterTopology, candidates: Sequence[Slot],
                    snap: Snapshot,
                    weights: PlacementWeights = PlacementWeights(),
                    current_host: Optional[int] = None
                    ) -> List[Tuple[Slot, float]]:
    scored = [(c, placement_score(topo, c, snap, weights, current_host))
              for c in candidates]
    return sorted(scored, key=lambda x: (x[1], x[0].key))


def best_candidate(topo: ClusterTopology, candidates: Sequence[Slot],
                   snap: Snapshot,
                   weights: PlacementWeights = PlacementWeights(),
                   current_host: Optional[int] = None
                   ) -> Optional[Tuple[Slot, float]]:
    ranked = rank_candidates(topo, candidates, snap, weights, current_host)
    return ranked[0] if ranked else None


def intra_device_first(topo: ClusterTopology, current: Slot,
                       free_slots: Sequence[Slot], snap: Snapshot,
                       weights: PlacementWeights = PlacementWeights()
                       ) -> List[Tuple[Slot, float]]:
    """Paper ordering: intra-GPU slots first, then same-host, then remote."""
    def tier(s: Slot) -> int:
        if s.device == current.device:
            return 0
        if topo.host_of(s.device) == topo.host_of(current.device):
            return 1
        return 2

    ranked = rank_candidates(topo, free_slots, snap, weights,
                             current_host=topo.host_of(current.device))
    return sorted(ranked, key=lambda x: (tier(x[0]), x[1], x[0].key))
