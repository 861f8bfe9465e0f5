"""Cluster topology graph: hosts, NUMA domains, PCIe root complexes,
accelerators — and the TPU-pod analogue (hosts, DMA paths, ICI mesh).

The paper queries topology via DCGM/NVML + lspci/NUMA maps (§2.2.1); here
the same queries run against an explicit graph so the placement scorer is
testable and the simulator and dry-run share one source of truth.

The twin of ``repro/core/topology.py`` without ``networkx``: the graph is
two plain containers, ``kinds`` (node -> "host" | "numa" | "root" |
"device", in insertion order) and ``edges`` (parent, child) pairs; every
query answers as the reference's does.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class Slot:
    """A placement slot: one MIG-instance position (GPU) or slice anchor
    (TPU) on a device."""
    host: int
    device: str            # e.g. "h0:g3"
    index: int             # slot position on the device

    @property
    def key(self) -> str:
        return f"{self.device}:s{self.index}"


class ClusterTopology:
    def __init__(self, num_hosts: int = 2, devices_per_host: int = 8,
                 devices_per_root: int = 2, numa_per_host: int = 2,
                 slots_per_device: int = 2, kind: str = "gpu"):
        self.kind = kind
        self.num_hosts = num_hosts
        self.devices_per_host = devices_per_host
        self.slots_per_device = slots_per_device
        self.kinds: Dict[str, str] = {}
        self.edges: List[Tuple[str, str]] = []
        self._root_of: Dict[str, str] = {}
        self._numa_of: Dict[str, str] = {}
        self._host_of: Dict[str, int] = {}
        for h in range(num_hosts):
            host = f"h{h}"
            self.kinds[host] = "host"
            numas = [f"{host}:n{i}" for i in range(numa_per_host)]
            for n in numas:
                self.kinds[n] = "numa"
                self.edges.append((host, n))
            roots_per_host = devices_per_host // devices_per_root
            for r in range(roots_per_host):
                root = f"{host}:r{r}"
                numa = numas[r * numa_per_host // roots_per_host]
                self.kinds[root] = "root"
                self.edges.append((numa, root))
                for d in range(devices_per_root):
                    dev = f"{host}:g{r * devices_per_root + d}"
                    self.kinds[dev] = "device"
                    self.edges.append((root, dev))
                    self._root_of[dev] = root
                    self._numa_of[dev] = numa
                    self._host_of[dev] = h

    # ------------------------------------------------------------- queries
    def devices(self, host: Optional[int] = None) -> List[str]:
        devs = [n for n, k in self.kinds.items() if k == "device"]
        if host is not None:
            devs = [d for d in devs if self._host_of[d] == host]
        return sorted(devs)

    def roots(self) -> List[str]:
        return sorted(n for n, k in self.kinds.items() if k == "root")

    def numas(self) -> List[str]:
        return sorted(n for n, k in self.kinds.items() if k == "numa")

    def root_of(self, device: str) -> str:
        return self._root_of[device]

    def numa_of(self, device: str) -> str:
        return self._numa_of[device]

    def host_of(self, device: str) -> int:
        return self._host_of[device]

    def same_root(self, a: str, b: str) -> bool:
        return self._root_of[a] == self._root_of[b]

    def same_numa(self, a: str, b: str) -> bool:
        return self._numa_of[a] == self._numa_of[b]

    def slots(self, device: Optional[str] = None) -> List[Slot]:
        devs = [device] if device else self.devices()
        return [Slot(self._host_of[d], d, i)
                for d in devs for i in range(self.slots_per_device)]

    def siblings(self, device: str) -> List[str]:
        """Devices sharing this device's PCIe root complex."""
        return sorted(d for d, r in self._root_of.items()
                      if r == self._root_of[device] and d != device)


def make_p4d_cluster(num_hosts: int = 2) -> ClusterTopology:
    """The paper's testbed: p4d.24xlarge x2 — 8xA100 per host, 4 PCIe root
    complexes (2 GPUs each), 2 NUMA domains."""
    if num_hosts < 1:
        raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
    return ClusterTopology(num_hosts=num_hosts, devices_per_host=8,
                           devices_per_root=2, numa_per_host=2,
                           slots_per_device=2, kind="gpu")


def make_p4d_fleet(num_hosts: int = 4) -> ClusterTopology:
    """The scaled fleet: the paper's p4d node type grown past the 2-host
    testbed (first step of the ROADMAP's "scale the fleet" item — the E5
    ``--hosts 4`` arm measures controller wall-clock per tick against this
    topology)."""
    return make_p4d_cluster(num_hosts)


# Named catalog of the built-in testbeds (today exercised by the topology
# test suite; e5 --hosts builds p4d fleets by host count via
# make_p4d_fleet — a config-file/CLI name-based selector can resolve
# through here when one grows a consumer).
BUILTIN_TOPOLOGIES = {
    "p4d-2host": lambda: make_p4d_cluster(2),     # the paper's testbed
    "p4d-4host": lambda: make_p4d_fleet(4),       # scaled fleet variant
    "tpu-v5e-pod": lambda: make_tpu_pod_hosts(1),
}


def builtin_topology(name: str) -> ClusterTopology:
    """Instantiate a named built-in topology."""
    try:
        return BUILTIN_TOPOLOGIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown topology {name!r} (have "
            f"{sorted(BUILTIN_TOPOLOGIES)})") from None


def make_tpu_pod_hosts(num_pods: int = 1, chips_per_host: int = 4,
                       hosts_per_pod: int = 64) -> ClusterTopology:
    """TPU v5e pod viewed host-wise: each host's PCIe/DMA path feeds
    ``chips_per_host`` chips — that shared path is the PS server."""
    return ClusterTopology(num_hosts=num_pods * hosts_per_pod,
                           devices_per_host=chips_per_host,
                           devices_per_root=chips_per_host, numa_per_host=1,
                           slots_per_device=1, kind="tpu")
