"""Isolation profiles — the dynamic-reconfiguration lattice (paper §2.2).

Two lattices:
  * ``A100_MIG`` — the paper's exact profiles (1g.10gb … 7g.80gb).  Used by
    the faithful-reproduction simulator.
  * ``TPU_SLICE`` — the TPU-native analogue: sub-meshes of a pod assigned
    per tenant.  "Upgrading isolation" re-shards the tenant onto a larger
    slice (pjit re-lower + weight move), which like a MIG change requires a
    brief tenant pause.

Both expose the same ordered interface, so the controller (policy.py,
optimizer.py) is lattice-agnostic.  mu(m) — the service-capacity proxy the
greedy optimizer maximises (paper §2.5.2: "mu(m) proportional to SM cores
and memory in profile m") — is ``compute_units``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class SliceProfile:
    name: str
    compute_units: int        # GPU: GPCs ("g"); TPU: chips x cores
    memory_gb: float
    chips: int = 1            # TPU slices span chips; MIG profiles stay at 1

    def mu(self) -> float:
        """Service-capacity proxy (paper: proportional to SMs + memory)."""
        return float(self.compute_units)


class ProfileLattice:
    """Totally-ordered isolation lattice with upgrade/relax moves."""

    def __init__(self, profiles: Sequence[SliceProfile]):
        self.profiles: Tuple[SliceProfile, ...] = tuple(
            sorted(profiles, key=lambda p: (p.compute_units, p.memory_gb)))
        self._index = {p.name: i for i, p in enumerate(self.profiles)}

    def __len__(self) -> int:
        return len(self.profiles)

    def __getitem__(self, name: str) -> SliceProfile:
        return self.profiles[self._index[name]]

    def index(self, p: SliceProfile) -> int:
        return self._index[p.name]

    def upgrade(self, p: SliceProfile) -> Optional[SliceProfile]:
        """Next-stronger profile, or None at the top (finite termination:
        at most len(lattice)-1 upgrades, paper §2.5.2)."""
        i = self.index(p)
        return self.profiles[i + 1] if i + 1 < len(self.profiles) else None

    def relax(self, p: SliceProfile) -> Optional[SliceProfile]:
        i = self.index(p)
        return self.profiles[i - 1] if i > 0 else None

    def max_upgrades_from(self, p: SliceProfile) -> int:
        return len(self.profiles) - 1 - self.index(p)

    @property
    def top(self) -> SliceProfile:
        return self.profiles[-1]

    @property
    def bottom(self) -> SliceProfile:
        return self.profiles[0]


# The paper's A100-80GB MIG profile set.
A100_MIG = ProfileLattice([
    SliceProfile("1g.10gb", 1, 10.0),
    SliceProfile("2g.20gb", 2, 20.0),
    SliceProfile("3g.40gb", 3, 40.0),
    SliceProfile("4g.40gb", 4, 40.0),
    SliceProfile("7g.80gb", 7, 80.0),
])

# TPU v5e slice lattice (compute_units = chips; 16 GB HBM per chip).
TPU_SLICE = ProfileLattice([
    SliceProfile("1x1", 1, 16.0, chips=1),
    SliceProfile("2x1", 2, 32.0, chips=2),
    SliceProfile("2x2", 4, 64.0, chips=4),
    SliceProfile("4x2", 8, 128.0, chips=8),
    SliceProfile("4x4", 16, 256.0, chips=16),
    SliceProfile("8x4", 32, 512.0, chips=32),
])
