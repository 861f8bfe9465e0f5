"""Greedy isolation-upgrade heuristic (paper §2.5.2).

The allocation problem (min E[SLO miss] over MIG configs x placements
subject to throughput >= 0.95 T_base) is NP-hard; the paper's greedy step
upgrades m_i to maximise  delta_mu = mu(m') - mu(m)  when p99 persists
above tau, with finite termination because each upgrade strictly increases
isolation (at most |M|-1 upgrades).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.profiles import ProfileLattice, SliceProfile


@dataclass(frozen=True)
class UpgradeChoice:
    profile: SliceProfile
    delta_mu: float


def candidate_upgrades(lattice: ProfileLattice, current: SliceProfile,
                       headroom_units: int) -> List[UpgradeChoice]:
    """All stronger profiles that fit within the device's free capacity."""
    out = []
    for p in lattice.profiles[lattice.index(current) + 1:]:
        extra = p.compute_units - current.compute_units
        if extra <= headroom_units:
            out.append(UpgradeChoice(p, p.mu() - current.mu()))
    return out


def greedy_upgrade(lattice: ProfileLattice, current: SliceProfile,
                   headroom_units: int) -> Optional[SliceProfile]:
    """Pick the upgrade maximising delta_mu (the paper's greedy step).

    Maximising delta_mu over the feasible set selects the *largest* profile
    that fits — consistent with the paper's "upgrade m_i to maximise
    delta_mu_i" — and terminates after at most |M|-1 upgrades.
    """
    cands = candidate_upgrades(lattice, current, headroom_units)
    if not cands:
        return None
    return max(cands, key=lambda c: c.delta_mu).profile


def relax_step(lattice: ProfileLattice, current: SliceProfile
               ) -> Optional[SliceProfile]:
    """One-step relaxation (conservative: never jump multiple levels down)."""
    return lattice.relax(current)


def upgrades_remaining(lattice: ProfileLattice, current: SliceProfile) -> int:
    """Finite-termination bound from §2.5.2."""
    return lattice.max_upgrades_from(current)
