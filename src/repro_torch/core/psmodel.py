"""Processor-sharing model of the shared fabric (paper §2.5.1).

    b_i(t) = min( B * w_i / sum_{j active} w_j ,  g_i )

plus the latency decomposition  L_i = c_i + s_i / b_i + eps  and the
stability condition of Claim 1 (sum_j g_j < B).

The same model describes the PCIe root complex on a GPU host and an ICI
link / host-DMA path on a TPU pod — only the capacity constant changes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple


@dataclass(frozen=True)
class Demand:
    weight: float = 1.0
    throttle: Optional[float] = None     # g_i in bytes/s (None = uncapped)


def ps_shares(demands: Mapping[str, Demand], capacity: float
              ) -> Dict[str, float]:
    """Paper-faithful share: b_i = min(B*w_i/sum w_j, g_i)."""
    total_w = sum(d.weight for d in demands.values())
    if total_w <= 0:
        return {k: 0.0 for k in demands}
    out = {}
    for k, d in demands.items():
        fair = capacity * d.weight / total_w
        out[k] = min(fair, d.throttle) if d.throttle is not None else fair
    return out


def ps_shares_waterfill(demands: Mapping[str, Demand], capacity: float,
                        iters: int = 8) -> Dict[str, float]:
    """Beyond-paper refinement: redistribute capacity unused by throttled
    flows to the remaining flows (max-min water-filling).  The paper's
    formula leaves b_i at the fair share even when other tenants are capped
    below theirs; real PCIe arbitration gives the slack back."""
    remaining = dict(demands)
    alloc: Dict[str, float] = {}
    cap_left = capacity
    for _ in range(iters):
        if not remaining:
            break
        total_w = sum(d.weight for d in remaining.values())
        capped = {k: d for k, d in remaining.items()
                  if d.throttle is not None
                  and d.throttle < cap_left * d.weight / total_w}
        if not capped:
            for k, d in remaining.items():
                alloc[k] = cap_left * d.weight / total_w
            remaining = {}
            break
        for k, d in capped.items():
            alloc[k] = d.throttle
            cap_left -= d.throttle
            del remaining[k]
    return alloc


def transfer_time(size_bytes: float, bandwidth: float) -> float:
    if bandwidth <= 0:
        return math.inf
    return size_bytes / bandwidth


def latency(compute_s: float, size_bytes: float, bandwidth: float,
            noise_s: float = 0.0) -> float:
    """L_i = c_i + s_i/b_i + eps  (paper §2.5.1)."""
    return compute_s + transfer_time(size_bytes, bandwidth) + noise_s


def stable_under_throttles(throttles: Mapping[str, float],
                           capacity: float) -> bool:
    """Claim 1 condition (iii): aggregate offered load sum_j g_j < B."""
    return sum(throttles.values()) < capacity


def utilisation(throttles: Mapping[str, float], capacity: float) -> float:
    return sum(throttles.values()) / capacity
