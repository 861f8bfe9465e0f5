"""Lightweight guardrails (paper §2.2): MPS quotas and cgroup-style I/O
throttles, applied for bounded windows with automatic expiry (§2.4: "I/O
throttles use cgroup io.max with bounded windows (tens of seconds) to
reduce collateral damage")."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Tuple


@dataclass(frozen=True)
class GuardrailBounds:
    """Table 1: MPS quota 50-100%; IO throttle 100-500 MB/s.  Bounded
    windows "reduce collateral damage" (§2.4): a refractory period after
    expiry keeps the background tenant from being throttled back-to-back."""
    mps_quota: Tuple[float, float] = (0.5, 1.0)
    io_throttle: Tuple[float, float] = (100e6, 500e6)
    io_window_s: float = 30.0
    io_refractory_s: float = 90.0


class GuardrailActuator(Protocol):
    def set_io_throttle(self, tenant: str, bytes_per_s: Optional[float]) -> None: ...
    def set_mps_quota(self, tenant: str, frac: float) -> None: ...


@dataclass
class ActiveThrottle:
    tenant: str
    bytes_per_s: float
    expires_at: float


class GuardrailManager:
    def __init__(self, bounds: GuardrailBounds = GuardrailBounds()):
        self.bounds = bounds
        self.active_throttles: Dict[str, ActiveThrottle] = {}
        self.mps_quotas: Dict[str, float] = {}
        self._last_expiry: Dict[str, float] = {}

    def in_refractory(self, tenant: str, now: float) -> bool:
        exp = self._last_expiry.get(tenant)
        return exp is not None and now < exp + self.bounds.io_refractory_s

    def throttle_io(self, actuator: GuardrailActuator, tenant: str,
                    bytes_per_s: float, now: float,
                    window_s: Optional[float] = None) -> float:
        lo, hi = self.bounds.io_throttle
        value = float(min(max(bytes_per_s, lo), hi))
        window = window_s if window_s is not None else self.bounds.io_window_s
        actuator.set_io_throttle(tenant, value)
        self.active_throttles[tenant] = ActiveThrottle(
            tenant, value, now + window)
        return value

    def set_mps_quota(self, actuator: GuardrailActuator, tenant: str,
                      frac: float) -> float:
        lo, hi = self.bounds.mps_quota
        value = float(min(max(frac, lo), hi))
        actuator.set_mps_quota(tenant, value)
        self.mps_quotas[tenant] = value
        return value

    def tick(self, actuator: GuardrailActuator, now: float) -> List[str]:
        """Expire bounded-window throttles.  Returns expired tenant names."""
        expired = [t for t, a in self.active_throttles.items()
                   if now >= a.expires_at]
        for t in expired:
            actuator.set_io_throttle(t, None)
            self._last_expiry[t] = now
            del self.active_throttles[t]
        return expired

    def is_throttled(self, tenant: str) -> bool:
        return tenant in self.active_throttles

    def total_throttle(self) -> float:
        """Sum of active caps — feeds the Claim-1 stability check."""
        return sum(a.bytes_per_s for a in self.active_throttles.values())
