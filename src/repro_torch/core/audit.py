"""Decision audit log with rollback support (paper §2.4: "log all decisions
with signal snapshots for audit, and support rollback to the last-known-good
configuration if post-change p99 worsens within a short validation window").
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class TenantConfig:
    profile: str
    device: str
    slot: int
    mps_quota: float = 1.0
    cpu_pinned_away_from_irq: bool = False

    def copy(self) -> "TenantConfig":
        return TenantConfig(**asdict(self))


@dataclass
class Decision:
    time: float
    action: str                       # reconfigure|move|throttle_io|mps|relax|rollback
    tenant: str
    args: Dict[str, Any]
    signal_summary: Dict[str, float]
    config_before: Optional[Dict[str, Any]] = None
    config_after: Optional[Dict[str, Any]] = None
    validated: Optional[bool] = None


class AuditLog:
    def __init__(self):
        self.decisions: List[Decision] = []
        self._last_known_good: Dict[str, TenantConfig] = {}

    def record(self, d: Decision) -> Decision:
        self.decisions.append(d)
        return d

    def mark_good(self, tenant: str, cfg: TenantConfig) -> None:
        self._last_known_good[tenant] = cfg.copy()

    def last_known_good(self, tenant: str) -> Optional[TenantConfig]:
        cfg = self._last_known_good.get(tenant)
        return cfg.copy() if cfg is not None else None

    def set_validation(self, ok: bool, tenant: Optional[str] = None) -> None:
        """Attach the validation verdict to the most recent structural
        decision (reconfigure/move/relax), optionally restricted to one
        tenant's lane (multi-tenant controllers validate per lane)."""
        for d in reversed(self.decisions):
            if d.action in ("reconfigure", "move", "relax") and \
                    (tenant is None or d.tenant == tenant):
                d.validated = ok
                return

    # ------------------------------------------------------------- exports
    def actions_of(self, kind: str) -> List[Decision]:
        return [d for d in self.decisions if d.action == kind]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self.decisions:
            out[d.action] = out.get(d.action, 0) + 1
        return out

    def to_json(self) -> str:
        return json.dumps([asdict(d) for d in self.decisions], indent=2,
                          default=str)
