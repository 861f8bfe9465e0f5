"""Controller input signals (paper §2.1): per-tenant tails + system-level
counters, EMA-smoothed with hysteresis."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.serving.metrics import EMA


@dataclass
class TenantSignals:
    p95: float = 0.0
    p99: float = 0.0
    p999: float = 0.0
    miss_rate: float = 0.0
    rps: float = 0.0
    ttft_p99: Optional[float] = None      # LLM serving (autoregressive)


@dataclass
class SystemSignals:
    pcie_bytes: Dict[str, float] = field(default_factory=dict)   # per root
    host_io: Dict[str, float] = field(default_factory=dict)      # per numa
    sm_util: Dict[str, float] = field(default_factory=dict)      # per device
    mem_bw: Dict[str, float] = field(default_factory=dict)       # per device
    irq_rate: Dict[str, float] = field(default_factory=dict)     # per host
    nic_bytes: Dict[str, float] = field(default_factory=dict)    # per host


@dataclass
class Snapshot:
    time: float
    tenants: Dict[str, TenantSignals]
    system: SystemSignals


class SignalSmoother:
    """EMA + hysteresis per signal key (paper: "signals are smoothed with
    exponential moving averages and hysteresis")."""

    def __init__(self, alpha: float = 0.3, hysteresis: float = 0.05):
        self.alpha = alpha
        self.hysteresis = hysteresis
        self._emas: Dict[str, EMA] = {}

    def _ema(self, key: str) -> EMA:
        if key not in self._emas:
            self._emas[key] = EMA(alpha=self.alpha,
                                  hysteresis=self.hysteresis)
        return self._emas[key]

    def smooth(self, snap: Snapshot) -> Snapshot:
        tenants = {}
        for name, t in snap.tenants.items():
            tenants[name] = TenantSignals(
                p95=self._ema(f"{name}.p95").update(t.p95),
                p99=self._ema(f"{name}.p99").update(t.p99),
                p999=self._ema(f"{name}.p999").update(t.p999),
                miss_rate=self._ema(f"{name}.miss").update(t.miss_rate),
                rps=self._ema(f"{name}.rps").update(t.rps),
                ttft_p99=(self._ema(f"{name}.ttft").update(t.ttft_p99)
                          if t.ttft_p99 is not None else None),
            )
        sys_out = SystemSignals()
        for attr in ("pcie_bytes", "host_io", "sm_util", "mem_bw",
                     "irq_rate", "nic_bytes"):
            src = getattr(snap.system, attr)
            dst = getattr(sys_out, attr)
            for k, v in src.items():
                dst[k] = self._ema(f"sys.{attr}.{k}").update(v)
        return Snapshot(time=snap.time, tenants=tenants, system=sys_out)
