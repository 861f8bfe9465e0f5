"""Beyond-paper extension: proactive tail prediction.

The paper's controller is reactive — it waits for p99 > tau to persist Y
windows.  Its §5 notes "richer learning-based predictors could improve
stability at the cost of complexity".  This module adds the simplest
predictor that can act *before* the SLO is breached:

  * a short-horizon linear trend over the smoothed p99 stream
    (least-squares slope over the last W samples), and
  * a Kingman utilisation check (rho from observed rps x estimated mean
    service) that vetoes predictions when the system is clearly unloaded.

``predict(t)`` returns the extrapolated p99 at t + horizon; the controller
treats ``predicted > tau`` while ``current > guard * tau`` as an early
BREACH — all structural gates (dwell/cool-down/validation) still apply, so
the proactive path can only move actions *earlier*, never make them more
frequent than Algorithm 1 allows.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Optional, Tuple

import numpy as np

from repro_torch.core.kingman import GG1


@dataclass(frozen=True)
class PredictorConfig:
    horizon_s: float = 15.0        # how far ahead to extrapolate
    window: int = 12               # trend-fit samples
    guard_frac: float = 0.6        # require current p99 > guard*tau to act
    min_slope: float = 1e-5        # s of p99 per s (ignore flat trends)
    rho_floor: float = 0.05        # skip predictions when nearly idle


class TailTrendPredictor:
    def __init__(self, cfg: PredictorConfig = PredictorConfig()):
        self.cfg = cfg
        self._hist: Deque[Tuple[float, float]] = deque(maxlen=cfg.window)

    def update(self, t: float, p99: float) -> None:
        self._hist.append((t, p99))

    def slope(self) -> float:
        if len(self._hist) < 4:
            return 0.0
        ts = np.array([t for t, _ in self._hist])
        ys = np.array([y for _, y in self._hist])
        ts = ts - ts.mean()
        denom = float(np.sum(ts * ts))
        if denom <= 0:
            return 0.0
        return float(np.sum(ts * (ys - ys.mean())) / denom)

    def predict(self, now: float) -> Optional[float]:
        """Extrapolated p99 at now + horizon (None if not enough data)."""
        if len(self._hist) < 4:
            return None
        slope = self.slope()
        if slope < self.cfg.min_slope:
            return None
        t_last, y_last = self._hist[-1]
        return y_last + slope * (now - t_last + self.cfg.horizon_s)

    def should_preact(self, now: float, current_p99: float, tau: float,
                      rps: float = 0.0,
                      mean_service_s: float = 0.0) -> bool:
        """True when the trend says tau will be crossed within the horizon."""
        if current_p99 <= self.cfg.guard_frac * tau:
            return False
        if rps > 0 and mean_service_s > 0:
            rho = GG1(arrival_rate=rps, mean_service=mean_service_s).rho
            if rho < self.cfg.rho_floor:
                return False
        pred = self.predict(now)
        return pred is not None and pred > tau
