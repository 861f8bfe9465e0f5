"""Decision FSM (paper Algorithm 1 + §2.3): breach persistence, dwell,
cool-down, stability detection, and post-change validation windows."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class PolicyConfig:
    """Paper Table 1 defaults."""
    tau_s: float = 0.015             # tail threshold (15 ms p99)
    persistence: int = 3             # Y consecutive windows above tau
    dwell_obs: int = 256             # min observations between actions
    cooldown_obs: int = 128          # grace period after recovery
    stable_obs: int = 64             # windows well inside SLO before relax
    stable_margin: float = 0.7       # "well within": p99 < margin * tau
    validation_obs: int = 45         # post-change validation window
    throughput_budget: float = 0.95  # T_i >= 0.95 T_base


class Phase(enum.Enum):
    MONITOR = "monitor"
    VALIDATE = "validate"


class Trigger(enum.Enum):
    NONE = "none"
    BREACH = "breach"        # p99 > tau for Y consecutive windows
    STABLE = "stable"        # sustained headroom -> consider relaxing


class DecisionFSM:
    """Counts observation windows; gates actions exactly as Algorithm 1:

        if not at_reconfig_boundary() or is_cooling_down(): return
        if p99 > tau for Y consecutive windows: UpgradeIsolation
        elif tail_is_stable() and throughput_ok(): RelaxIsolation
    """

    def __init__(self, cfg: PolicyConfig):
        self.cfg = cfg
        self.phase = Phase.MONITOR
        self.breach_streak = 0
        self.stable_streak = 0
        self.obs_since_action = cfg.dwell_obs      # allow an initial action
        self.cooldown_left = 0
        self.validate_left = 0
        self._baseline_p99: Optional[float] = None  # pre-change p99 (rollback)

    # ------------------------------------------------------------- queries
    def at_reconfig_boundary(self) -> bool:
        return self.obs_since_action >= self.cfg.dwell_obs

    def is_cooling_down(self) -> bool:
        return self.cooldown_left > 0

    # ------------------------------------------------------------- updates
    def observe(self, p99: float, throughput_ok: bool = True) -> Trigger:
        """One observation window.  Returns the gated trigger."""
        self.obs_since_action += 1
        if self.cooldown_left > 0:
            self.cooldown_left -= 1

        if p99 > self.cfg.tau_s:
            self.breach_streak += 1
            self.stable_streak = 0
        else:
            self.breach_streak = 0
            if p99 < self.cfg.stable_margin * self.cfg.tau_s:
                self.stable_streak += 1
            else:
                self.stable_streak = 0

        if self.phase == Phase.VALIDATE:
            self.validate_left -= 1
            return Trigger.NONE    # actions gated during validation

        # Raw persistence triggers.  Lightweight guardrails may act on a
        # BREACH immediately; *structural* actions (move / reconfigure /
        # relax) are additionally gated by at_reconfig_boundary() and
        # is_cooling_down() in the controller — exactly Algorithm 1's
        # "if not at_reconfig_boundary() or is_cooling_down(): return".
        if self.breach_streak >= self.cfg.persistence:
            return Trigger.BREACH
        if self.stable_streak >= self.cfg.stable_obs and throughput_ok:
            return Trigger.STABLE
        return Trigger.NONE

    def action_taken(self, pre_change_p99: float) -> None:
        """Start dwell + post-change validation (paper §2.4: rollback if
        post-change p99 worsens within a short validation window)."""
        self.obs_since_action = 0
        self.cooldown_left = self.cfg.cooldown_obs
        self.breach_streak = 0
        self.stable_streak = 0
        self.phase = Phase.VALIDATE
        self.validate_left = self.cfg.validation_obs
        self._baseline_p99 = pre_change_p99

    def validation_result(self, current_p99: float) -> Optional[bool]:
        """Returns None while validating, else True (keep) / False (rollback)."""
        if self.phase != Phase.VALIDATE:
            return None
        if self.validate_left > 0:
            return None
        self.phase = Phase.MONITOR
        # generous margin: the pre-change baseline is often captured while
        # the interference burst (and the EMA) is still ramping, so a small
        # post-change excess is not evidence the action hurt
        ok = (self._baseline_p99 is None
              or current_p99 <= self._baseline_p99 * 1.25)
        self._baseline_p99 = None
        return ok
