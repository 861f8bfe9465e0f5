"""Kingman's G/G/1 heavy-traffic approximation (paper §2.5.1).

    E[W_q] ~= rho/(1-rho) * (c_a^2 + c_s^2)/2 * E[S],   rho = lambda E[S]

Used qualitatively: the controller's diagnosis ranks candidate actions by
how much they reduce rho (via E[S]) for the latency-sensitive tenant; the
evaluation reports empirical p99/p999 (the paper avoids positing a
parametric tail form).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class GG1:
    arrival_rate: float     # lambda (1/s)
    mean_service: float     # E[S] (s)
    ca2: float = 1.0        # squared coeff. of variation of inter-arrivals
    cs2: float = 1.0        # squared coeff. of variation of service times

    @property
    def rho(self) -> float:
        return self.arrival_rate * self.mean_service

    def mean_wait(self) -> float:
        rho = self.rho
        if rho >= 1.0:
            return math.inf
        return rho / (1 - rho) * (self.ca2 + self.cs2) / 2 * self.mean_service

    def mean_sojourn(self) -> float:
        return self.mean_wait() + self.mean_service

    def tail_inflation(self) -> float:
        """Dimensionless saturation signal: how much queueing inflates the
        mean sojourn over the bare service time.  -> inf as rho -> 1,
        matching the paper's "saturation inflates tails" guidance."""
        if self.mean_service <= 0:
            return 0.0
        return self.mean_sojourn() / self.mean_service


def service_rate_needed(arrival_rate: float, target_rho: float = 0.7
                        ) -> float:
    """Capacity planning helper: mu such that rho == target at lambda."""
    return arrival_rate / target_rho
