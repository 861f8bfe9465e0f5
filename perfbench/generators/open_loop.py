"""Open loop: independent users arrive as a Poisson process at a fixed
rate, whatever the system does, so a queue can grow.  Each request is
timed from when it was due.

The requests due in the preamble and those due after it are two fixed
multisets, each in the run's order, so every seed offers the window the
same work.

Set-up starts from a steady state: ``rate x warm_lifetime_s`` requests
(Little's law) met part-way through their lives, chosen by output length
(``traffic.length_biased``), are submitted at once before the schedule
starts.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from perfbench.traffic import (BenchRequest, Tokens, draw_shapes,
                               length_biased)


class Source:
    def __init__(self, mix: Dict, vocab: int, seed: int, horizon_s: float,
                 rate: Optional[float] = None):
        self.rate = float(rate if rate is not None else mix["rate_per_s"])
        shape_rng = np.random.default_rng(mix["shape_seed"])
        run_rng = np.random.default_rng(seed)
        cut = min(float(mix["preamble_s"]), horizon_s)
        parts = [max(1, math.ceil(self.rate * t))
                 for t in (cut, horizon_s - cut) if t > 0]
        shapes = [draw_shapes(mix, k, shape_rng) for k in parts]
        gaps = [shape_rng.exponential(1.0, k) for k in parts]
        for g, k in zip(gaps, parts):
            g *= k / g.sum()                    # the rate exactly
        n_warm = round(self.rate * mix["warm_lifetime_s"])
        pool = draw_shapes(mix, 4 * max(n_warm, 1), shape_rng)
        warm_idx = length_biased(pool.output, shape_rng, n_warm)
        warm_done = [int(shape_rng.integers(0, pool.output[i]))
                     for i in warm_idx]

        tokens = Tokens(mix, vocab, run_rng)
        self.warm_requests: List[BenchRequest] = []
        for rid, i in enumerate(warm_idx):
            prompt = tokens.prompt(int(pool.prefix[i]), int(pool.prompt[i]))
            done = warm_done[rid]
            self.warm_requests.append(BenchRequest(
                rid, 0.0, np.concatenate([prompt, tokens.draw(done)]),
                int(pool.output[i]) - done, warm=True))
        self.pending: List[BenchRequest] = []
        t0 = 0.0
        for part, g in zip(shapes, gaps):
            k = g.size
            due = t0 + np.cumsum(g[run_rng.permutation(k)]) / self.rate
            for j, i in enumerate(run_rng.permutation(k)):
                self.pending.append(BenchRequest(
                    n_warm + len(self.pending), float(due[j]),
                    tokens.prompt(int(part.prefix[i]), int(part.prompt[i])),
                    int(part.output[i])))
            t0 = due[-1]
        self._next = 0

    def warm(self) -> List[BenchRequest]:
        return self.warm_requests

    def next_due(self) -> Optional[float]:
        if self._next < len(self.pending):
            return self.pending[self._next].due
        return None

    def pop_due(self, now: float) -> List[BenchRequest]:
        out = []
        while (self._next < len(self.pending)
               and self.pending[self._next].due <= now):
            out.append(self.pending[self._next])
            self._next += 1
        return out

    def done(self, req: BenchRequest, now: float) -> None:
        """Open loop: a completion sends nothing."""
