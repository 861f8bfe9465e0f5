"""Closed loop: ``clients`` callers, each sending its next request as soon
as its last one completes, so a slow system receives less load.  Requests
come from a fixed pool of ``pool`` shapes in the run's order; request k's
tokens are the k-th drawn, whichever client sends it.

Each client's first request is met part-way through its life, chosen by
output length (``traffic.length_biased``), so completions do not come in
a wave; those are submitted at once in set-up.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from perfbench.traffic import (BenchRequest, Tokens, draw_shapes,
                               length_biased)


class Source:
    def __init__(self, mix: Dict, vocab: int, seed: int, horizon_s: float,
                 rate: Optional[float] = None):
        if rate is not None:
            raise ValueError("a closed loop has no arrival rate to set")
        shape_rng = np.random.default_rng(mix["shape_seed"])
        run_rng = np.random.default_rng(seed)
        clients = int(mix["clients"])
        self.shapes = draw_shapes(mix, int(mix["pool"]), shape_rng)
        wpool = draw_shapes(mix, 4 * clients, shape_rng)
        widx = length_biased(wpool.output, shape_rng, clients)
        wdone = [int(shape_rng.integers(0, wpool.output[i])) for i in widx]
        self.tokens = Tokens(mix, vocab, run_rng)
        self.order = run_rng.permutation(self.shapes.prompt.size)
        self.warm_requests: List[BenchRequest] = []
        for rid, i in enumerate(widx):
            prompt = self.tokens.prompt(int(wpool.prefix[i]),
                                        int(wpool.prompt[i]))
            self.warm_requests.append(BenchRequest(
                rid, 0.0, np.concatenate([prompt,
                                          self.tokens.draw(wdone[rid])]),
                int(wpool.output[i]) - wdone[rid], warm=True))
        self._rid = clients
        self._k = 0
        self.pending: List[BenchRequest] = []

    def warm(self) -> List[BenchRequest]:
        return self.warm_requests

    def next_due(self) -> Optional[float]:
        return min((r.due for r in self.pending), default=None)

    def pop_due(self, now: float) -> List[BenchRequest]:
        out = [r for r in self.pending if r.due <= now]
        self.pending = [r for r in self.pending if r.due > now]
        return out

    def done(self, req: BenchRequest, now: float) -> None:
        """The client whose request completed sends its next one now."""
        i = int(self.order[self._k % self.order.size])
        self._k += 1
        self.pending.append(BenchRequest(
            self._rid, now,
            self.tokens.prompt(int(self.shapes.prefix[i]),
                               int(self.shapes.prompt[i])),
            int(self.shapes.output[i])))
        self._rid += 1
