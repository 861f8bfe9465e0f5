"""Serving request / response types."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass(frozen=True)
class SubmitOutcome:
    """Result of an engine/scheduler ``submit``: truthy on admission, and
    on rejection it carries *why* — the gateway's backpressure policy
    needs the distinction between a transient shortage (retry later, the
    pool may drain) and a structural impossibility (reject fast, no
    amount of waiting helps).  ``bool(outcome)`` preserves the old
    ``submit() -> bool`` contract for every existing call site."""
    ok: bool
    reason: str = ""            # "" | "pool_exhausted" | "never_fits" |
                                # "exceeds_seq_cap"
    transient: bool = False     # True: retrying later may succeed

    def __bool__(self) -> bool:
        return self.ok


ADMITTED = SubmitOutcome(True)
POOL_EXHAUSTED = SubmitOutcome(False, "pool_exhausted", transient=True)
NEVER_FITS = SubmitOutcome(False, "never_fits")
EXCEEDS_SEQ_CAP = SubmitOutcome(False, "exceeds_seq_cap")


@dataclass
class Request:
    req_id: int
    tenant: str
    prompt_len: int
    max_new_tokens: int
    arrival: float                      # seconds (sim or wall clock)
    slo_ms: Optional[float] = None      # per-request TTFT SLO, if any
    prompt_tokens: Optional[object] = None   # [S] int32 (None => synthetic)
    # scheduling weight for the paged runtime's SLO-aware preemption:
    # lower-priority sequences are evicted first when the page pool is
    # exhausted (ties broken by deadline = arrival + slo)
    priority: float = 1.0
    # optional speculative-decode hint corpus ([T] int tokens): text the
    # frontend believes likely to continue this response (e.g. the
    # completion previously observed for the same templated prompt).
    # Hints are only ever *searched* by the n-gram drafter and *verified*
    # by the model — a stale hint costs rejected draft rows, never a
    # wrong output token
    draft_hints: Optional[object] = None

    # --- runtime state ---
    slot: int = -1
    # time the request was accepted by an ENGINE (set by the gateway on a
    # successful submit; -1 when the request never passed through a
    # gateway door).  ``arrival`` is the front-door timestamp, so
    # door-measured TTFT = prefill_done - arrival (includes door-queue
    # wait) while engine-measured TTFT = prefill_done - submitted
    submitted: float = -1.0
    prefill_done: float = -1.0          # time the first token was emitted
    finished: float = -1.0
    generated: int = 0
    output_tokens: List[int] = field(default_factory=list)
    decode_times: List[float] = field(default_factory=list)  # per decode token

    @property
    def ttft(self) -> Optional[float]:
        if self.prefill_done < 0:
            return None
        return self.prefill_done - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Mean time-per-output-token after the first (needs >= 2 tokens)."""
        if self.prefill_done < 0 or not self.decode_times:
            return None
        return (self.decode_times[-1] - self.prefill_done) / \
            len(self.decode_times)

    @property
    def itls(self) -> List[float]:
        """Inter-token latencies (first gap measured from prefill_done)."""
        if self.prefill_done < 0 or not self.decode_times:
            return []
        ts = [self.prefill_done] + self.decode_times
        return [b - a for a, b in zip(ts, ts[1:])]

    @property
    def done(self) -> bool:
        return self.finished >= 0
