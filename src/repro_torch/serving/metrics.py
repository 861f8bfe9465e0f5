"""Latency metrics: windowed tail percentiles, SLO miss-rate, EMA with
hysteresis — the controller's primary signal source (paper §2.1)."""
from __future__ import annotations

import bisect
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

# Prometheus-style cumulative histogram boundaries (seconds).  Chosen to
# straddle the repo's operating points: sub-ms ITL gaps up through
# multi-second door waits under a reconfigure pause.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.2, 0.4, 0.8,
    1.6, 3.2, 6.4)


class LatencyWindow:
    """Sliding window of (time, latency) samples with tail quantiles.

    Times are kept sorted: producers almost always observe in monotone
    order (append-only fast path), but parallel replicas can finalize
    steps out of order — those samples are insort-ed so the
    recent-horizon lookup stays a valid bisect over the time array (the
    controller samples every second — this is the simulator's hot path).

    Alongside the bounded sample window the class keeps *cumulative*
    histogram bucket counts (never trimmed): windowed p99 gauges cannot
    be aggregated across replicas or scrape intervals, but cumulative
    ``le``-bucket counters sum correctly — the ``gateway_*_bucket``
    series ``Gateway.prometheus()`` exports.
    """

    def __init__(self, max_samples: int = 4096, horizon_s: float = 60.0,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.max_samples = max_samples
        self.horizon_s = horizon_s
        self._times: list = []
        self._vals: list = []
        self.total = 0
        self.misses = 0
        self.buckets = tuple(buckets)
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf last
        self.sum = 0.0
        # per-bucket OpenMetrics exemplar: the SLOWEST sample that landed
        # in each bucket, as (latency, req_id, time) — the request a
        # dashboard user drills into from a bucket is the one closest to
        # spilling into the next, i.e. the bucket's worst case.  Only
        # samples observed with a req_id are retained.
        self.exemplars: List[Optional[Tuple[float, int, float]]] = \
            [None] * (len(self.buckets) + 1)

    @property
    def samples(self):
        return list(zip(self._times, self._vals))

    def observe(self, now: float, latency: float,
                slo: Optional[float] = None,
                req_id: Optional[int] = None) -> None:
        if self._times and now < self._times[-1]:
            i = bisect.bisect_right(self._times, now)
            self._times.insert(i, now)
            self._vals.insert(i, latency)
        else:
            self._times.append(now)
            self._vals.append(latency)
        if len(self._times) > 2 * self.max_samples:
            # trim from the head of the time-sorted arrays: the dropped
            # samples are exactly the oldest ones, so a sample inside
            # horizon_s can only fall out after every older sample did
            # (tests/test_serving.py asserts this trim-vs-horizon order)
            self._times = self._times[-self.max_samples:]
            self._vals = self._vals[-self.max_samples:]
        self.total += 1
        self.sum += latency
        b = bisect.bisect_left(self.buckets, latency)
        self.bucket_counts[b] += 1
        if req_id is not None:
            ex = self.exemplars[b]
            if ex is None or latency > ex[0]:
                self.exemplars[b] = (latency, req_id, now)
        if slo is not None and latency > slo:
            self.misses += 1

    def hist(self) -> List[Tuple[float, int]]:
        """Cumulative (le, count) pairs, ``+Inf`` last (== ``total``)."""
        out: List[Tuple[float, int]] = []
        acc = 0
        for le, n in zip(self.buckets, self.bucket_counts):
            acc += n
            out.append((le, acc))
        out.append((float("inf"), self.total))
        return out

    def _recent(self, now: Optional[float] = None) -> np.ndarray:
        if not self._times:
            return np.zeros(0)
        if now is None:
            return np.asarray(self._vals)
        lo = bisect.bisect_left(self._times, now - self.horizon_s)
        return np.asarray(self._vals[lo:])

    def quantile(self, q: float, now: Optional[float] = None) -> float:
        vals = self._recent(now)
        if vals.size == 0:
            return 0.0
        return float(np.quantile(vals, q))

    def p99(self, now: Optional[float] = None) -> float:
        return self.quantile(0.99, now)

    def p999(self, now: Optional[float] = None) -> float:
        return self.quantile(0.999, now)

    def miss_rate(self, slo: float, now: Optional[float] = None) -> float:
        vals = self._recent(now)
        if vals.size == 0:
            return 0.0
        return float(np.mean(vals > slo))

    def count(self, now: Optional[float] = None) -> int:
        return int(self._recent(now).size)


@dataclass
class EMA:
    """Exponential moving average with hysteresis (paper §2.1: signals are
    smoothed with EMAs and hysteresis to reduce spurious triggers)."""
    alpha: float = 0.3
    hysteresis: float = 0.05            # relative dead-band
    value: float = 0.0
    _initialised: bool = False

    def update(self, x: float) -> float:
        if not self._initialised:
            self.value = x
            self._initialised = True
            return self.value
        candidate = self.alpha * x + (1 - self.alpha) * self.value
        # dead-band: ignore sub-hysteresis wiggles.  Guarded on
        # abs(value) so smoothing works for negative-valued signals too
        # (a ``> 0`` guard silently disabled the dead-band for signals
        # like headroom deltas or error terms that live below zero)
        if abs(self.value) > 0 and abs(candidate - self.value) < \
                self.hysteresis * abs(self.value):
            return self.value
        self.value = candidate
        return self.value


@dataclass
class DirectoryStats:
    """Cluster prefix-cache directory counters (``serving/directory.py``):
    publish/retract event totals plus lookup hit rate — a *hit* is a
    dispatch-time lookup that found at least one replica holding a
    page-aligned prefix of the request's prompt."""
    published: int = 0
    retracted: int = 0
    lookups: int = 0
    hits: int = 0

    def hit_rate(self) -> float:
        if not self.lookups:
            return 0.0
        return self.hits / self.lookups

    def as_dict(self) -> Dict[str, float]:
        return {"published": self.published, "retracted": self.retracted,
                "lookups": self.lookups, "hits": self.hits,
                "hit_rate": self.hit_rate()}


@dataclass
class RoutingStats:
    """Cache-aware dispatch counters: every routing decision is exactly
    one of these, so routed + fallbacks + blind == requests dispatched
    (the routed-vs-fallback invariant the tests assert)."""
    routed_cache: int = 0          # sent to a prefix-holding replica
    routed_blind: int = 0          # cache_aware=False baseline decisions
    fallback_miss: int = 0         # no replica holds any prefix
    fallback_imbalance: int = 0    # holder's load lead exceeded the bound
    fallback_stale: int = 0        # directory backlog exceeded the bound

    @property
    def total(self) -> int:
        return (self.routed_cache + self.routed_blind + self.fallback_miss
                + self.fallback_imbalance + self.fallback_stale)

    def cache_route_rate(self) -> float:
        if not self.total:
            return 0.0
        return self.routed_cache / self.total

    def as_dict(self) -> Dict[str, float]:
        return {"routed_cache": self.routed_cache,
                "routed_blind": self.routed_blind,
                "fallback_miss": self.fallback_miss,
                "fallback_imbalance": self.fallback_imbalance,
                "fallback_stale": self.fallback_stale,
                "cache_route_rate": self.cache_route_rate()}


@dataclass
class TenantMetrics:
    """Bundle of per-tenant signals the controller samples every delta s."""
    # door-relative TTFT: prefill_done - arrival, where arrival is the
    # *front-door* timestamp — this window includes any gateway-queue
    # wait, so it is what a client actually experiences
    latency: LatencyWindow = field(default_factory=LatencyWindow)
    # engine-relative TTFT: prefill_done - submitted, observed only for
    # requests that carried a gateway submit stamp.  The gap between the
    # two windows' tails is exactly the door-queue wait — the quantity
    # the --door benchmark arm reports side by side
    engine_ttft: LatencyWindow = field(default_factory=LatencyWindow)
    # inter-token latency (decode cadence): one sample per decoded token,
    # measured between consecutive token-emission timestamps — makes
    # TPOT/ITL observable to the controller, not just TTFT
    itl: LatencyWindow = field(default_factory=LatencyWindow)
    # token-throughput samples inside the retention horizon, plus their
    # running sum: ``throughput()`` runs every controller tick for every
    # tenant, so it must not rescan the whole window each call.  Samples
    # older than ``throughput_horizon_s`` are lazily expired from the
    # left (the deque is time-ordered — ``observe_tokens`` stamps come
    # from the monotone per-engine step clock).
    throughput_window: Deque[Tuple[float, int]] = field(
        default_factory=deque)
    throughput_horizon_s: float = 10.0
    _thr_sum: int = 0
    # KV page-pool gauges (latest sample): ``kv_used_pages`` counts pages
    # holding live KV, ``kv_reserved_pages`` counts pages off the free list
    # (live + reserved-but-unwritten) — under the dense backend's
    # prompt+max_new reservation these diverge, and admission/utilisation
    # signals must distinguish them
    kv_used_pages: int = 0
    kv_reserved_pages: int = 0
    kv_total_pages: int = 0
    # prefix-cache sharing (paged backend): prompt tokens whose prefill
    # compute ran vs tokens served straight from shared prefix pages —
    # their ratio is the prefix-hit rate the --shared-prefix benchmark
    # arm reports
    prefill_tokens_total: int = 0
    prefix_hit_tokens_total: int = 0
    # speculative decode lanes (paged backend): draft rows verified vs
    # accepted by the model — their ratio is the accept rate the --spec
    # benchmark arm reports, and the adaptive-k policy's global analogue
    drafted_tokens_total: int = 0
    accepted_tokens_total: int = 0
    # response cache (paged backend): submits that consulted the
    # engine's ResponseCache vs those that found a cached completion
    # and self-primed draft_hints — the templated-traffic lever that
    # turns speculation on without client cooperation
    response_cache_lookups: int = 0
    response_cache_hits: int = 0

    def observe_tokens(self, now: float, n: int) -> None:
        self.throughput_window.append((now, n))
        self._thr_sum += n
        self._expire_tokens(now - self.throughput_horizon_s)

    def _expire_tokens(self, lo: float) -> None:
        w = self.throughput_window
        while w and w[0][0] < lo:
            _, n = w.popleft()
            self._thr_sum -= n

    def observe_prefill(self, computed: int, prefix_hits: int) -> None:
        self.prefill_tokens_total += computed
        self.prefix_hit_tokens_total += prefix_hits

    def observe_spec(self, drafted: int, accepted: int) -> None:
        self.drafted_tokens_total += drafted
        self.accepted_tokens_total += accepted

    def observe_response_cache(self, lookups: int, hits: int) -> None:
        """Latest cumulative prime counters (engine-local, so a cache
        shared across replicas still yields per-engine rates)."""
        self.response_cache_lookups = lookups
        self.response_cache_hits = hits

    def response_hit_rate(self) -> float:
        """Fraction of cache-consulting submits that self-primed."""
        if not self.response_cache_lookups:
            return 0.0
        return self.response_cache_hits / self.response_cache_lookups

    def accept_rate(self) -> float:
        """Fraction of speculative draft tokens the model accepted."""
        if not self.drafted_tokens_total:
            return 0.0
        return self.accepted_tokens_total / self.drafted_tokens_total

    def prefix_hit_rate(self) -> float:
        """Fraction of prompt tokens served from the prefix cache."""
        total = self.prefill_tokens_total + self.prefix_hit_tokens_total
        if not total:
            return 0.0
        return self.prefix_hit_tokens_total / total

    def observe_kv(self, used: int, reserved: int, total: int) -> None:
        self.kv_used_pages = used
        self.kv_reserved_pages = reserved
        self.kv_total_pages = total

    def kv_utilisation(self) -> float:
        """Reserved fraction of the pool (capacity pressure)."""
        if not self.kv_total_pages:
            return 0.0
        return self.kv_reserved_pages / self.kv_total_pages

    def kv_live_utilisation(self) -> float:
        if not self.kv_total_pages:
            return 0.0
        return self.kv_used_pages / self.kv_total_pages

    def itl_p99(self, now: Optional[float] = None) -> float:
        return self.itl.quantile(0.99, now)

    def throughput(self, now: float,
                   horizon_s: Optional[float] = None) -> float:
        """Tokens/s over the trailing horizon.  The default horizon is
        the retention horizon — an O(1) read of the running sum (after
        lazily expiring stale samples).  A narrower ``horizon_s`` scans
        only the tail of the already-bounded window; a wider one is
        capped at the retention horizon (older samples are gone —
        raise ``throughput_horizon_s`` up front if you need them)."""
        if horizon_s is None or horizon_s >= self.throughput_horizon_s:
            h = self.throughput_horizon_s
            self._expire_tokens(now - h)
            return self._thr_sum / (horizon_s or h)
        self._expire_tokens(now - self.throughput_horizon_s)
        lo = now - horizon_s
        w = self.throughput_window
        tot = 0
        for t, n in reversed(w):
            if t < lo:
                break
            tot += n
        return tot / horizon_s
