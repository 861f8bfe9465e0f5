"""Cluster-wide KV reuse: prefix-cache directory, cache-aware routing,
and a cross-request response cache.

Each replica's ``PagedKVCache`` prefix cache is private — without this
layer a tenant with R replicas re-prefills the same system prompt R
times, and the least-loaded dispatcher is blind to which replica already
holds a request's KV.  Three pieces close that gap:

* :class:`PrefixDirectory` — a per-tenant map from **content-hashed**
  page-aligned prefix chains to the replicas holding them.  Hashes are
  derived from token *content* (chained blake2b per page), so two
  replicas that independently prefilled the same prompt publish the
  same key, and the dispatcher can compare holdings across replicas
  without ever seeing a page id.  The directory is fed by
  ``PagedKVCache`` listener events (``commit_prefix`` publishes,
  cached-page eviction retracts) and is **stale-but-safe by
  construction**: a stale "holds" entry routes a request to a replica
  that merely misses its prefix cache (tokens are unaffected — the
  prefix cache itself re-verifies content by chain key), and a missing
  entry just falls back to least-loaded.  ``defer_events=True`` buffers
  events until :meth:`~PrefixDirectory.sync` — the directory's pending
  backlog is its *staleness* measure, which the router bounds.

* :class:`CacheAwareRouter` — route-to-longest-held-prefix dispatch
  with least-loaded fallback.  The cache route is taken only when the
  directory is fresh enough (``staleness_bound``) and the target's load
  lead over the least-loaded replica is within ``imbalance_bound``;
  every decision is counted (routed vs each fallback reason) so the
  policy is observable.  All tie-breaks are a **strict total order**
  ending in the replica index, so identical traces route identically.

* :class:`ResponseCache` — (tenant, prompt-hash, params) -> the
  committed output tokens of a finished request.  On a later identical
  request it auto-primes ``Request.draft_hints``, so templated
  production traffic rides the existing NgramDrafter/verify path at
  near-100% acceptance *without client cooperation* — the model still
  verifies every drafted token, so a stale cached response costs
  rejected draft rows, never a wrong output token.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.serving.metrics import DirectoryStats, RoutingStats
from repro_torch.serving.request import Request

_EMPTY_HASH = 0


def _page_hash(parent: int, chunk) -> int:
    """Content hash of one more page chained onto ``parent``'s hash.
    blake2b (not Python ``hash``) so the value is stable across
    processes — a real deployment gossips these between hosts."""
    data = parent.to_bytes(8, "little") + \
        np.asarray(chunk, np.int64).tobytes()
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "little")


def prefix_hashes(tokens, page_size: int,
                  max_pages: Optional[int] = None) -> List[int]:
    """Chained content hash of each full page-aligned prefix of
    ``tokens`` (element ``p`` covers pages ``0..p``).  Matches the hash
    a :class:`PagedKVCache` listener derives for the same content via
    :func:`chain_key_hash`, so the dispatcher can compute a request's
    keys from its prompt alone."""
    if tokens is None:
        return []
    n = len(tokens) // page_size
    if max_pages is not None:
        n = min(n, max_pages)
    out: List[int] = []
    h = _EMPTY_HASH
    for p in range(n):
        h = _page_hash(h, tokens[p * page_size:(p + 1) * page_size])
        out.append(h)
    return out


def chain_key_hash(key: tuple) -> int:
    """The same content hash, derived from a ``PagedKVCache`` prefix
    chain key (the recursive ``(parent_key, page_tokens)`` tuple)."""
    chunks = []
    while key is not None:
        key, chunk = key
        chunks.append(chunk)
    h = _EMPTY_HASH
    for chunk in reversed(chunks):
        h = _page_hash(h, chunk)
    return h


def prompt_hash(tokens) -> int:
    """Stable content hash of a whole prompt (response-cache key)."""
    data = np.asarray(tokens, np.int64).tobytes()
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "little")


class _CacheListener:
    """Binds one replica's ``PagedKVCache`` events to the directory."""

    def __init__(self, directory: "PrefixDirectory", tenant: str,
                 replica: int):
        self.directory = directory
        self.tenant = tenant
        self.replica = replica

    def on_commit(self, chain_key: tuple, upto_tokens: int) -> None:
        self.directory.publish(self.tenant, self.replica,
                               chain_key_hash(chain_key))

    def on_evict(self, chain_key: tuple) -> None:
        self.directory.retract(self.tenant, self.replica,
                               chain_key_hash(chain_key))


class PrefixDirectory:
    """Per-tenant map: page-chain content hash -> replicas holding it.

    ``defer_events=True`` models the distributed reality (the directory
    service lags the replicas): events queue until :meth:`sync`, and
    ``staleness()`` — the pending backlog — is what the router bounds.
    The default applies events immediately (staleness 0)."""

    def __init__(self, page_size: int, defer_events: bool = False):
        self.page_size = page_size
        self.defer_events = defer_events
        self._holders: Dict[Tuple[str, int], Set[int]] = {}
        self._pending: Deque[Tuple[str, str, int, int]] = deque()
        self.stats = DirectoryStats()

    # ----------------------------------------------------------- wiring
    def attach(self, tenant: str, replica: int, kv) -> None:
        """Subscribe to one replica's prefix-cache commit/evict events."""
        kv.listener = _CacheListener(self, tenant, replica)

    # ----------------------------------------------------------- events
    def publish(self, tenant: str, replica: int, h: int) -> None:
        if self.defer_events:
            self._pending.append(("pub", tenant, replica, h))
        else:
            self._apply("pub", tenant, replica, h)

    def retract(self, tenant: str, replica: int, h: int) -> None:
        if self.defer_events:
            self._pending.append(("ret", tenant, replica, h))
        else:
            self._apply("ret", tenant, replica, h)

    def _apply(self, op: str, tenant: str, replica: int, h: int) -> None:
        key = (tenant, h)
        if op == "pub":
            self._holders.setdefault(key, set()).add(replica)
            self.stats.published += 1
        else:
            rs = self._holders.get(key)
            if rs is not None:
                rs.discard(replica)
                if not rs:
                    del self._holders[key]
            self.stats.retracted += 1

    def retract_replica(self, tenant: str, replica: int) -> int:
        """Replica death: drop every holding of ``replica`` under
        ``tenant`` immediately.  Applied authoritatively — it bypasses
        ``defer_events`` and also purges the dead replica's *pending*
        events, so a queued publish cannot resurrect a dead holder at
        the next :meth:`sync`.  Returns the chains retracted."""
        n = 0
        for key in list(self._holders):
            if key[0] != tenant:
                continue
            rs = self._holders[key]
            if replica in rs:
                rs.discard(replica)
                self.stats.retracted += 1
                n += 1
                if not rs:
                    del self._holders[key]
        if self._pending:
            self._pending = deque(
                ev for ev in self._pending
                if not (ev[1] == tenant and ev[2] == replica))
        return n

    def staleness(self) -> int:
        """Pending (unapplied) events — 0 unless ``defer_events``."""
        return len(self._pending)

    def sync(self) -> int:
        """Apply all pending events; returns how many were applied."""
        n = len(self._pending)
        while self._pending:
            self._apply(*self._pending.popleft())
        return n

    # ----------------------------------------------------------- lookup
    def holders(self, tenant: str, h: int) -> Set[int]:
        return set(self._holders.get((tenant, h), ()))

    def lookup(self, tenant: str, tokens) -> Dict[int, int]:
        """Replica -> prompt tokens held as a CONTIGUOUS page-aligned
        prefix (a replica whose chain has a gap only counts up to the
        gap — exactly what ``match_prefix`` would attach).  At least the
        final token is always left uncovered, mirroring the prefix
        cache's TTFT = O(tail) contract."""
        self.stats.lookups += 1
        if tokens is None:
            return {}
        max_pages = (len(tokens) - 1) // self.page_size
        held: Dict[int, int] = {}
        alive: Optional[Set[int]] = None
        for i, h in enumerate(prefix_hashes(tokens, self.page_size,
                                            max_pages)):
            rs = self._holders.get((tenant, h), ())
            alive = set(rs) if alive is None else alive & set(rs)
            if not alive:
                break
            for r in alive:
                held[r] = (i + 1) * self.page_size
        if held:
            self.stats.hits += 1
        return held


@dataclass
class RouterConfig:
    """Bounds past which the cache route yields to least-loaded."""
    # max load lead (queue + active) the cache target may have over the
    # least-loaded replica before the router falls back — bounds how
    # much queue imbalance prefix affinity is allowed to create
    imbalance_bound: int = 4
    # max pending directory events before the directory is considered
    # too stale to trust (only nonzero under ``defer_events``)
    staleness_bound: int = 256


class CacheAwareRouter:
    """Route-to-longest-held-prefix dispatch over one tenant's replicas.

    ``route`` picks a replica index given the request and the replicas'
    current loads.  ``cache_aware=False`` is the blind baseline (pure
    least-loaded) — the A/B arm.  Every tie-break ends in the replica
    index, so the selection is a strict total order and identical
    traces replay identically."""

    def __init__(self, directory: PrefixDirectory, tenant: str,
                 cfg: Optional[RouterConfig] = None,
                 cache_aware: bool = True):
        self.directory = directory
        self.tenant = tenant
        self.cfg = cfg or RouterConfig()
        self.cache_aware = cache_aware
        self.stats = RoutingStats()
        self._dead: Set[int] = set()

    def mark_dead(self, replica: int) -> None:
        """Replica death: never route here again (the gateway also
        masks dead replicas with infinite load, which this guards even
        for held-prefix candidates)."""
        self._dead.add(replica)

    def route(self, req: Request, loads: Sequence[int]) -> int:
        """Replica index for ``req``.  Strict total orders:
        least-loaded = min (load, index); cache route = min
        (-held tokens, load, index) over the holding replicas."""
        live = [j for j in range(len(loads))
                if j not in self._dead and loads[j] != float("inf")]
        if not live:            # defensive: the gateway gates this case
            live = list(range(len(loads)))
        least = min(live, key=lambda j: (loads[j], j))
        if not self.cache_aware:
            self.stats.routed_blind += 1
            return least
        if self.directory.staleness() > self.cfg.staleness_bound:
            self.stats.fallback_stale += 1
            return least
        held = self.directory.lookup(self.tenant, req.prompt_tokens)
        held = {j: t for j, t in held.items() if j in live}
        if not held:
            self.stats.fallback_miss += 1
            return least
        best = min(held, key=lambda j: (-held[j], loads[j], j))
        if loads[best] - loads[least] > self.cfg.imbalance_bound:
            self.stats.fallback_imbalance += 1
            return least
        self.stats.routed_cache += 1
        return best


class ResponseCache:
    """LRU of committed outputs, keyed by (tenant, prompt-hash, params).

    ``params`` is the request's generation-parameter tuple — under this
    stack's greedy decode that is ``max_new_tokens`` (the rusets
    semantic-cache key shape: model+prompt+params; the model is fixed
    per engine fleet).  ``record`` stores a finished request's output;
    ``prime`` fills a later identical request's ``draft_hints`` so the
    n-gram drafter replays the cached completion and the model merely
    verifies it.  Client-supplied hints are never overwritten.  Shared
    safely across replicas: one replica's completion primes every
    replica's speculation."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._store: "OrderedDict[tuple, List[int]]" = OrderedDict()
        self.lookups = 0
        self.hits = 0
        self.inserts = 0
        self.evictions = 0
        self.partial_skips = 0

    @staticmethod
    def _key(req: Request) -> tuple:
        return (req.tenant, prompt_hash(req.prompt_tokens),
                req.max_new_tokens)

    def __len__(self) -> int:
        return len(self._store)

    def record(self, req: Request) -> None:
        """Remember a finished request's committed output (idempotent —
        greedy decode makes re-records identical).

        Terminal-verdict guard: only a *completed* generation records.
        Expired, preempted, or crash-drained partials carry real-looking
        ``output_tokens`` shorter than the request asked for; caching
        one would prime later identical requests with a truncated
        completion (rejected draft rows — wasted verify compute) and,
        worse, present the partial as a cached response."""
        if req.prompt_tokens is None or not req.output_tokens:
            return
        if req.generated < req.max_new_tokens and not req.done:
            self.partial_skips += 1
            return
        key = self._key(req)
        self._store.pop(key, None)
        self._store[key] = list(req.output_tokens)
        self.inserts += 1
        if len(self._store) > self.capacity:
            self._store.popitem(last=False)
            self.evictions += 1

    def prime(self, req: Request) -> bool:
        """Fill ``req.draft_hints`` from a cached completion of the same
        (tenant, prompt, params).  Returns whether it hit.  Requests
        that already carry client hints are left untouched (and not
        counted — the cache was never consulted)."""
        if req.prompt_tokens is None or req.draft_hints is not None:
            return False
        self.lookups += 1
        key = self._key(req)
        hit = self._store.get(key)
        if hit is None:
            return False
        self._store.move_to_end(key)
        self.hits += 1
        req.draft_hints = np.asarray(hit, np.int64)
        return True

    def hit_rate(self) -> float:
        if not self.lookups:
            return 0.0
        return self.hits / self.lookups
