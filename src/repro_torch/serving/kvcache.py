"""Paged KV cache management (vLLM-style) for the serving engine.

Host-side page-table bookkeeping (free list, per-sequence block tables,
per-page refcounts, prefix-cache index) plus device-side page pools
consumed by the ``paged_attention`` Pallas kernel.  The dense slot-cache
path used by the pure-jnp models shares the same accounting so admission
control sees identical memory pressure either way.

Pages are *refcounted*: a page normally belongs to one sequence, but the
prefix cache lets many sequences map the same physical page (shared
system/common prompt prefixes).  The sharing contract is page-aligned
copy-on-write by construction: only FULL pages are ever shared, a
sequence's writes always land at positions past its shared prefix (which
is page-aligned), so a shared page is immutable while it has sharers and
divergence mid-page simply misses the index and allocates a private page.

Prefix index: each full prompt page is keyed by the chain
``key = (parent_key, page_tokens)`` — a collision-free recursive tuple —
so a hit at page *i* guarantees the entire token history up to *i* matches.
When a shared page's refcount drops to zero it parks on a ``cached`` LRU
(content intact, still matchable) instead of the free list; allocation
prefers truly-free pages and only then evicts cached pages LRU-first, so
prefix reuse never costs live capacity.

Occupancy views (they differ under the dense engine's conservative
prompt+max_new reservation, under the paged runtime's grow-on-demand
reservation, and under prefix sharing):

  * ``reserved_pages`` — distinct pages held by live sequences (capacity
    pressure: what admission must respect — cached pages are reclaimable
    and do NOT count);
  * ``used_pages``     — distinct pages holding live KV (what the decode
    kernels actually read);
  * ``cached_pages``   — refcount-zero prefix pages kept warm for reuse.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class PageTableEntry:
    seq_id: int
    pages: List[int] = field(default_factory=list)
    length: int = 0
    shared_tokens: int = 0     # prefix tokens mapped from the cache


class PagedKVCache:
    """Page pool allocator: fixed pool of ``num_pages`` pages of
    ``page_size`` tokens each, allocated per sequence on demand, with
    refcounted cross-sequence prefix sharing."""

    def __init__(self, num_pages: int, page_size: int,
                 enable_prefix_cache: bool = True):
        self.num_pages = num_pages
        self.page_size = page_size
        self.enable_prefix_cache = enable_prefix_cache
        self.free: List[int] = list(range(num_pages - 1, -1, -1))
        self.tables: Dict[int, PageTableEntry] = {}
        self.ref: Dict[int, int] = {}              # page -> live sharers
        # prefix cache state (all empty when disabled)
        self.prefix_index: Dict[tuple, int] = {}   # chain key -> page
        self.page_key: Dict[int, tuple] = {}       # page -> chain key
        self.cached: "OrderedDict[int, None]" = OrderedDict()  # LRU, ref==0
        # optional event sink (duck-typed: ``on_commit(chain_key,
        # upto_tokens)`` / ``on_evict(chain_key)``) — the cluster-wide
        # PrefixDirectory subscribes here so the dispatcher learns which
        # replica holds which page-aligned prefix.  Events fire when an
        # index entry is born (commit_prefix) or dies (cached-page
        # eviction); a listener that lags is stale-but-SAFE: routing on
        # stale holdings only costs a prefix-cache miss, never a token
        self.listener = None

    # -- allocation ---------------------------------------------------------
    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        need = self.pages_needed(prompt_len + max_new)
        return len(self.free) + len(self.cached) >= need

    def pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def _alloc_page(self) -> int:
        """One fresh page: the free list first, then LRU eviction of
        refcount-zero cached prefix pages (their index entries die with
        them — a page with live sharers is never here, so sharing is
        never broken by allocation pressure)."""
        if self.free:
            page = self.free.pop()
        elif self.cached:
            page, _ = self.cached.popitem(last=False)
            key = self.page_key.pop(page)
            del self.prefix_index[key]
            if self.listener is not None:
                self.listener.on_evict(key)
        else:
            raise MemoryError("KV page pool exhausted")
        self.ref[page] = 1
        return page

    def allocate(self, seq_id: int, prompt_len: int,
                 reserve_total: int | None = None) -> PageTableEntry:
        """Allocates pages for ``reserve_total`` tokens up front (defaults
        to prompt_len).  Reserving prompt+max_new at admission guarantees
        append_token never exhausts the pool mid-decode (vLLM-conservative
        reservation; admission control enforces the budget)."""
        assert seq_id not in self.tables, f"seq {seq_id} already allocated"
        entry = PageTableEntry(seq_id)
        self.tables[seq_id] = entry
        self._grow(entry, reserve_total or prompt_len)
        entry.length = prompt_len
        return entry

    def append_token(self, seq_id: int) -> None:
        entry = self.tables[seq_id]
        self._grow(entry, entry.length + 1)
        entry.length += 1

    def reserve(self, seq_id: int, target_tokens: int) -> None:
        """Grow a sequence's page list to cover ``target_tokens`` WITHOUT
        marking them live — the paged runtime reserves before launching a
        forward pass (the device scatter needs real page ids), then calls
        :meth:`extend` once the tokens are actually written.  Allocates the
        sequence lazily on first use (the paged runtime does not reserve
        prompt+max_new at submit).  Raises MemoryError when the pool is
        exhausted; partial growth is kept (tracked, released on release())."""
        entry = self.tables.get(seq_id)
        if entry is None:
            entry = PageTableEntry(seq_id)
            self.tables[seq_id] = entry
        self._grow(entry, target_tokens)

    def extend(self, seq_id: int, target_tokens: int) -> None:
        """Mark the sequence as holding ``target_tokens`` live tokens
        (monotone), growing pages if the caller skipped reserve()."""
        entry = self.tables[seq_id]
        self._grow(entry, target_tokens)
        entry.length = max(entry.length, target_tokens)

    def _grow(self, entry: PageTableEntry, target_tokens: int) -> None:
        need = self.pages_needed(target_tokens)
        while len(entry.pages) < need:
            entry.pages.append(self._alloc_page())

    def release(self, seq_id: int) -> None:
        """Drop one sequence's references.  Pages whose refcount hits zero
        return to the free list — unless they are indexed prefix pages,
        which park on the cached LRU with their KV intact.  A page with
        remaining sharers is left untouched (never freed under a live
        sharer).  Releasing an unknown / already-released ``seq_id``
        raises: silently ignoring it would hand the same pages out twice
        and corrupt every sharer's KV."""
        entry = self.tables.pop(seq_id, None)
        if entry is None:
            raise KeyError(
                f"release() of unknown or already-released seq {seq_id} — "
                f"double-release would re-free shared pages and corrupt "
                f"the free list")
        for page in entry.pages:
            self._drop_page_ref(page)

    def release_all(self) -> int:
        """Release every live sequence at once (replica teardown / drain
        safety net).  Returns the number of sequences released.  After
        this, ``reserved_pages == 0``: every page is either free or
        parked on the cached prefix LRU."""
        seqs = list(self.tables)
        for seq_id in seqs:
            self.release(seq_id)
        return len(seqs)

    def _drop_page_ref(self, page: int) -> None:
        """One sequence stops referencing ``page``: decrement, and on
        refcount zero return it to the free list (or park an indexed
        prefix page on the cached LRU, KV intact)."""
        self.ref[page] -= 1
        if self.ref[page] > 0:
            return
        del self.ref[page]
        if self.enable_prefix_cache and page in self.page_key:
            self.cached[page] = None         # appends at the LRU tail
        else:
            self.free.append(page)

    def truncate(self, seq_id: int, new_len: int) -> None:
        """Roll a sequence back to ``new_len`` tokens, freeing the pages
        past ``pages_needed(new_len)`` (page-granular: a partially-covered
        final page is kept).  This is the speculative-decode rollback
        primitive — rejected draft tokens over-extended the sequence and
        their pages must return to the pool without reaching into the
        allocator's internals.

        Truncating into a *shared* page (refcount > 1) raises ValueError
        before any state changes: a shared page's KV is live for its other
        sharers, so rolling it back would corrupt them.  In practice
        shared pages cover the page-aligned prompt prefix, which is always
        below any decode rollback point; hitting this error means the
        caller computed a bogus ``new_len``."""
        if new_len < 0:
            raise ValueError(f"truncate to negative length {new_len}")
        entry = self.tables[seq_id]
        keep = self.pages_needed(new_len)
        drop = entry.pages[keep:]
        for page in drop:
            if self.ref.get(page, 0) > 1:
                raise ValueError(
                    f"truncate(seq {seq_id}, {new_len}) would roll back "
                    f"shared page {page} (refcount {self.ref[page]}) — "
                    f"shared pages are live for their other sharers and "
                    f"must never be rolled back")
        for page in drop:
            self._drop_page_ref(page)
        del entry.pages[keep:]
        entry.length = min(entry.length, new_len)
        entry.shared_tokens = min(entry.shared_tokens, new_len)

    # -- prefix sharing -----------------------------------------------------
    def _chain_keys(self, tokens, n_pages: int):
        """Chained per-page keys for the first ``n_pages`` full pages."""
        key: Optional[tuple] = None
        ps = self.page_size
        for p in range(n_pages):
            chunk = tuple(int(t) for t in tokens[p * ps:(p + 1) * ps])
            key = (key, chunk)
            yield p, key

    def match_prefix(self, seq_id: int, tokens) -> int:
        """Map the longest cached page-aligned prefix of ``tokens`` into
        ``seq_id``'s block table (bumping refcounts) and mark it live.
        At least the final token is always left uncovered so the tail
        prefill still produces the first-token logits (TTFT = O(tail)).
        Returns the number of prompt tokens covered.  Only valid before
        the sequence holds any pages."""
        if not self.enable_prefix_cache or tokens is None:
            return 0
        entry = self.tables.get(seq_id)
        if entry is not None and entry.pages:
            return 0
        max_pages = (len(tokens) - 1) // self.page_size
        attached: List[int] = []
        for _, key in self._chain_keys(tokens, max_pages):
            page = self.prefix_index.get(key)
            if page is None:
                break
            attached.append(page)
        if not attached:
            return 0
        if entry is None:
            entry = PageTableEntry(seq_id)
            self.tables[seq_id] = entry
        for page in attached:
            self.ref[page] = self.ref.get(page, 0) + 1
            self.cached.pop(page, None)
        entry.pages.extend(attached)
        entry.length = len(attached) * self.page_size
        entry.shared_tokens = entry.length
        return entry.length

    def commit_prefix(self, seq_id: int, tokens, upto_tokens: int) -> None:
        """Publish ``seq_id``'s fully-written prompt pages (the first
        ``upto_tokens`` are live) into the prefix index so later requests
        can share them.  Idempotent; pages already indexed (their own or
        a colliding chain) are skipped — the sequence then simply keeps a
        private copy."""
        if not self.enable_prefix_cache or tokens is None:
            return
        entry = self.tables.get(seq_id)
        if entry is None:
            return
        n_pages = min(upto_tokens, len(tokens)) // self.page_size
        for p, key in self._chain_keys(tokens, n_pages):
            page = entry.pages[p]
            if page in self.page_key or key in self.prefix_index:
                continue
            self.prefix_index[key] = page
            self.page_key[page] = key
            if self.listener is not None:
                self.listener.on_commit(key, (p + 1) * self.page_size)

    # -- views --------------------------------------------------------------
    def block_table(self, seq_id: int, pages_per_seq: int) -> np.ndarray:
        entry = self.tables[seq_id]
        if len(entry.pages) > pages_per_seq:
            raise ValueError(
                f"seq {seq_id} holds {len(entry.pages)} pages but the block "
                f"table is only {pages_per_seq} wide — a truncated table "
                f"would make the kernel read the wrong pages")
        out = np.zeros(pages_per_seq, np.int32)
        out[: len(entry.pages)] = entry.pages
        return out

    def utilisation(self) -> float:
        """Live-reserved fraction of the pool (capacity pressure)."""
        return self.reserved_pages / self.num_pages

    def live_utilisation(self) -> float:
        """Fraction of the pool holding live KV."""
        return self.used_pages / self.num_pages

    @property
    def reserved_pages(self) -> int:
        """Distinct pages held by live sequences (cached prefix pages are
        reclaimable and excluded)."""
        return self.num_pages - len(self.free) - len(self.cached)

    @property
    def used_pages(self) -> int:
        """Distinct pages backing live KV (tokens actually written or
        mapped from the prefix cache) — shared pages count once."""
        live = set()
        for e in self.tables.values():
            live.update(e.pages[: self.pages_needed(e.length)])
        return len(live)

    @property
    def cached_pages(self) -> int:
        return len(self.cached)
