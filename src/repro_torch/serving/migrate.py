"""Live lane migration: verified KV-page shipping between replicas (the
PyTorch twin of ``repro/serving/migrate.py``).

A lane's KV pages are serialized with per-page **chain hashes** (the int8
scales too when the pool is quantized) and the request's cursor and metric
stamps, shipped to the destination replica, verified, and re-linked into
the destination pool refcount-correctly, attaching to prefix pages the
destination already shares through its chain-hash index instead of copying
them.  The handshake is verify-then-commit: the importer recomputes every
chain hash and on ANY mismatch imports nothing, and the lane falls back to
the recompute redrive (greedy decode makes that token-identical).
:class:`MigrationPlanner` prices the transfer against the ledger's
per-root fabric demand.

``_pool_leaves``, ``_page_digest``, :class:`PageRecord`,
:class:`LaneManifest`, the verify step and :class:`MigrationPlanner` are
the reference's.  What touches the pools differs:

* the exporter reads a lane's pages with one device-to-host copy per pool
  leaf (``index_select`` then ``.cpu()``), and hands a bf16 leaf over as
  its raw bits in ``uint16``;
* the importer writes the fresh pages IN PLACE into the pool tensors
  (``index_copy_`` along the page axis: axis 1 of a stacked ``period``
  leaf), on the pool's device, where the JAX code builds new arrays with
  ``.at[].set``; it takes a bf16 payload by its itemsize, so a page
  exported by the JAX package (ml_dtypes' bfloat16) imports without
  ml_dtypes.

The digest hashes raw bytes, and IEEE bf16 bits are the same in both
frameworks, so a lane exported from a JAX replica verifies and imports
into a port replica (both keep pools ``[(repeats,) P, page, KV, hd]``).
A float32 or int8 lane exported by the port imports into a JAX replica;
a bf16 one would need its ``uint16`` payload viewed as bf16 first.

A runtime on a live ``model`` mesh holds a rank's KV heads of each page
(``paged_runtime.held_kv_heads``).  Its exporter gathers the lane's pages
over ``model`` (``launch/collectives.py``, so the bytes are tallied) and
keeps each head once, so a record holds every head and the manifest the
same bytes and digests as the unsharded runtime's; its importer writes
its own heads of each record.  Every rank exports and imports the same
lanes together: the export is a collective.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch import collectives as coll
from repro_torch.serving.kvcache import PageTableEntry
from repro_torch.serving.request import Request
from repro_torch.serving.sched import SeqState


def _pool_leaves(pools) -> Iterator[Tuple[str, str, str, str]]:
    """Stable iteration order over every page-pool leaf:
    ``(leaf_key, group, name, field)`` where group is ``prefix`` |
    ``period``.  The leaf key is what the chain hash covers, so the
    order must be deterministic across export and import."""
    for group in sorted(pools):
        for name in sorted(pools[group]):
            for fld in sorted(pools[group][name]):
                yield f"{group}/{name}/{fld}", group, name, fld


def _page_digest(prev: bytes, tokens: Tuple[int, ...],
                 payload: Dict[str, np.ndarray]) -> bytes:
    """Chained per-page hash: ties this page's KV bytes to the page's
    token content AND to the whole history before it (same recursive
    construction as the prefix cache's chain keys, but over the actual
    pool bytes).  A digest match at page *i* therefore vouches for the
    entire transfer up to *i*."""
    h = hashlib.sha256()
    h.update(prev)
    h.update(np.asarray(tokens, np.int64).tobytes())
    for key in sorted(payload):
        h.update(key.encode())
        h.update(np.ascontiguousarray(payload[key]).tobytes())
    return h.digest()


def _pages_to_host(pool: torch.Tensor, pages: List[int], group: str,
                   whole=None) -> np.ndarray:
    """The given pages of one pool leaf as a host array, the page axis
    where the pool has it (axis 1 of a stacked ``period`` leaf); ``whole``
    makes every KV head of the selection (its head axis given) from a
    rank's.  A bf16 leaf comes back as its raw bits in ``uint16`` (numpy
    has no bf16); the digest hashes bytes, so it equals the JAX package's
    for the same page."""
    axis = 1 if group == "period" else 0
    idx = torch.tensor(pages, dtype=torch.long, device=pool.device)
    sel = pool.index_select(axis, idx)
    if whole is not None:
        sel = whole(sel, axis + 2)
    sel = sel.to("cpu", copy=True)
    if sel.dtype == torch.bfloat16:
        return sel.view(torch.int16).numpy().view(np.uint16)
    return sel.numpy()


def _host_to_pool(arrays: List[np.ndarray], pool: torch.Tensor, axis: int,
                  key: str) -> torch.Tensor:
    """Stack one leaf's page payloads along the pool's page axis as a
    tensor of the pool's type on its device.  A bf16 pool takes any
    2-byte payload as raw bits (``uint16`` from the port, ml_dtypes'
    bfloat16 from the JAX package), read by its itemsize."""
    want = tuple(pool.shape[:axis]) + tuple(pool.shape[axis + 1:])
    for arr in arrays:
        if tuple(arr.shape) != want:
            raise ImportReject(f"payload leaf {key} has shape "
                               f"{tuple(arr.shape)}, the pool's pages "
                               f"{want}")
    host = np.stack([np.ascontiguousarray(a) for a in arrays], axis=axis)
    if pool.dtype == torch.bfloat16:
        if host.dtype.itemsize != 2:
            raise ImportReject(f"payload leaf {key} is not 2-byte bf16")
        src = torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
    else:
        src = torch.from_numpy(host)
        if src.dtype != pool.dtype:
            raise ImportReject(f"payload leaf {key} is {src.dtype}, the "
                               f"pool {pool.dtype}")
    return src.to(pool.device)


@dataclass
class PageRecord:
    """One shipped KV page: its token content (the valid rows), every
    pool leaf's bytes for that page, and the chain digest."""
    src_page: int                      # source pool id (debugging only)
    tokens: Tuple[int, ...]            # valid-row token content
    payload: Dict[str, np.ndarray]     # leaf key -> page bytes
    digest: bytes                      # chained sha256 (see _page_digest)

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.payload.values()) \
            + 8 * len(self.tokens)


@dataclass
class LaneManifest:
    """Everything one lane needs to resume on another replica: the
    request's cursor/metric stamps (snapshotted BEFORE the drain resets
    them) plus the page chain.  ``pages == []`` is a *cold* manifest —
    the lane held no KV (still queued) or the caller chose recompute."""
    req: Request
    prompt_tokens: np.ndarray
    prefilled: int = 0
    generated: int = 0
    output_tokens: List[int] = field(default_factory=list)
    decode_times: List[float] = field(default_factory=list)
    last_token: int = 0
    prefix_hit: int = 0
    chunks_done: int = 0
    cache_tokens: int = 0              # tokens resident in the pages
    pages: List[PageRecord] = field(default_factory=list)

    @property
    def warm(self) -> bool:
        return bool(self.pages)

    @property
    def total_bytes(self) -> int:
        return sum(p.nbytes for p in self.pages)

    def history(self) -> np.ndarray:
        """The lane's true token history covered by the cache: prompt
        then committed output, truncated to ``cache_tokens``."""
        out = np.asarray(self.output_tokens, np.int64)
        prm = np.asarray(self.prompt_tokens, np.int64)
        return np.concatenate([prm, out])[: self.cache_tokens]


def _split_heads(runtime) -> bool:
    """Whether the runtime's pools hold only some KV heads (a rank of a
    live ``model`` mesh)."""
    return len(runtime.kv_heads) != runtime.cfg.attn.num_kv_heads


class PageExporter:
    """Serialize a paged runtime's resident lanes into
    :class:`LaneManifest` objects.  Must run BEFORE
    ``drain_for_redrive()`` — the drain resets the request cursors the
    manifest snapshots.  On a live ``model`` mesh every rank exports the
    same lanes together (module docstring)."""

    def __init__(self, runtime):
        self.rt = runtime
        self._keep = None
        if _split_heads(runtime):
            # each head's place among the gathered ranks' held heads: the
            # first rank that holds it
            from repro_torch.serving.paged_runtime import held_kv_heads
            part, held = runtime.part, len(runtime.kv_heads)
            place = {}
            for r in range(part.m):
                for i, h in enumerate(held_kv_heads(runtime.cfg, part.m, r)):
                    place.setdefault(h, r * held + i)
            self._keep = [place[h] for h in sorted(place)]

    def _whole(self, sel: torch.Tensor, dim: int) -> torch.Tensor:
        """Every KV head of ``sel`` (this rank's held heads along
        ``dim``): the ``model`` ranks' gathered, each head kept once."""
        out = coll.all_gather(sel, self.rt.part.tp, dim)
        if out.shape[dim] == len(self._keep):
            return out
        idx = torch.tensor(self._keep, dtype=torch.long, device=out.device)
        return out.index_select(dim, idx)

    def export_lane(self, seq: SeqState) -> LaneManifest:
        req = seq.req
        man = LaneManifest(
            req=req,
            prompt_tokens=np.asarray(req.prompt_tokens, np.int64)
            if req.prompt_tokens is not None else np.zeros(0, np.int64),
            prefilled=seq.prefilled, generated=req.generated,
            output_tokens=list(req.output_tokens),
            decode_times=list(req.decode_times),
            last_token=seq.last_token, prefix_hit=seq.prefix_hit,
            chunks_done=seq.chunks_done)
        kv = self.rt.kv
        entry = kv.tables.get(req.req_id)
        if entry is None:
            return man                                # cold: no pages
        # tokens actually resident: an in-flight prefill holds exactly
        # ``prefilled``; a decode lane holds prompt + generated-1 (the
        # newest token is only appended by the next step)
        if seq.prefilled < req.prompt_len:
            cache_tokens = seq.prefilled
        else:
            cache_tokens = req.prompt_len + max(0, req.generated - 1)
        cache_tokens = min(cache_tokens, entry.length)
        if cache_tokens <= 0:
            return man
        man.cache_tokens = cache_tokens
        hist = man.history()
        ps = kv.page_size
        pages = entry.pages[:kv.pages_needed(cache_tokens)]
        # one device-to-host copy per pool leaf for the whole lane
        whole = self._whole if self._keep is not None else None
        leaves = {key: _pages_to_host(self.rt.pools[group][name][fld],
                                      pages, group, whole)
                  for key, group, name, fld in _pool_leaves(self.rt.pools)}
        prev = b""
        for p, page in enumerate(pages):
            toks = tuple(int(t) for t in hist[p * ps:(p + 1) * ps])
            payload = {key: np.ascontiguousarray(arr[:, p] if key.startswith(
                "period/") else arr[p]) for key, arr in leaves.items()}
            prev = _page_digest(prev, toks, payload)
            man.pages.append(PageRecord(src_page=page, tokens=toks,
                                        payload=payload, digest=prev))
        return man

    def export_all(self) -> List[LaneManifest]:
        """Every resident lane, in-service first then queued (queued
        lanes hold no pages and export cold)."""
        sched = self.rt.sched
        seqs = list(sched.prefilling) + list(sched.active) \
            + list(sched.waiting)
        return [self.export_lane(s) for s in seqs]


class ImportReject(Exception):
    """Internal: a verify-then-commit check failed — the lane degrades
    to the recompute-redrive path (never surfaced to callers)."""


class PageImporter:
    """Re-link shipped lanes into a destination runtime's page pool,
    refcount-correctly, behind the verify-then-commit handshake.

    Commit order per lane: (1) recompute every chain hash — ANY
    mismatch rejects the whole lane before a single byte lands;
    (2) attach the longest run of full prompt pages the destination
    already shares (its chain-hash prefix index — a ref bump, zero
    copies); (3) allocate + write the remaining pages, rolling the
    attach back if the pool cannot hold them; (4) register the block
    table, publish the prompt pages to the destination's prefix index,
    restore the request cursors, and hand the lane to the scheduler.
    A rejected lane leaves the destination bit-identical to before the
    call.  On a live ``model`` mesh each rank writes its held KV heads of
    every record (module docstring)."""

    def __init__(self, runtime):
        self.rt = runtime
        self.imported_lanes = 0
        self.imported_pages = 0
        self.attached_pages = 0
        self.copied_pages = 0
        self.cold_lanes = 0          # no pages shipped: nothing to verify
        self.verify_failures = 0     # shipped but rejected -> recompute

    # ------------------------------------------------------------- verify
    def _verify(self, man: LaneManifest) -> None:
        hist = man.history()
        ps = self.rt.kv.page_size
        if man.cache_tokens > len(hist):
            raise ImportReject("cursor past token history")
        if (man.generated >= 1) != (man.prefilled >= man.req.prompt_len):
            raise ImportReject("inconsistent prefill/decode cursors")
        prev = b""
        for p, rec in enumerate(man.pages):
            want = tuple(int(t) for t in hist[p * ps:(p + 1) * ps])
            if rec.tokens != want:
                raise ImportReject(f"page {p} token mismatch")
            prev = _page_digest(prev, rec.tokens, rec.payload)
            if prev != rec.digest:
                raise ImportReject(f"page {p} chain-hash mismatch")

    # ------------------------------------------------------------- commit
    def _held(self, arr: np.ndarray, dim: int, key: str) -> np.ndarray:
        """A record's page of one leaf cut to the KV heads (along ``dim``)
        this runtime's pools hold; a page without every head rejects."""
        heads, total = self.rt.kv_heads, self.rt.cfg.attn.num_kv_heads
        if arr.ndim <= dim or arr.shape[dim] != total:
            raise ImportReject(f"payload leaf {key} does not hold the "
                               f"{total} KV heads")
        return arr[(slice(None),) * dim + (slice(heads.start, heads.stop),)]

    def _write_pages(self, recs: List[PageRecord],
                     dst_pages: List[int]) -> None:
        """Write each record's leaves (this rank's KV heads of them on a
        ``model`` mesh) into its destination page, in place in the pool
        tensors (one host-to-device copy per leaf); a missing leaf or one
        whose shape or type does not fit the pool rejects."""
        pools = self.rt.pools
        split = _split_heads(self.rt)
        writes = []
        for key, group, name, fld in _pool_leaves(pools):
            if any(key not in rec.payload for rec in recs):
                raise ImportReject(f"payload leaf {key} missing")
            pool = pools[group][name][fld]
            axis = 1 if group == "period" else 0
            pages = [rec.payload[key] for rec in recs]
            if split:
                pages = [self._held(a, axis + 1, key) for a in pages]
            src = _host_to_pool(pages, pool, axis, key)
            writes.append((pool, axis, src))
        idx = torch.tensor(dst_pages, dtype=torch.long,
                           device=writes[0][0].device if writes else "cpu")
        for pool, axis, src in writes:
            pool.index_copy_(axis, idx, src)

    def import_lane(self, man: LaneManifest) -> bool:
        """Verify-then-commit one lane.  True iff the lane is now
        resident on the destination; False means the caller must fall
        back to the recompute redrive (the destination is untouched)."""
        kv, sched = self.rt.kv, self.rt.sched
        req = man.req
        if not man.warm:
            self.cold_lanes += 1
            return False
        try:
            if req.req_id in kv.tables:
                raise ImportReject("req_id already resident")
            self._verify(man)
        except ImportReject:
            self.verify_failures += 1
            return False

        ps = kv.page_size
        n_pages = len(man.pages)
        # full prompt pages are attachable through the destination's
        # chain-hash index — the same key construction the digest chain
        # vouches for, so an index hit IS a verified content match
        n_prompt_full = min(man.cache_tokens, req.prompt_len) // ps
        attached: List[int] = []
        if kv.enable_prefix_cache:
            for _, key in kv._chain_keys(man.prompt_tokens, n_prompt_full):
                page = kv.prefix_index.get(key)
                if page is None:
                    break
                attached.append(page)
        for page in attached:
            kv.ref[page] = kv.ref.get(page, 0) + 1
            kv.cached.pop(page, None)
        fresh: List[int] = []
        try:
            for rec in man.pages[len(attached):]:
                fresh.append(kv._alloc_page())
            if fresh:
                self._write_pages(man.pages[len(attached):], fresh)
        except (MemoryError, ImportReject):
            for page in fresh + attached:             # full rollback
                kv._drop_page_ref(page)
            self.verify_failures += 1
            return False

        entry = PageTableEntry(req.req_id, pages=attached + fresh,
                               length=man.cache_tokens,
                               shared_tokens=len(attached) * ps)
        kv.tables[req.req_id] = entry
        kv.commit_prefix(req.req_id, man.prompt_tokens,
                         min(man.cache_tokens, req.prompt_len))

        # restore the request's cursor/metric stamps (the source drain
        # reset them after export); TTFT/decode stamps are conserved —
        # a warm lane resumes, it does not restart
        req.generated = man.generated
        req.output_tokens[:] = man.output_tokens
        req.decode_times[:] = man.decode_times
        req.slot = -1
        seq = SeqState(req, prefilled=man.prefilled,
                       last_token=man.last_token,
                       prefix_hit=man.prefix_hit,
                       chunks_done=man.chunks_done)
        if man.prefilled >= req.prompt_len:
            sched.active.append(seq)
        else:
            sched.prefilling.append(seq)
        self.imported_lanes += 1
        self.imported_pages += n_pages
        self.attached_pages += len(attached)
        self.copied_pages += len(fresh)
        return True


@dataclass(frozen=True)
class MigrationPlan:
    """A priced transfer: how many lanes/pages/bytes move and how long
    the fabric share makes the copy take."""
    lanes: int
    warm_lanes: int
    pages: int
    bytes: int
    bandwidth: float
    transfer_s: float


class MigrationPlanner:
    """Price a migration against the fabric the way every other flow is
    priced: the transfer's bandwidth is the capacity left on the more
    contended of the two root complexes involved (per the ledger's
    per-root demand bookkeeping), floored at ``min_frac`` of capacity —
    a PS flow never fully starves.  Without a ledger/topology the
    planner falls back to raw capacity (single-host tests)."""

    def __init__(self, fabric=None, topo=None, ledger=None,
                 min_frac: float = 0.1, setup_s: float = 0.005):
        self.fabric = fabric
        self.topo = topo
        self.ledger = ledger
        self.min_frac = min_frac
        self.setup_s = setup_s

    def _root_bandwidth(self, device: Optional[str]) -> float:
        cap = self.fabric.pcie_capacity if self.fabric is not None else 25e9
        if device is None or self.topo is None or self.ledger is None:
            return cap
        demand = self.ledger.root_demand(self.topo.root_of(device))
        return max(self.min_frac * cap, cap - demand)

    def price(self, manifests: List[LaneManifest],
              src_device: Optional[str] = None,
              dst_device: Optional[str] = None) -> MigrationPlan:
        total = sum(m.total_bytes for m in manifests)
        pages = sum(len(m.pages) for m in manifests)
        warm = sum(1 for m in manifests if m.warm)
        bw = min(self._root_bandwidth(src_device),
                 self._root_bandwidth(dst_device))
        transfer_s = self.setup_s + (total / bw if total else 0.0)
        return MigrationPlan(lanes=len(manifests), warm_lanes=warm,
                             pages=pages, bytes=total, bandwidth=bw,
                             transfer_s=transfer_s)
