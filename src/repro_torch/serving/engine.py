"""Continuous-batching serving engine with two interchangeable backends: the
PyTorch twin of ``repro/serving/engine.py``.

One engine serves one tenant's model on one device.  It performs *one unit
of work* per ``step()`` call and reports the measured compute seconds
(the device is synchronised before and after, so they are the step's
device time plus its host work).  The harness decides what virtual time
the step consumed and then calls ``finalize_step`` so TTFT and completion
timestamps reflect the environment.

Backends (``backend=`` ctor arg, same public API either way):

* ``"dense"`` (the default, as in the reference) — the slot cache:
  ``[max_slots, seq_cap]`` KV (or RWKV state) per layer, whole-prompt
  prefill of one request per step, one batched decode step over every
  slot; prompt+max_new pages are reserved at submit and admission rejects
  when the pool is full.
* ``"paged"`` — the block-table runtime (``serving/paged_runtime.py``):
  one fused mixed prefill+decode pass per step over a page pool.

Differences from the reference's dense backend, none of which changes a
token: the slot merge and every decode write go IN PLACE into the stacked
cache (the JAX code builds a new cache); the timed region of a prefill
covers the merge into the slot cache; a request whose tokens exceed
``seq_cap`` is refused (``EXCEEDS_SEQ_CAP``) where the reference would
write past the cache.

Two faults of the reference's dense backend are repaired here (ROADMAP
Queue C).  A VLM request's image prefix counts: after prefill the slot
decodes at ``num_prefix + prompt_len``, not at ``prompt_len``, which would
overwrite the prefix's K/V and rope at the wrong position, and the
prefix counts against ``seq_cap``.  An enc-dec model is served: the slot
cache holds each layer's cross-attention K/V over ``enc_cap = seq_cap``
frames with a per-slot count of valid frames (``cross_len``), which
decode masks by; the decoder, fed the BOS token alone, decodes from
position 1.  (The reference plans its slot cache without the cross
leaves, so its first enc-dec prefill fails to merge, and it would decode
from ``prompt_len``.)  Page accounting stays the reference's:
prompt+max_new pages reserved at submit, whatever the model.

Serving on a live mesh (``policy=`` and ``mesh=``, the reference's
keyword; ROADMAP A7.7): every rank builds the same engine and is given
the same requests, runs the same scheduler, and stores its share of the
parameters (``shard_tree`` of their resolved specs), of the slot cache
(``cache_plan(..., policy)``'s specs: the slots split over the batch axes
``("pod", "data")`` major first, the heads or the sequence over
``model``) or of the page pools (the KV heads its query heads read); the
model functions run on its shares through a ``models/partition.py::Part``
and every rank reads the whole logits.  A prefill's one row is computed
alike by every batch rank (the parameters gathered over the batch axes
layer by layer) and kept by the rank whose share holds the slot; a
decode step runs each rank's slots' rows and gathers the logits over the
batch axes.  The policy must be ``make_policy``'s for a decode shape on
that mesh, and the paged backend runs on a mesh whose batch axes have
one rank (``serving_part`` says what is refused).  Without a mesh the
policy changes nothing, as the reference's ``shard()`` outside a mesh.

Guardrail hook (paper §2.2, MPS-quota analogue): ``set_quota(frac)`` caps
the engine's concurrency, as in the reference: the number of active decode
slots (dense) or running lanes (paged) scales with the quota, bounding
occupancy the way CUDA_MPS_ACTIVE_THREAD_PERCENTAGE bounds SM occupancy.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import collectives as coll
from repro_torch.launch.mesh import batch_axes, mesh_view
from repro_torch.launch.shardings import (axes_of, make_policy, shard_tree,
                                          zip_map)
from repro_torch.launch.steps import cut_to_stored
from repro_torch.models.common import NO_POLICY, ShardPolicy
from repro_torch.models.model import (Model, cache_plan, decode_step,
                                      model_plan, prefill)
from repro_torch.models.params import (P, map_plan, pspecs_from_plan,
                                       torch_dtype)
from repro_torch.models.partition import make_part
from repro_torch.serving.kvcache import PagedKVCache
from repro_torch.serving.metrics import TenantMetrics
from repro_torch.serving.request import (ADMITTED, EXCEEDS_SEQ_CAP,
                                         POOL_EXHAUSTED, Request,
                                         SubmitOutcome)


def init_cache_from_plan(plan, device):
    """Zero-initialised cache on ``device`` (pos arrays get -1)."""
    def leaf(p: P):
        if p.dtype == "int32":
            return torch.full(p.shape, -1, dtype=torch.int32, device=device)
        return torch.zeros(p.shape, dtype=torch_dtype(p.dtype),
                           device=device)
    return map_plan(leaf, plan)


def serving_part(cfg: ModelConfig, policy: ShardPolicy, mesh, backend: str,
                 max_slots: int):
    """The partition an engine serves under on a live mesh (its cache
    specs not yet set), or None without a mesh.  Refuses (``ValueError``,
    naming ROADMAP A7.7) a mesh without a policy, a policy other than
    ``make_policy``'s for a decode shape on the mesh (its batched one
    when the batch axes have more than one rank), ``max_slots`` that the
    batch ranks do not divide, and, in the paged backend, batch axes of
    more than one rank and query heads that do not fall on whole KV heads
    of a rank (``paged_runtime.held_kv_heads``)."""
    if mesh is None:
        return None
    view = mesh_view(mesh)
    if policy is None or policy == NO_POLICY:
        raise ValueError("a mesh needs a policy (make_policy of a decode "
                         "shape on it) to serve under (ROADMAP A7.7)")
    wide = {a: view.shape[a] for a in batch_axes(view) if view.shape[a] > 1}
    if wide and backend == "paged":
        raise ValueError(
            f"batch axes {sorted(wide)} have more than one rank: the paged "
            f"runtime packs every lane into one row of batch 1, as the "
            f"reference's does, and its policy cannot split that over the "
            f"batch axes either; replicas are served as separate engines "
            f"(ROADMAP A7.7)")
    ranks = int(np.prod(list(wide.values()), dtype=np.int64))
    if max_slots % ranks:
        raise ValueError(
            f"{max_slots} slots do not divide the {ranks} ranks of the batch "
            f"axes {sorted(wide)}: the policy's sharding cannot split the "
            f"slot cache (ROADMAP A7.7)")
    decode = [make_policy(cfg, InputShape("serve", 2, b, "decode"), view)
              for b in ((2,) if wide else (2, 1))]
    if policy not in decode:
        act = policy.act or ()
        why = ("splits the sequence (a train or prefill step's "
               "seq_parallel)" if len(act) > 1 and act[1] is not None
               else "is not make_policy's for a decode shape on this mesh")
        raise ValueError(f"the policy {why}; an engine serves under "
                         f"{decode[0]} (ROADMAP A7.7)")
    if backend == "paged":
        from repro_torch.serving.paged_runtime import held_kv_heads
        held_kv_heads(cfg, view.shape.get("model", 1), 0)
    return make_part(mesh, policy, pspecs_from_plan(model_plan(cfg), mesh))


def local_plan(plan, specs, mesh):
    """``plan`` with each leaf's shape cut to this rank's shard under its
    resolved spec."""
    sizes = mesh_view(mesh).shape

    def leaf(p: P, spec) -> P:
        shape = list(p.shape)
        for dim, entry in enumerate(spec):
            for a in axes_of(entry):
                shape[dim] //= sizes[a]
        return dataclasses.replace(p, shape=tuple(shape))
    return zip_map(leaf, plan, specs)


def _pad_frames(cache1, frames: int):
    """An enc-dec prefill cache with its cross-attention K/V padded with
    zero frames to the slot's ``frames`` (the rest of the slot is masked
    by ``cross_len``), so that a split of the frames cuts it as the slot
    cache is cut."""
    def walk(tree):
        out = {}
        for key, val in tree.items():
            if key in ("ck", "cv"):
                dim = val.dim() - 3
                pad = list(val.shape)
                pad[dim] = frames - val.shape[dim]
                val = torch.cat([val, val.new_zeros(pad)], dim=dim)
            elif isinstance(val, dict):
                val = walk(val)
            out[key] = val
        return out
    return walk(cache1)


def _copy_leaves(dst, src, write) -> None:
    """``write(dst_leaf, src_leaf)`` for every leaf of two equal trees."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_leaves(dst[k], src[k], write)
    else:
        write(dst, src)


@dataclass
class StepReport:
    kind: str                 # "prefill" | "decode" | "mixed" | "idle"
    compute_s: float = 0.0
    tokens: int = 0                      # total tokens this step
    prefill_tokens: int = 0              # prompt tokens written this step
    decode_tokens: int = 0               # decode tokens emitted this step
    # requests whose first token was emitted this step (TTFT events);
    # a fused mixed step can complete several prefills at once
    prefilled: List[Request] = field(default_factory=list)
    decoded: List[Request] = field(default_factory=list)
    completed: List[Request] = field(default_factory=list)
    # sequences evicted (pages released, requeued for a full restart) by
    # SLO-aware preemption during this step
    preempted: List[Request] = field(default_factory=list)
    # prompt tokens served from the shared prefix cache while planning
    # this step (prefill compute skipped entirely)
    prefix_hit_tokens: int = 0
    # speculative decode lanes (spec_k > 0): draft rows verified this
    # step, and how many of them the model accepted — decode_tokens
    # already counts every committed token (base + accepted)
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    # --- flight-recorder detail ------------------------------------------
    # prefill work per request this step: (req, token_start, chunk_len,
    # chunk_index), one entry per planned chunk
    chunks: List[tuple] = field(default_factory=list)
    # per-lane speculative verify outcome: (req, drafted, accepted), only
    # for lanes that carried a draft this step
    spec: List[tuple] = field(default_factory=list)
    # preemption detail: (victim_req_id, beneficiary_req_id) pairs, the
    # same tuples the scheduler appends to its preempt_log this step
    preempt_pairs: List[tuple] = field(default_factory=list)


class ServingEngine:
    """``params`` is a nested dict of tensors with the JAX plan's names (for
    instance from ``models/bridge.py``); ``None`` initialises random weights
    on ``device`` from a ``torch.Generator`` seeded with ``seed``.

    ``attn_impl`` routes every kernel of the path ("auto": the CUDA kernel
    on CUDA tensors, the plain version on the CPU; "kernel"; "ref").

    ``policy`` and ``mesh``: serve on a live mesh (module docstring;
    ``serving_part`` says what is refused); ``params`` are then the whole
    weights and ``self.params`` this rank's shards."""

    def __init__(self, cfg: ModelConfig, params=None, *, max_slots: int = 8,
                 seq_cap: int = 256, page_size: int = 16, seed: int = 0,
                 backend: str = "dense", pool_pages: Optional[int] = None,
                 chunk_tokens: Optional[int] = None,
                 step_tokens: Optional[int] = None, attn_impl: str = "auto",
                 kv_dtype: str = "auto", prefix_cache: bool = True,
                 spec_k: int = 0, spec_ngram: int = 3, response_cache=None,
                 policy: ShardPolicy = NO_POLICY, mesh=None, device="cuda"):
        if backend not in ("dense", "paged"):
            raise ValueError(f"unknown backend {backend!r}")
        if kv_dtype != "auto" and backend == "dense":
            raise ValueError(
                "kv_dtype applies to the paged backend's page pools; the "
                "dense slot cache quantizes via REPRO_KV_INT8=1")
        if spec_k and backend == "dense":
            raise ValueError(
                "speculative decode lanes (spec_k) need the paged "
                "runtime's ragged verify step; use backend='paged'")
        if response_cache is not None and response_cache is not False \
                and backend == "dense":
            raise ValueError(
                "the response cache primes speculative draft hints at "
                "submit, which needs the paged scheduler; use "
                "backend='paged'")
        # response_cache: None/False = off, True = a private cache, or a
        # serving/directory.ResponseCache shared by a tenant's replicas.
        # Identity checks, not truthiness: an empty cache is falsy.
        if response_cache is True:
            from repro_torch.serving.directory import ResponseCache
            response_cache = ResponseCache()
        elif response_cache is False:
            response_cache = None
        self.response_cache = response_cache
        if backend == "paged":
            # before any weight is made
            from repro_torch.serving.paged_runtime import refuse_unsupported
            refuse_unsupported(cfg)
        self.policy, self.mesh = policy, mesh
        self.part = serving_part(cfg, policy, mesh, backend, max_slots)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = Model(cfg, params, seed=seed, device=self.device)
        if self.part is not None:
            self.model = Model(cfg, shard_tree(
                self.model.params, self.part.specs, mesh), device=self.device)
        self.params = self.model.params
        self.max_slots = max_slots
        self.seq_cap = seq_cap
        self.backend = backend
        self.attn_impl = attn_impl
        self.quota = 1.0
        self.metrics = TenantMetrics()
        # optional flight recorder with ``on_step(report, start, end,
        # engine=...)``: ``finalize_step`` folds each step into per-request
        # timelines.  None (the default) costs one guard per step.
        self.tracer = None
        # forward passes run (all, and the prefills among them); on the
        # paged backend every pass is a fused mixed step
        self.forward_passes = 0
        self.prefill_passes = 0
        if backend == "paged":
            from repro_torch.serving.paged_runtime import PagedRuntime
            self.runtime = PagedRuntime(
                cfg, self.params, max_slots=max_slots, seq_cap=seq_cap,
                page_size=page_size, pool_pages=pool_pages,
                chunk_tokens=chunk_tokens, step_tokens=step_tokens,
                attn_impl=attn_impl, kv_dtype=kv_dtype,
                prefix_cache=prefix_cache, spec_k=spec_k,
                spec_ngram=spec_ngram, response_cache=self.response_cache,
                seed=seed, policy=policy, mesh=mesh, device=self.device)
            self.kv = self.runtime.kv
            # the scheduler's waiting deque doubles as the engine queue
            # (the same object for the engine's lifetime), so load-based
            # dispatch reads ``len(engine.queue)`` on either backend
            self.queue = self.runtime.queue
            return
        self.runtime = None
        self._rng = np.random.default_rng(seed)
        self._finite = True
        self.queue: deque = deque()
        self.slots: List[Optional[Request]] = [None] * max_slots
        self.positions = np.zeros(max_slots, np.int32)
        self.last_token = np.zeros(max_slots, np.int32)
        # paged accounting mirrors the dense slot cache capacity
        self.kv = PagedKVCache(num_pages=max_slots * (seq_cap // page_size),
                               page_size=page_size)
        # an enc-dec slot holds up to seq_cap frames, cross_len[slot] of
        # them valid
        enc_cap = seq_cap if cfg.encoder is not None else 0
        self.enc_cap = enc_cap
        cplan = cache_plan(cfg, max_slots, seq_cap, enc_cap, policy=policy)
        if self.part is not None:
            c_specs = pspecs_from_plan(cplan, mesh)
            self.part = dataclasses.replace(self.part, cache_specs=c_specs)
            # a prefill's one row, computed alike by every batch rank
            self._prefill_part = self.part.alike_rows()
            # this rank's block of the slots, and (plan leaf, stored spec)
            # per leaf of one slot, for cutting a prefill's cache to this
            # rank's share of the slot cache
            self._slot_block = self.part.block(self.part.rows)
            one = cache_plan(cfg, 1, seq_cap, enc_cap, policy=policy)
            self._c_leaves = zip_map(lambda p, sp: (p, sp), one,
                                     pspecs_from_plan(one, mesh))
            cplan = local_plan(cplan, c_specs, mesh)
        self.cache = init_cache_from_plan(cplan, self.device)
        self.cross_len = (torch.zeros(max_slots, dtype=torch.int32,
                                      device=self.device)
                          if enc_cap else None)

    # ------------------------------------------------------------------ API
    def set_quota(self, frac: float) -> None:
        self.quota = float(np.clip(frac, 0.1, 1.0))
        if self.runtime is not None:
            self.runtime.set_budget(self.active_slot_budget)

    @property
    def active_slot_budget(self) -> int:
        return max(1, int(np.ceil(self.quota * self.max_slots)))

    @property
    def logits_finite(self) -> bool:
        """Whether every forward pass so far gave finite logits on the rows
        of live requests."""
        if self.runtime is not None:
            return self.runtime.logits_finite
        return self._finite

    def submit(self, req: Request) -> SubmitOutcome:
        """A falsy :class:`SubmitOutcome` when admission rejects.  The dense
        backend rejects whenever the conservative prompt+max_new page
        reservation does not fit (transient: the pool drains as requests
        finish); the paged backend only rejects requests that could NEVER
        fit and resolves pool pressure by preemption."""
        if self.runtime is not None:
            return self.runtime.submit(req)
        if self._slot_tokens(req) > self.seq_cap:
            return EXCEEDS_SEQ_CAP
        if not self.kv.can_admit(req.prompt_len, req.max_new_tokens):
            return POOL_EXHAUSTED
        self.kv.allocate(req.req_id, req.prompt_len,
                         req.prompt_len + req.max_new_tokens)
        self.queue.append(req)
        return ADMITTED

    def active(self) -> List[Request]:
        if self.runtime is not None:
            return self.runtime.running()
        return [r for r in self.slots if r is not None]

    def has_work(self) -> bool:
        if self.runtime is not None:
            return self.runtime.has_work()
        return bool(self.queue) or any(s is not None for s in self.slots)

    def drain_requests(self, ship_state: bool = False):
        """Replica death / planned drain: release every KV page and return
        the resident requests (queued, prefilling and decoding alike)
        rolled to a restartable state (outputs cleared, the original
        ``prefill_done`` stamp kept so TTFT is not double-counted).

        ``ship_state=True`` returns ``serving/migrate.LaneManifest``
        objects instead: the paged backend serializes each resident lane's
        KV pages (with chain hashes) BEFORE the drain resets its cursors,
        so a ``PageImporter`` on another replica can resume the lane warm;
        the dense backend holds no shippable page chains, so its manifests
        are cold (recompute is the only path)."""
        if self.runtime is not None:
            manifests = None
            if ship_state:
                from repro_torch.serving.migrate import PageExporter
                manifests = PageExporter(self.runtime).export_all()
            drained = self.runtime.drain_for_redrive()
            self.kv.release_all()        # safety net: no page outlives death
            return manifests if manifests is not None else drained
        drained = list(self.queue)
        self.queue.clear()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.slots[i] = None
            drained.append(req)
        for req in drained:
            req.generated = 0
            req.slot = -1
            req.output_tokens.clear()
            req.decode_times.clear()
        self.kv.release_all()
        if ship_state:
            from repro_torch.serving.migrate import LaneManifest
            return [LaneManifest(
                req=r,
                prompt_tokens=np.asarray(r.prompt_tokens, np.int64)
                if r.prompt_tokens is not None else np.zeros(0, np.int64))
                for r in drained]
        return drained

    # ----------------------------------------------------------------- step
    def step(self) -> StepReport:
        """One unit of work.  Compute time measured with a real clock."""
        report = self._step_backend()
        if report.kind != "idle":
            self.forward_passes += 1
            self.prefill_passes += bool(report.prefilled
                                        or report.prefill_tokens)
        self.metrics.observe_kv(self.kv.used_pages, self.kv.reserved_pages,
                                self.kv.num_pages)
        self.metrics.observe_prefill(report.prefill_tokens,
                                     report.prefix_hit_tokens)
        self.metrics.observe_spec(report.drafted_tokens,
                                  report.accepted_tokens)
        if self.runtime is not None:
            self.metrics.observe_response_cache(
                self.runtime.sched.rc_lookups, self.runtime.sched.rc_hits)
        return report

    def _step_backend(self) -> StepReport:
        if self.runtime is not None:
            return self.runtime.step()
        free = [i for i, s in enumerate(self.slots) if s is None]
        n_active = self.max_slots - len(free)
        if self.queue and free and n_active < self.active_slot_budget:
            return self._do_prefill(free[0])
        if n_active:
            return self._do_decode()
        return StepReport(kind="idle")

    def finalize_step(self, report: StepReport, end_time: float,
                      start_time: Optional[float] = None) -> None:
        """Record timestamps using the harness-provided completion time
        (``start_time`` is only read by the flight recorder)."""
        for req in report.prefilled:
            req.prefill_done = end_time
            # door-measured TTFT: from arrival at the front door
            self.metrics.latency.observe(end_time, (end_time - req.arrival),
                                         slo=(req.slo_ms or 0) / 1e3 or None,
                                         req_id=req.req_id)
            # engine-measured TTFT: from the engine's accept (gateway only)
            if req.submitted >= 0:
                self.metrics.engine_ttft.observe(
                    end_time, end_time - req.submitted, req_id=req.req_id)
        for req in report.decoded:
            prev = req.decode_times[-1] if req.decode_times \
                else req.prefill_done
            req.decode_times.append(end_time)
            if prev >= 0:
                self.metrics.itl.observe(end_time, end_time - prev,
                                         req_id=req.req_id)
        for req in report.completed:
            req.finished = end_time
        if report.tokens:
            self.metrics.observe_tokens(end_time, report.tokens)
        if self.tracer is not None:
            self.tracer.on_step(report, start_time, end_time,
                                engine=self.backend)

    # ------------------------------------------------------------ internals
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _slot_tokens(self, req: Request) -> int:
        """The most positions of a slot's self-attention cache the request
        fills: the image prefix, the prompt and the new tokens; for an
        enc-dec model the decoder's BOS and new tokens, or the prompt's
        frames if more (they fill the cross leaves, ``seq_cap`` long)."""
        if self.cfg.encoder is not None:
            return max(req.prompt_len, 1 + req.max_new_tokens)
        return (self.cfg.frontend.num_prefix + req.prompt_len
                + req.max_new_tokens)

    def _merge_slot_cache(self, cache1, slot: int) -> None:
        """Copy a single-sequence prefill cache into the batched slot cache
        IN PLACE.  Prefix-layer leaves are [batch, ...] but period leaves
        are stacked [repeats, batch, ...], so the period group is written
        along axis 1: writing it along axis 0 would put one request's KV on
        the repeats axis of every slot.  A leaf shorter than its slot (the
        cross-attention K/V of F < enc_cap frames) fills the slot's leading
        rows; the rest is masked by ``cross_len``.  On a mesh only the rank
        whose block of the slots holds ``slot`` keeps the row, cut to its
        share of the slot cache first (its heads come out local; a
        sequence the cache splits is cut)."""
        def into(dst, src):
            dst[tuple(slice(0, n) for n in src.shape)].copy_(src)
        if self.part is not None:
            index, n = self._slot_block
            per = self.max_slots // n
            if slot // per != index:
                return                     # another batch rank's slot
            slot -= index * per
            if self.enc_cap:
                cache1 = _pad_frames(cache1, self.enc_cap)
            cache1 = zip_map(
                lambda t, ps: cut_to_stored(t, ps[0], ps[1], self.part),
                cache1, self._c_leaves)
        if "prefix" in self.cache:
            _copy_leaves(self.cache["prefix"], cache1["prefix"],
                         lambda full, one: into(full[slot], one[0]))
        if "period" in self.cache:
            _copy_leaves(self.cache["period"], cache1["period"],
                         lambda full, one: into(full[:, slot], one[:, 0]))

    def _prompt_tokens(self, req: Request):
        """[1, S] prompt; a request without tokens draws them from the
        engine's seeded numpy generator, in the reference's order."""
        if req.prompt_tokens is not None:
            toks = np.asarray(req.prompt_tokens)
        else:
            toks = self._rng.integers(0, self.cfg.vocab_size, req.prompt_len)
        return torch.tensor(toks, dtype=torch.long, device=self.device)[None]

    def _do_prefill(self, slot: int) -> StepReport:
        req = self.queue.popleft()
        tokens = self._prompt_tokens(req)
        fe, dt = self.cfg.frontend, torch_dtype(self.cfg.dtype)
        # the reference's stubs: zero patch embeds before the prompt (VLM);
        # zero frames, one per prompt token, and the BOS token alone for
        # the decoder (enc-dec)
        kw, position = {}, fe.num_prefix + req.prompt_len
        if fe.kind == "vision":
            kw["embeds"] = torch.zeros((1, fe.num_prefix, fe.embed_dim),
                                       dtype=dt, device=self.device)
        if self.cfg.encoder is not None:
            kw["frames"] = torch.zeros((1, req.prompt_len, fe.embed_dim),
                                       dtype=dt, device=self.device)
            tokens = torch.ones((1, 1), dtype=torch.long, device=self.device)
            position = 1
        self._sync()
        t0 = time.perf_counter()
        part = self._prefill_part if self.part is not None else None
        logits, cache1 = prefill(self.params, self.cfg, tokens,
                                 seq_cap=self.seq_cap, impl=self.attn_impl,
                                 part=part, **kw)
        self._merge_slot_cache(cache1, slot)
        if self.cross_len is not None:
            self.cross_len[slot] = req.prompt_len
        first_tok = int(logits[0].argmax())
        self._sync()
        dt = time.perf_counter() - t0
        self._finite &= bool(torch.isfinite(logits).all())
        req.slot = slot
        req.generated = 1
        req.output_tokens.append(first_tok)
        self.slots[slot] = req
        self.positions[slot] = position
        self.last_token[slot] = first_tok
        report = StepReport(kind="prefill", compute_s=dt, tokens=req.prompt_len,
                            prefill_tokens=req.prompt_len, prefilled=[req])
        report.chunks.append((req, 0, req.prompt_len, 0))
        if req.generated >= req.max_new_tokens:
            self._retire(req, report)
        return report

    def _do_decode(self) -> StepReport:
        """One token for every slot (empty slots decode harmlessly at their
        stale positions, as in the reference; their rows are ignored).  On a mesh each batch rank
        decodes its slots' rows and the logits are gathered over the batch
        axes."""
        toks = torch.tensor(self.last_token, dtype=torch.long,
                            device=self.device)
        pos = torch.tensor(self.positions, dtype=torch.int32,
                           device=self.device)
        cross = self.cross_len
        groups = self.part.row_groups if self.part is not None else ()
        if groups:
            toks, pos = (coll.own_block(t, groups, 0) for t in (toks, pos))
            if cross is not None:
                cross = coll.own_block(cross, groups, 0)
        self._sync()
        t0 = time.perf_counter()
        logits = decode_step(self.params, self.cfg, self.cache, toks, pos,
                             cross_len=cross, impl=self.attn_impl,
                             part=self.part)
        if groups:
            logits = coll.all_gather(logits, groups, 0)
        next_tokens = logits.argmax(dim=-1).cpu().numpy()
        self._sync()
        dt = time.perf_counter() - t0
        live = [i for i, r in enumerate(self.slots) if r is not None]
        self._finite &= bool(torch.isfinite(logits[live]).all())
        report = StepReport(kind="decode", compute_s=dt)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.positions[i] += 1
            self.last_token[i] = int(next_tokens[i])
            req.generated += 1
            req.output_tokens.append(int(next_tokens[i]))
            self.kv.append_token(req.req_id)
            report.tokens += 1
            report.decode_tokens += 1
            report.decoded.append(req)
            if req.generated >= req.max_new_tokens:
                self._retire(req, report)
        return report

    def _retire(self, req: Request, report: StepReport) -> None:
        if req.slot >= 0:
            self.slots[req.slot] = None
        self.kv.release(req.req_id)
        report.completed.append(req)
