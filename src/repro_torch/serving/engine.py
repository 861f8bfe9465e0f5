"""Continuous-batching serving engine: the PyTorch twin of
``repro/serving/engine.py``, with the paged backend.

One engine serves one tenant's model on one device.  It performs *one unit
of work* per ``step()`` call — one fused mixed prefill+decode pass of the
paged runtime (``serving/paged_runtime.py``) — and reports the measured
compute seconds.  The harness decides what virtual time the step consumed
and then calls ``finalize_step`` so TTFT and completion timestamps reflect
the environment.

The dense slot-cache backend is not ported yet (ROADMAP A4).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.metrics import TenantMetrics
from repro_torch.serving.request import Request, SubmitOutcome


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
    on ``device`` from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, cfg: ModelConfig, params=None, *, max_slots: int = 8,
                 seq_cap: int = 256, page_size: int = 16, seed: int = 0,
                 backend: str = "paged", pool_pages: Optional[int] = None,
                 chunk_tokens: Optional[int] = None, attn_impl: str = "auto",
                 kv_dtype: str = "auto", prefix_cache: bool = True,
                 spec_k: int = 0, device="cuda"):
        if backend == "dense":
            raise NotImplementedError(
                "the dense slot-cache backend is not ported yet (ROADMAP "
                "A4); use backend='paged'")
        if backend != "paged":
            raise ValueError(f"unknown backend {backend!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = Model(cfg, params, seed=seed, device=self.device)
        self.params = self.model.params
        self.backend = backend
        self.metrics = TenantMetrics()
        # optional flight recorder with ``on_step(report, start, end,
        # engine=...)``: ``finalize_step`` folds each step into per-request
        # timelines.  None (the default) costs one guard per step.
        self.tracer = None
        from repro_torch.serving.paged_runtime import PagedRuntime
        self.runtime = PagedRuntime(
            cfg, self.params, max_slots=max_slots, seq_cap=seq_cap,
            page_size=page_size, pool_pages=pool_pages,
            chunk_tokens=chunk_tokens, attn_impl=attn_impl,
            kv_dtype=kv_dtype, prefix_cache=prefix_cache, spec_k=spec_k,
            seed=seed, device=self.device)
        self.kv = self.runtime.kv

    # ------------------------------------------------------------------ API
    def submit(self, req: Request) -> SubmitOutcome:
        """A falsy :class:`SubmitOutcome` when the request can never fit;
        pool pressure is resolved by preemption instead."""
        return self.runtime.submit(req)

    def has_work(self) -> bool:
        return self.runtime.has_work()

    def drain_requests(self) -> List[Request]:
        """Replica death / planned drain: release every KV page and return
        the resident requests rolled to a restartable state."""
        drained = self.runtime.drain_for_redrive()
        self.kv.release_all()        # safety net: no page outlives death
        return drained

    # ----------------------------------------------------------------- step
    def step(self) -> StepReport:
        """One unit of work.  Compute time measured with a real clock."""
        report = self.runtime.step()
        self.metrics.observe_kv(self.kv.used_pages, self.kv.reserved_pages,
                                self.kv.num_pages)
        self.metrics.observe_prefill(report.prefill_tokens,
                                     report.prefix_hit_tokens)
        self.metrics.observe_spec(report.drafted_tokens,
                                  report.accepted_tokens)
        self.metrics.observe_response_cache(self.runtime.sched.rc_lookups,
                                            self.runtime.sched.rc_hits)
        return report

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
