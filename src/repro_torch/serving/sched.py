"""Scheduler for the paged runtime: fused mixed prefill+decode batch
composition + SLO-aware, refcount-aware preemption over a shared KV page
pool.

Host-side policy only — no jax in this module, so the scheduling logic is
unit-testable without touching a device.  The runtime
(``serving/paged_runtime.py``) asks for one :class:`MixedPlan` per engine
step and executes it as a single fused forward pass.

Three policies live here:

* **Continuous batching under a per-step token budget** (the core lever in
  SLO-aware batch composition): every step's batch starts from ALL
  decode-ready lanes (one token each) and the remaining budget
  (``step_tokens - n_decode``) is filled with prefill chunk tokens — the
  in-flight chunked prompts first, then new admissions.  Decode lanes
  therefore never stall on an admission: a new prompt only shrinks the
  prefill share of the step, never displaces a decode token, which is what
  keeps ITL tails flat under churn (the PR 3 interleave instead alternated
  whole steps, stalling every decode lane for a full chunk).

* **Prefix-cache sharing**: when a prompt is first scheduled, the longest
  cached page-aligned prefix is mapped straight into its block table
  (``PagedKVCache.match_prefix``) and those tokens are never prefilled —
  TTFT for shared-prefix workloads drops from O(prompt) to O(tail).  Fully
  prefilled pages are published back (``commit_prefix``) as chunks finish.

* **Speculative multi-token decode lanes** (``SchedConfig.spec_k > 0``):
  a model-free **n-gram / prompt-lookup drafter** proposes up to ``k``
  continuation tokens per decode lane by matching the lane's recent token
  suffix against its own reference corpus (prompt + optional
  ``Request.draft_hints`` + generated output).  The planner attaches the
  draft AFTER decode lanes and prefill chunks have claimed their budget —
  drafts only consume *leftover* step-token budget, so speculation can
  never starve a prefill chunk or another lane, and under saturation it
  degrades to plain one-token decode automatically.  Draft page
  reservations never preempt anyone: on pool pressure the draft is simply
  dropped.  The runtime verifies the drafted rows in the SAME fused
  ragged step (the kernel already takes q_len>1 decode rows) and commits
  the longest model-agreeing prefix; a per-lane acceptance-rate EMA feeds
  the next step's ``k`` (EMA -> 0 drives q_len back to 1, i.e.
  speculation off, guaranteeing ITL is never structurally worse than
  non-speculative decode), with a periodic 1-token probe so a lane can
  rediscover predictability after a distribution shift.

* **SLO-aware preemption** (serving mixed loads with SLO guarantees):
  page-pool exhaustion evicts the least-SLO-urgent page holder — lowest
  ``Request.priority`` first, then the furthest deadline
  (``arrival + slo``) — releases its *references*, and requeues it for a
  full restart (recompute-style preemption: greedy decode regenerates the
  same tokens).  Refcount-awareness is structural: eviction only drops the
  victim's references, so a page with live sharers is never freed, and a
  victim whose pages are all shared yields nothing — the loop then moves
  to the next victim in the strict total order (no livelock).  Admission-
  time prefill may only preempt victims strictly less urgent than the
  beneficiary, which keeps eviction thrash-free; decode of already-running
  sequences may evict any holder (including, as a last resort, the least
  urgent of the decoding set itself).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.kvcache import PagedKVCache
from repro_torch.serving.request import (ADMITTED, NEVER_FITS, Request,
                                   SubmitOutcome)

_INF = float("inf")


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def bucket_rows(n: int) -> int:
    """Row-count bucket for the flattened mixed batch: powers of two up
    to 16, then 16-token granules — bounded compile variants with <= 2x
    (and typically ~1.1x) padding waste.  Lives here (host-side, no jax)
    because the draft planner is bucket-aware: rows the runtime would
    pad anyway are compute-free and may carry draft tokens at zero
    step-budget cost."""
    if n <= 16:
        return next_pow2(n)
    return -(-n // 16) * 16


@dataclass
class SchedConfig:
    chunk_tokens: int = 64        # per-seq prefill chunk cap per step
    max_active: int = 8           # lane cap (decode + prefill rows)
    # fused per-step token budget (decode lanes + prefill chunk tokens);
    # None = max_active + chunk_tokens, i.e. a full decode batch never
    # forfeits prefill progress and vice versa
    step_tokens: Optional[int] = None
    # --- speculative multi-token decode lanes ---
    spec_k: int = 0               # max draft tokens per lane (0 = off)
    spec_ngram: int = 3           # suffix length the drafter matches on
                                  # (3 = the prompt-lookup literature
                                  # default; short enough to fire on
                                  # templates, long enough that random
                                  # vocab collisions are negligible)
    spec_ema_alpha: float = 0.3   # per-lane acceptance-rate EMA smoothing
    # when the EMA has driven a lane's k to 0, re-probe with a 1-token
    # draft every this-many verify opportunities (distribution shift)
    spec_probe_every: int = 32
    # bucket-boundary-aware draft funding: the runtime pads the step's
    # packed rows up to the (rows) compile bucket, so a draft row that
    # rides existing padding costs NO extra compute — fund those at zero
    # step-token cost even when the leftover budget is exhausted (the
    # step's bucket, and therefore its cost, is unchanged by them)
    spec_free_padding: bool = True


class NgramDrafter:
    """Model-free n-gram / prompt-lookup drafter.

    The lane's *reference corpus* is ``prompt_tokens ++ draft_hints ++
    output_tokens`` — its own history, optionally extended with hint
    tokens the frontend believes likely to continue the response (e.g.
    the completion previously observed for the same templated prompt;
    the hints are never trusted, only *verified* by the model, so a
    stale hint costs a rejected draft, never a wrong token).  Drafting
    matches the most recent ``ngram`` generated tokens against the
    corpus and proposes the tokens that followed the most recent prior
    occurrence.  Pure host-side numpy — no model, no device."""

    def __init__(self, ngram: int = 3):
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        self.ngram = ngram

    def draft(self, corpus: Sequence[int], pattern: Sequence[int],
              k: int) -> List[int]:
        """Up to ``k`` proposed continuations: find the most recent
        occurrence of ``pattern`` (the lane's newest ``ngram`` tokens)
        inside ``corpus`` that has at least one token after it, and
        propose what followed.  Empty when no such occurrence exists —
        a miss costs nothing (no verify rows are added)."""
        n = self.ngram
        c = np.asarray(corpus, dtype=np.int64)
        p = np.asarray(pattern, dtype=np.int64)
        if k <= 0 or p.size != n or c.size < n + 1:
            return []
        # vectorized window match over shifted views; a window whose
        # continuation is empty (the corpus tail is usually the pattern
        # itself) is skipped below
        t = c.size - n + 1                  # window starts: [0, t)
        hit = np.ones(t, dtype=bool)
        for j in range(n):
            hit &= c[j:j + t] == p[j]
        starts = np.flatnonzero(hit)
        for s in starts[::-1]:              # most recent occurrence first
            cont = c[s + n:s + n + k]
            if cont.size:
                return [int(x) for x in cont]
        return []


@dataclass(eq=False)          # identity semantics for in/remove on lists
class SeqState:
    """Runtime state of one request inside the paged scheduler."""
    req: Request
    prefilled: int = 0            # prompt tokens already written to pages
    preemptions: int = 0
    last_token: int = 0           # feedback token for the next decode step
    prefix_hit: int = 0           # prompt tokens served from the prefix cache
    chunks_done: int = 0          # prefill chunks executed (trace span index;
    #                               resets with prefilled on preemption)
    # --- speculative decode lane state ---
    draft: List[int] = field(default_factory=list)   # this step's proposal
    accept_ema: float = 1.0       # acceptance-rate EMA (optimistic start)
    spec_probe: int = 0           # verify opportunities since k hit 0
    # lazily-built immutable drafter inputs (prompt/hints never change)
    _corpus_base: Optional[np.ndarray] = field(default=None, repr=False)
    _prompt_list: Optional[List[int]] = field(default=None, repr=False)

    def deadline(self) -> float:
        if self.req.slo_ms is None:
            return _INF
        return self.req.arrival + self.req.slo_ms / 1e3

    def corpus(self) -> np.ndarray:
        """The drafter's searchable reference corpus: prompt, then
        optional hints, then everything generated so far.  Hints sit
        BETWEEN prompt and output so a replay hint (the completion
        previously observed for this prompt) is adjacent to the prompt
        tail — the lookup then predicts the whole response from the
        first generated token on.  The immutable prompt+hints prefix is
        converted to int64 once and cached: this runs per lane per
        planning step, squarely inside the per-step fixed cost
        speculation exists to shrink, so the per-step work is one
        memcpy plus converting the (short) output tail."""
        if self._corpus_base is None:
            parts = []
            if self.req.prompt_tokens is not None:
                parts.append(np.asarray(self.req.prompt_tokens, np.int64))
            if self.req.draft_hints is not None:
                parts.append(np.asarray(self.req.draft_hints, np.int64))
            self._corpus_base = (np.concatenate(parts) if parts
                                 else np.zeros(0, np.int64))
        return np.concatenate(
            [self._corpus_base,
             np.asarray(self.req.output_tokens, np.int64)])

    def pattern(self, n: int) -> List[int]:
        """The lane's true trailing ``n``-gram — the tail of
        prompt+output (hints are searchable context, never part of the
        actual history)."""
        out = self.req.output_tokens
        if len(out) >= n:
            return out[-n:]
        if self._prompt_list is None:
            self._prompt_list = [int(t) for t in self.req.prompt_tokens] \
                if self.req.prompt_tokens is not None else []
        return (self._prompt_list + out)[-n:]


@dataclass
class MixedPlan:
    """One fused engine step: decode lanes (each with an optional draft —
    ``seq.draft`` — making its q_len 1+k verify rows) + prefill chunks,
    all pages reserved, composed under the step token budget."""
    decodes: List[SeqState] = field(default_factory=list)
    prefills: List[Tuple[SeqState, int, int]] = \
        field(default_factory=list)           # (seq, start, chunk_len)
    preempted: List[SeqState] = field(default_factory=list)
    prefix_hit_tokens: int = 0                # matched while planning
    draft_tokens: int = 0                     # speculative rows this step
    free_draft_tokens: int = 0                # drafts riding bucket padding

    @property
    def total_tokens(self) -> int:
        return len(self.decodes) + self.draft_tokens \
            + sum(c for _, _, c in self.prefills)

    @property
    def empty(self) -> bool:
        return not self.decodes and not self.prefills


def _urgency_key(s: SeqState) -> Tuple[float, float, float, float]:
    """Greater tuple = more SLO-urgent: higher priority, then sooner
    deadline, then older arrival, then older req_id.  ``min`` over this
    key picks the eviction victim; the strict ``<`` comparison gates
    admission-time preemption.  The req_id tie-break makes the order a
    strict TOTAL order — without it two equal-urgency sequences on an
    overcommitted pool can self-evict alternately forever (each decode
    evicting its own requester), and the deterministic pecking order is
    what guarantees progress."""
    return (s.req.priority, -s.deadline(), -s.req.arrival, -s.req.req_id)


class PagedScheduler:
    """Owns the waiting queue, the in-flight chunked prefills, the
    decode-active set, and all page accounting against one PagedKVCache."""

    def __init__(self, kv: PagedKVCache, cfg: SchedConfig,
                 drafter: Optional[NgramDrafter] = None,
                 response_cache=None):
        self.kv = kv
        self.cfg = cfg
        # injectable for tests (oracle / adversarial drafters); the
        # default is the model-free prompt-lookup drafter
        self.drafter = drafter or NgramDrafter(cfg.spec_ngram)
        # optional serving/directory.ResponseCache (may be shared across
        # replicas): completed outputs are recorded, and later identical
        # submits self-prime draft_hints — templated traffic then rides
        # the speculative verify path with no client-supplied hints
        self.response_cache = response_cache
        self.rc_lookups = 0        # engine-local prime counters (the
        self.rc_hits = 0           # cache object's own are fleet-wide)
        self.waiting: Deque[SeqState] = deque()
        self.prefilling: List[SeqState] = []
        self.active: List[SeqState] = []
        self.budget = cfg.max_active
        self.preempt_log: List[Tuple[int, int]] = []   # (victim, beneficiary)
        # req_ids of hung lanes (fault injection / a real stuck
        # collective): they keep their slot and pages but are excluded
        # from step plans, so they emit no tokens until the stuck-lane
        # watchdog preempts them through the normal refcount-safe path
        self.stuck: set = set()

    # ------------------------------------------------------------ lifecycle
    def submit(self, req: Request) -> SubmitOutcome:
        """Queue a request.  Only requests that could never fit (their total
        footprint exceeds the whole pool, or the block-table width) are
        rejected — pool pressure is handled later by preemption, not here.
        The rejection is therefore NON-transient (``NEVER_FITS``): no
        amount of waiting makes the pool bigger, so a gateway should
        reject-fast instead of requeueing."""
        total = req.prompt_len + req.max_new_tokens
        if self.kv.pages_needed(total) > self.kv.num_pages:
            return NEVER_FITS
        if self.response_cache is not None and req.draft_hints is None \
                and req.prompt_tokens is not None:
            self.rc_lookups += 1
            self.rc_hits += bool(self.response_cache.prime(req))
        self.waiting.append(SeqState(req))
        return ADMITTED

    def set_budget(self, budget: int) -> None:
        self.budget = max(1, budget)

    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.prefilling) \
            or bool(self.active)

    def running(self) -> List[Request]:
        return [s.req for s in self.active] + \
            [s.req for s in self.prefilling]

    def step_token_budget(self) -> int:
        if self.cfg.step_tokens is not None:
            return max(1, self.cfg.step_tokens)
        return self.cfg.max_active + self.cfg.chunk_tokens

    # ----------------------------------------------------------------- plan
    def plan(self) -> MixedPlan:
        """Compose one fused step: every decode-ready lane plus as many
        prefill chunk tokens as fit under the step token budget, all with
        pages reserved.  Eviction during planning can remove a
        previously-planned lane — the final filters keep the plan
        consistent with what actually still holds pages."""
        plan = MixedPlan()
        plan.decodes = self._reserve_decodes(plan.preempted)
        budget = self.step_token_budget() - len(plan.decodes)
        # no separate lane cap: concurrency is already bounded by the
        # admission gate below (active + prefilling < self.budget), so an
        # in-flight chunk keeps progressing even with every slot decoding.
        # iterate a snapshot: a reservation below can evict an earlier
        # member of self.prefilling, and a live index would then skip the
        # next in-flight prompt for the step
        candidates = list(self.prefilling)
        idx = 0
        while budget > 0:
            if idx < len(candidates):
                seq = candidates[idx]
                idx += 1
                if seq not in self.prefilling:   # evicted while planning
                    continue
                if seq.req.req_id in self.stuck:  # hung mid-prefill
                    continue
            elif self.waiting and (len(self.active) + len(self.prefilling)
                                   < self.budget):
                seq = self.waiting.popleft()
                self.prefilling.append(seq)
                if seq.prefilled == 0:
                    matched = self.kv.match_prefix(seq.req.req_id,
                                                   seq.req.prompt_tokens)
                    if matched:
                        seq.prefilled = matched
                        seq.prefix_hit = matched
                        plan.prefix_hit_tokens += matched
            else:
                break
            clen = min(self.cfg.chunk_tokens, budget,
                       seq.req.prompt_len - seq.prefilled)
            if clen <= 0:
                continue
            ok, victims = self._reserve_prefill(seq, seq.prefilled + clen)
            plan.preempted.extend(victims)
            if not ok:
                break       # no eligible victim; decode-only step
            plan.prefills.append((seq, seq.prefilled, clen))
            budget -= clen
        # eviction during later reservations may have unplanned earlier work
        plan.decodes = [s for s in plan.decodes if s in self.active]
        plan.prefills = [(s, a, c) for (s, a, c) in plan.prefills
                         if s in self.prefilling]
        # speculative drafts LAST: only the budget neither decode lanes
        # nor prefill chunks claimed may fund draft rows — plus rows the
        # runtime's bucket padding makes compute-free — so speculation
        # never starves either (under saturation it self-disables)
        base_rows = len(plan.decodes) + sum(c for _, _, c in plan.prefills)
        plan.draft_tokens, plan.free_draft_tokens = \
            self._plan_drafts(plan.decodes, budget, base_rows)
        return plan

    # ------------------------------------------------------------- drafting
    def _plan_drafts(self, decodes: List[SeqState], budget: int,
                     base_rows: int) -> Tuple[int, int]:
        """Attach a draft (``seq.draft``) to each decode lane, bounded by
        the lane's adaptive k and the LEFTOVER step budget, round-robin so
        one lane cannot monopolise the speculative share.  A draft row
        that would not push the step past its current (rows) compile
        bucket rides the padding the runtime pays for anyway — it is
        funded at ZERO budget cost (``spec_free_padding``), so even a
        fully-claimed budget drafts for free up to the bucket boundary.
        Returns (total draft rows, rows funded by padding).  Draft page
        reservations never evict anyone: on pool pressure the draft is
        trimmed instead (speculation is opportunistic by contract)."""
        for seq in decodes:
            seq.draft = []
        if self.cfg.spec_k <= 0 or not decodes:
            return 0, 0
        free_ok = self.cfg.spec_free_padding
        if budget <= 0 and not free_ok:
            return 0, 0
        want: List[Tuple[SeqState, List[int]]] = []
        for seq in decodes:
            k = self._adaptive_k(seq)
            # never draft past the request's remaining token allowance
            # (the base token always commits one, so only room-1 draft
            # rows can ever be useful)
            k = min(k, seq.req.max_new_tokens - seq.req.generated - 1)
            if k <= 0:
                continue
            d = self.drafter.draft(seq.corpus(),
                                   seq.pattern(self.drafter.ngram), k)
            if d:
                want.append((seq, d))
        total = 0
        free = 0
        # the step's own token budget already pays for this compile
        # bucket; drafts may fill it but never grow the device batch
        # past it (budgeted rows could otherwise open the NEXT bucket
        # and padding would then "freely" fill that too, blowing the
        # per-step compute ceiling the budget exists to bound)
        ceiling = bucket_rows(base_rows + max(budget, 0))
        progressed = True
        while progressed:                    # round-robin, one row per
            progressed = False               # lane per pass
            for seq, d in want:
                # padding first: a free ride never crosses the bucket
                # boundary, so it preserves budget for rows that must
                rows = base_rows + total
                if rows + 1 > ceiling:
                    break
                is_free = free_ok and bucket_rows(rows + 1) == \
                    bucket_rows(rows)
                if not is_free and budget <= 0:
                    continue
                # each lane extends its own contiguous prefix (a failed
                # reservation stays failed within this plan — the free
                # list only shrinks — so the lane just stops growing)
                depth = len(seq.draft)
                if depth < len(d) and self._reserve_draft(seq, depth + 1):
                    seq.draft.append(d[depth])
                    if is_free:
                        free += 1
                    else:
                        budget -= 1
                    total += 1
                    progressed = True
        return total, free

    def _adaptive_k(self, seq: SeqState) -> int:
        """Acceptance-EMA-driven draft depth.  EMA -> 0 turns the lane's
        q_len back to 1 (speculation off); a periodic 1-token probe lets a
        disabled lane rediscover predictability."""
        k = int(round(seq.accept_ema * self.cfg.spec_k))
        if k > 0:
            return min(k, self.cfg.spec_k)
        seq.spec_probe += 1
        if seq.spec_probe >= self.cfg.spec_probe_every:
            seq.spec_probe = 0
            return 1
        return 0

    def _reserve_draft(self, seq: SeqState, n_draft: int) -> bool:
        """Reserve pages for the lane's base token + ``n_draft`` draft
        tokens.  Unlike prefill/decode reservations this NEVER preempts
        — and it only draws on truly-FREE pages: ``reserve`` would
        otherwise evict refcount-zero cached prefix pages (killing their
        index entries) before raising, and speculation must not spend
        the prefix cache's reclaimable capacity either — a draft is
        worth at most k tokens, a cached prefix page saves a whole
        prefill."""
        target = self._tokens_of(seq) + 1 + n_draft
        entry = self.kv.tables.get(seq.req.req_id)
        held = len(entry.pages) if entry is not None else 0
        if self.kv.pages_needed(target) - held > len(self.kv.free):
            return False
        self.kv.reserve(seq.req.req_id, target)
        return True

    # ------------------------------------------------------------- prefill
    def _reserve_prefill(self, seq: SeqState,
                         target_tokens: int) -> Tuple[bool, List[SeqState]]:
        """Reserve pages for the next chunk, evicting strictly-less-urgent
        holders if needed.  Returns (ok, victims-this-call); ok=False (with
        ``seq`` left queued in the prefilling set) means no eligible victim
        exists — the planner falls back to decode-only and retries."""
        victims: List[SeqState] = []
        while True:
            try:
                self.kv.reserve(seq.req.req_id, target_tokens)
                return True, victims
            except MemoryError:
                victim = self._pick_victim(
                    exclude=seq, strictly_less_urgent_than=seq)
                if victim is None:
                    return False, victims
                self.preempt(victim, beneficiary=seq)
                victims.append(victim)

    def finish_chunk(self, seq: SeqState, n_tokens: int) -> None:
        """``n_tokens`` of prompt were written by the fused step; publish
        the completed full pages to the prefix index so later requests
        sharing this prompt skip their prefill."""
        self.kv.extend(seq.req.req_id, seq.prefilled + n_tokens)
        seq.prefilled += n_tokens
        seq.chunks_done += 1
        self.kv.commit_prefix(seq.req.req_id, seq.req.prompt_tokens,
                              seq.prefilled)
        if seq.prefilled >= seq.req.prompt_len:
            self.prefilling.remove(seq)
            self.active.append(seq)

    # -------------------------------------------------------------- decode
    def _reserve_decodes(self,
                         preempted: List[SeqState]) -> List[SeqState]:
        """Reserve one more token of pages for every decode-active
        sequence, most urgent first.  Under an exhausted pool the least
        urgent holders are evicted until the rest fit."""
        ready: List[SeqState] = []
        for seq in sorted(self.active, key=_urgency_key, reverse=True):
            if seq not in self.active:      # evicted by an earlier reserve
                continue
            if seq.req.req_id in self.stuck:
                continue                    # hung lane: holds pages, no rows
            done = False
            while not done:
                try:
                    self.kv.reserve(seq.req.req_id, self._tokens_of(seq) + 1)
                    ready.append(seq)
                    done = True
                except MemoryError:
                    victim = self._pick_victim(exclude=None)
                    if victim is None:      # pool smaller than one seq
                        raise
                    self.preempt(victim, beneficiary=seq)
                    preempted.append(victim)
                    if victim is seq:
                        done = True
        return [s for s in ready if s in self.active]

    def commit_decode(self, seq: SeqState) -> None:
        """One token was appended by the fused step (no speculation)."""
        self.kv.extend(seq.req.req_id, self._tokens_of(seq) + 1)

    def commit_verified(self, seq: SeqState, committed: int,
                        drafted: int, accepted: int) -> None:
        """A verify step committed ``committed`` tokens (the base token
        plus ``accepted`` model-agreeing draft tokens) out of a
        ``drafted``-token draft.  Marks the committed tokens live, rolls
        the over-extended pages of REJECTED draft tokens back to the pool
        (page-granular, refcount-safe — shared pages live below any
        decode position and are never dropped), and folds the acceptance
        rate into the lane's EMA, which feeds the next step's adaptive k.
        Must be called BEFORE ``req.generated`` is advanced (same
        contract as :meth:`commit_decode`)."""
        assert 1 <= committed <= drafted + 1
        target = self._tokens_of(seq) + committed
        self.kv.extend(seq.req.req_id, target)
        self.kv.truncate(seq.req.req_id, target)
        rate = accepted / drafted if drafted else 0.0
        a = self.cfg.spec_ema_alpha
        seq.accept_ema = (1.0 - a) * seq.accept_ema + a * rate

    def _tokens_of(self, seq: SeqState) -> int:
        """Tokens currently in the cache: the prompt plus every generated
        token except the newest (which is only appended by the next decode
        step, mirroring the dense engine's position bookkeeping)."""
        return seq.req.prompt_len + max(0, seq.req.generated - 1)

    # ---------------------------------------------------------- preemption
    def _pick_victim(self, exclude: Optional[SeqState],
                     strictly_less_urgent_than: Optional[SeqState] = None
                     ) -> Optional[SeqState]:
        holders = [s for s in self.active if s is not exclude]
        holders += [s for s in self.prefilling if s is not exclude]
        holders = [s for s in holders if s.req.req_id in self.kv.tables]
        if strictly_less_urgent_than is not None:
            bar = _urgency_key(strictly_less_urgent_than)
            holders = [s for s in holders if _urgency_key(s) < bar]
        if not holders:
            return None
        return min(holders, key=_urgency_key)

    def preempt(self, victim: SeqState,
                beneficiary: Optional[SeqState] = None) -> None:
        """Release the victim's page references and requeue it for a full
        restart.  Shared pages survive (their other sharers keep them, or
        they park on the prefix cache), so a preempted shared-prefix
        request usually restarts with a prefix hit instead of a cold
        prefill.

        ``prefill_done`` is deliberately kept: greedy recompute regenerates
        the *same* tokens, so the original first-token emission remains the
        request's TTFT and the restart must not observe a second sample
        (the runtime only reports ``prefilled`` for a fresh first token).
        The preemption stall still shows up honestly — the first
        regenerated decode gap is measured from the original emission."""
        if victim.req.req_id in self.kv.tables:
            self.kv.release(victim.req.req_id)
        if victim in self.prefilling:
            self.prefilling.remove(victim)
        if victim in self.active:
            self.active.remove(victim)
        r = victim.req
        victim.prefilled = 0
        victim.prefix_hit = 0
        victim.chunks_done = 0
        victim.draft = []        # stale proposals die with the eviction
        victim.preemptions += 1
        r.generated = 0
        r.slot = -1
        r.output_tokens.clear()
        r.decode_times.clear()
        self.preempt_log.append(
            (r.req_id, beneficiary.req.req_id if beneficiary else -1))
        # a requeued lane is a FRESH lane: the hang was a property of the
        # stuck execution, not of the request, so recovery-by-preemption
        # converges instead of re-sticking forever
        self.stuck.discard(r.req_id)
        self.waiting.appendleft(victim)

    # ------------------------------------------------------ fault recovery
    def find(self, req_id: int) -> Optional[SeqState]:
        for pool in (self.active, self.prefilling, self.waiting):
            for seq in pool:
                if seq.req.req_id == req_id:
                    return seq
        return None

    def mark_stuck(self, req_id: int) -> None:
        self.stuck.add(req_id)

    def drain_for_redrive(self) -> List[Request]:
        """Replica death: release every resident page and hand back every
        resident request (in-service first, then queued) for the gateway
        to redrive to a survivor.  Request state resets exactly like
        :meth:`preempt` — outputs cleared for a full greedy regeneration,
        ``prefill_done`` kept so the original first emission remains the
        TTFT sample — but the lane objects are NOT requeued here: the
        survivor's ``submit`` builds fresh ones.  Afterwards this
        scheduler holds nothing (``kv.reserved_pages == 0``)."""
        seqs = list(self.prefilling) + list(self.active) \
            + list(self.waiting)
        self.prefilling.clear()
        self.active.clear()
        self.waiting.clear()
        self.stuck.clear()
        out: List[Request] = []
        for seq in seqs:
            r = seq.req
            if r.req_id in self.kv.tables:
                self.kv.release(r.req_id)
            r.generated = 0
            r.slot = -1
            r.output_tokens.clear()
            r.decode_times.clear()
            out.append(r)
        return out

    # ------------------------------------------------------------- retire
    def complete(self, seq: SeqState) -> None:
        if seq.req.req_id in self.kv.tables:
            self.kv.release(seq.req.req_id)
        if seq in self.active:
            self.active.remove(seq)
        self.stuck.discard(seq.req.req_id)
        if self.response_cache is not None:
            # record only finished outputs: greedy decode makes the
            # committed token sequence a pure function of (prompt,
            # params), so the entry is safe to replay as draft hints
            self.response_cache.record(seq.req)
