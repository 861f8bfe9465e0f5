"""Block-table-driven paged serving runtime: the PyTorch twin of
``repro/serving/paged_runtime.py``.

Every attention layer's KV lives in a fixed pool of ``page_size``-token
pages (plus one trash page for pad rows at index ``pool_pages``) addressed
through the per-sequence block tables ``PagedKVCache`` owns.  One fused
mixed prefill+decode forward pass per step runs over the step's FLATTENED
token rows (decode lanes contribute ``1 + len(draft)`` rows, prefill chunks
``chunk`` rows): per layer rms_norm, Q/K/V, RoPE, a scatter of K/V into
the pages, ragged paged attention (causal by per-row position inside the
page walk), ``wo`` and the gated FFN; then the final norm, the logits of
the rows that need them, and greedy argmax with speculative verify.

Differences from the JAX runtime, none of which changes a result:

* K/V are written IN PLACE with ``index_put_`` into per-layer views of the
  stacked pools ``[(repeats,) pool_pages+1, page, KV, hd]``.  This replaces
  the JAX runtime's donated buffers and ``lax.scan`` update: without it
  every step would copy the whole pool.  Pad rows all write trash-page
  slot 0, so ``index_put_`` sees duplicate indices there; that is harmless
  only because no block table ever points at the trash page.
* PyTorch runs eagerly, so there is no per-bucket compile step.  Row and
  width buckets are kept (the same ``bucket_rows`` / ``next_pow2``), so
  the kernel sees the same shapes as the JAX kernel would.
* The slot/page/position bookkeeping of the packed rows is computed on the
  host with numpy (the JAX runtime computes it inside its jitted step).
* Attention is called LANE-MAJOR: one kernel lane per sequence of the
  step, carrying all of its rows (a decode lane's ``1 + len(draft)``, a
  chunk's ``clen``) padded to a few row buckets (1, 1 + spec_k, the chunk
  size) with pad rows at position 0 on the lane's own table
  (:func:`lane_major_layout`); one gather brings q into ``[L, Q, H, hd]``
  and one brings the context back to the packed rows.  The JAX runtime
  makes every packed row a one-row lane carrying its lane's table, which
  gathers a 64-row chunk's pages 64 times; its per-lane form "measured ~3x
  slower on the CPU oracle because padding dominates", but on the card the
  kernel reads each lane's pages once per 64-row tile and a warp of pad
  rows does one tile of work, so the lane-major form is the one taken.
  Each row attends to the same keys either way; the two calls agree to
  float32 rounding.

Only pure-GQA decoder stacks are supported (no MLA / SSM / RWKV mixers, no
sliding windows, no cross-attention), as in the JAX runtime.

On a live ``model`` mesh (``policy=`` and ``mesh=``, as the engine takes
them; ``serving/engine.py::serving_part``) ``params`` are this rank's
shards, the query heads split over ``model`` as the policy's ``heads``
says, and the pools hold the KV heads the rank's query heads read
(:func:`held_kv_heads`), ``[(repeats,) pool_pages+1, page, KV', hd]``:
``KV / m`` heads a rank when they divide ``model``, else one, held by
``m / KV`` ranks (Granite-3-8B on 16: 2 query heads over 1 KV head a
rank).  Each layer projects Q for the rank's heads and K/V for its held
heads, writes its pages, runs paged attention on them (the kernel
unchanged, at the per-rank GQA shape), and meets ``wo``'s partial sums in
an all-reduce; the FFN runs as the model's layer pieces run it under
``part``, and the vocabulary is gathered before the argmax and the
verify.  Every rank runs the same scheduler on the same requests.  A
page pool split by sequence (as the policy's ``kv_cache`` splits the
dense cache when the KV heads fall short) would need the kernel to
return each rank's log-sum-exp and a merge across ranks; holding whole
heads costs ``m / KV`` copies of each instead.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention.ops import paged_attention_mixed
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (NO_POLICY, ShardPolicy, apply_rope,
                                      einsum, rms_norm)
from repro_torch.models.model import (_apply_ffn, _logits, _whole_logits,
                                      embed_tokens, layer_walk)
from repro_torch.models.params import torch_dtype
from repro_torch.serving.engine import StepReport, serving_part
from repro_torch.serving.kvcache import PagedKVCache
from repro_torch.serving.request import EXCEEDS_SEQ_CAP, Request, SubmitOutcome
from repro_torch.serving.sched import (PagedScheduler, SchedConfig,
                                       bucket_rows, next_pow2)


def paged_unsupported_reason(cfg: ModelConfig) -> Optional[str]:
    """None when the paged runtime can serve this config, else why not."""
    if cfg.encoder is not None:
        return "encoder-decoder models"
    if cfg.frontend.kind != "none":
        return "multimodal frontends"
    if cfg.attn.kind != "gqa":
        return f"attention kind {cfg.attn.kind!r}"
    for layer in cfg.layer_specs():
        if layer.mixer != "attn":
            return f"mixer {layer.mixer!r}"
        if layer.window:
            return "sliding-window layers"
        if layer.cross_attn:
            return "cross-attention layers"
    return None


def refuse_unsupported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` with the reason when the paged runtime cannot
    serve ``cfg``."""
    reason = paged_unsupported_reason(cfg)
    if reason is not None:
        raise ValueError(
            f"paged backend does not support {reason} ({cfg.name})")


def held_kv_heads(cfg: ModelConfig, m: int, mi: int) -> range:
    """The KV heads whose pages ``model`` rank ``mi`` of ``m`` holds: those
    its query heads read, head ``j // (H / KV)`` for each of its query
    heads ``j`` (the query heads split over ``model`` in blocks).  Raises
    ``ValueError`` (ROADMAP A7.7) when the query heads do not divide
    ``m``, or when a rank's query heads do not fall on whole groups of
    one KV head, so that the ranks would hold different numbers of KV
    heads."""
    a = cfg.attn
    if a.num_heads % m:
        raise ValueError(
            f"{a.num_heads} query heads do not divide {m} `model` ranks: "
            f"the paged runtime splits them over `model` (ROADMAP A7.7)")
    per, group = a.num_heads // m, a.num_heads // a.num_kv_heads
    if per % group and group % per:
        raise ValueError(
            f"{per} query heads a rank over groups of {group} (of "
            f"{a.num_kv_heads} KV heads): the {m} `model` ranks would hold "
            f"different numbers of KV heads (ROADMAP A7.7)")
    first = mi * per // group
    return range(first, first + max(1, per // group))


def lane_rows_bucket(rows: int, spec_k: int, chunk: int) -> int:
    """Rows per lane of the step's lane-major call: the smallest of the
    buckets (1, 1 + spec_k, chunk) that holds ``rows``, so the kernel sees
    few shapes."""
    for bucket in sorted({1, 1 + spec_k, chunk}):
        if rows <= bucket:
            return bucket
    return rows


def lane_major_layout(row_of, positions, q_len: int):
    """Map a step's packed rows onto the lane-major call ``[L, q_len]``.

    ``row_of`` holds (first packed row, rows) per lane, ``positions`` the
    packed rows' positions [T].  Returns ``gather`` [L * q_len], the packed
    row each lane slot reads (a pad slot reads its lane's first row),
    ``scatter`` [T], the lane slot each packed row reads its context from
    (a pad packed row reads slot 0), and ``qpos`` [L, q_len] int32, the
    slots' positions (0 for pad slots)."""
    n_lanes = len(row_of)
    gather = np.zeros(n_lanes * q_len, np.int64)
    scatter = np.zeros(positions.shape[0], np.int64)
    qpos = np.zeros((n_lanes, q_len), np.int32)
    for lane, (r0, n) in enumerate(row_of):
        if n > q_len:
            raise ValueError(f"lane {lane} has {n} rows > q_len {q_len}")
        base = lane * q_len
        gather[base:base + q_len] = r0
        gather[base:base + n] = r0 + np.arange(n)
        scatter[r0:r0 + n] = base + np.arange(n)
        qpos[lane, :n] = positions[r0:r0 + n]
    return gather, scatter, qpos


class PagedRuntime:
    """One tenant-replica's paged serving state: page pools + scheduler +
    the fused mixed prefill+decode forward pass."""

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 8,
                 seq_cap: int = 256, page_size: int = 16,
                 pool_pages: Optional[int] = None,
                 chunk_tokens: Optional[int] = None,
                 step_tokens: Optional[int] = None, attn_impl: str = "auto",
                 kv_dtype: str = "auto", prefix_cache: bool = True,
                 spec_k: int = 0, spec_ngram: int = 3, response_cache=None,
                 seed: int = 0, policy: ShardPolicy = NO_POLICY, mesh=None,
                 device="cuda"):
        refuse_unsupported(cfg)
        self.part = serving_part(cfg, policy, mesh, "paged", max_slots)
        # the KV heads this rank's pools hold (all of them unsharded)
        self.kv_heads = (held_kv_heads(cfg, self.part.m, self.part.mi)
                         if self.part is not None
                         else range(cfg.attn.num_kv_heads))
        if kv_dtype not in ("auto", "int8"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r} "
                             f"(expected 'auto' or 'int8')")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.page = page_size
        self.pps = -(-seq_cap // page_size)          # block-table width cap
        self.seq_cap = self.pps * page_size
        self.max_slots = max_slots
        self.pool_pages = (pool_pages if pool_pages is not None
                           else max_slots * self.pps)
        chunk = chunk_tokens or min(self.seq_cap, 4 * page_size)
        self.chunk = max(page_size, (chunk // page_size) * page_size)
        self.attn_impl = attn_impl
        self.kv_quant = kv_dtype == "int8"
        self.spec_k = spec_k
        self.kv = PagedKVCache(self.pool_pages, page_size,
                               enable_prefix_cache=prefix_cache)
        self.sched = PagedScheduler(
            self.kv, SchedConfig(chunk_tokens=self.chunk,
                                 max_active=max_slots,
                                 step_tokens=step_tokens,
                                 spec_k=spec_k, spec_ngram=spec_ngram),
            response_cache=response_cache)
        self.pools = self._init_pools()
        self._layers = self._layer_walk()
        self._rng = np.random.default_rng(seed)
        # observability: fused forward passes run, and whether every one
        # of them produced finite logits
        self.forward_passes = 0
        self.logits_finite = True
        # the running step's span record (``core/obs.py::StepSpans``),
        # handed in by the engine when its tracer has a clock, else None
        self._spans = None

    # ------------------------------------------------------------- pools
    def _init_pools(self) -> Dict[str, Any]:
        a = self.cfg.attn
        dt = torch.int8 if self.kv_quant else torch_dtype(self.cfg.dtype)
        kv = len(self.kv_heads)
        shape = (self.pool_pages + 1, self.page, kv, a.head_dim)
        sshape = (self.pool_pages + 1, self.page, kv)
        dev = self.device

        def pool(stack: int = 0):
            s = (stack,) + shape if stack else shape
            d = {"k": torch.zeros(s, dtype=dt, device=dev),
                 "v": torch.zeros(s, dtype=dt, device=dev)}
            if self.kv_quant:
                ss = (stack,) + sshape if stack else sshape
                d["k_scale"] = torch.zeros(ss, dtype=torch.float32, device=dev)
                d["v_scale"] = torch.zeros(ss, dtype=torch.float32, device=dev)
            return d

        pools: Dict[str, Any] = {}
        if self.cfg.prefix:
            pools["prefix"] = {f"layer{i}": pool()
                               for i in range(len(self.cfg.prefix))}
        if self.cfg.period:
            pools["period"] = {f"sub{i}": pool(self.cfg.repeats)
                               for i in range(len(self.cfg.period))}
        return pools

    def _layer_walk(self) -> List[tuple]:
        """(layer params, LayerSpec, page-pool views) per layer in order
        (``models.model.layer_walk``).  A period layer's views index its
        stacked pools, so an in-place write through a view lands in the
        pool: each view must start exactly at its repeat's offset in the
        pool, checked here once."""
        walk = []
        for lp, layer, views, (group, key, r) in layer_walk(
                self.cfg, self.params, self.pools):
            for k, view in views.items():
                base = self.pools[group][key][k]
                want = base.data_ptr() + (
                    0 if r is None else r * base.stride(0)
                    * base.element_size())
                if view.data_ptr() != want:
                    raise RuntimeError(f"pool view {group}/{key}/{k} does "
                                       f"not alias its stacked pool")
            walk.append((lp, layer, views))
        return walk

    # ------------------------------------------------------- forward: shared
    def _scatter(self, pool, k, v, page_ids, offs):
        """Write the K/V rows [T, KV, hd] into the page pool views in place
        (pad rows land on the trash page).  int8 pools quantize per row and
        store the scales beside the pages."""
        idx = (page_ids, offs)
        if not self.kv_quant:
            pool["k"].index_put_(idx, k.to(pool["k"].dtype))
            pool["v"].index_put_(idx, v.to(pool["v"].dtype))
            return
        kq, ks = attn_mod._quantize_kv(k)
        vq, vs = attn_mod._quantize_kv(v)
        pool["k"].index_put_(idx, kq)
        pool["v"].index_put_(idx, vq)
        pool["k_scale"].index_put_(idx, ks.float())
        pool["v_scale"].index_put_(idx, vs.float())

    # ------------------------------------------------ forward: fused mixed
    def _mixed_layer(self, lp, h, layer: LayerSpec, qpos, page_ids, offs,
                     lanes, pool):
        """One GQA layer over the packed rows ``h`` [T, d]; KV via the page
        pool, causality via per-row positions inside the page walk, the
        attention call lane-major (``lanes``: block tables [L, W], slot
        positions [L, Q], gather [L*Q] and scatter [T] indices)."""
        cfg = self.cfg
        sp = self._spans
        ap = lp["attn"]
        xin = rms_norm(h, lp["norm1"], cfg.norm_eps)
        wk, wv = ap["wk"], ap["wv"]
        if wk.shape[1] != len(self.kv_heads):  # whole: keep the held heads
            first, n = self.kv_heads.start, len(self.kv_heads)
            wk, wv = wk.narrow(1, first, n), wv.narrow(1, first, n)
        q = einsum("td,dhk->thk", xin, ap["wq"])
        k = einsum("td,dhk->thk", xin, wk)
        v = einsum("td,dhk->thk", xin, wv)
        q = apply_rope(q, qpos, cfg.rope_theta)
        k = apply_rope(k, qpos, cfg.rope_theta)
        if sp is not None:
            sp.phase("fwd.qkv")
        self._scatter(pool, k, v, page_ids, offs)
        if sp is not None:
            sp.phase("fwd.kv_write")
        kwargs = {}
        if self.kv_quant:
            kwargs = dict(k_scales=pool["k_scale"], v_scales=pool["v_scale"])
        block_tables, lane_qpos, gather, scatter = lanes
        n_lanes, q_len = lane_qpos.shape
        ql = q.to(h.dtype).index_select(0, gather).reshape(
            n_lanes, q_len, *q.shape[1:])
        ctx = paged_attention_mixed(ql, pool["k"], pool["v"], block_tables,
                                    lane_qpos, impl=self.attn_impl, **kwargs)
        ctx = ctx.reshape(n_lanes * q_len, *q.shape[1:]).index_select(
            0, scatter)                                          # [T, H, hd]
        if sp is not None:
            sp.phase("fwd.attention")
        out = einsum("thk,hkd->td", ctx.to(h.dtype), ap["wo"])
        if self.part is not None:
            out = self.part.g(out)
        h = h + out
        if sp is not None:
            sp.phase("fwd.out")
        h = _apply_ffn(lp, h, layer, cfg, self.part)
        if sp is not None:
            sp.phase("fwd.ffn")
        return h

    @torch.no_grad()
    def _mixed_impl(self, tokens, qpos, page_ids, offs, lanes, last_rows):
        """tokens/qpos/page_ids/offs [T] (qpos: pad rows at 0), ``lanes``
        the lane-major call's arrays (``_mixed_layer``), last_rows [N] ->
        logits [N, V] f32.  With a span record: ``fwd.embed``, per layer
        ``fwd.qkv``, ``fwd.kv_write``, ``fwd.attention``, ``fwd.out``,
        ``fwd.ffn``, then ``fwd.logits``."""
        part = self.part
        sp = self._spans
        if sp is not None:
            sp.restart()
        h = embed_tokens(self.params, self.cfg, tokens, part)
        if sp is not None:
            sp.phase("fwd.embed")
        for lp, layer, pool in self._layers:
            h = self._mixed_layer(lp, h, layer, qpos, page_ids, offs, lanes,
                                  pool)
        h = rms_norm(h, self.params["final_norm"], self.cfg.norm_eps)
        logits = _whole_logits(self.cfg, _logits(self.params, self.cfg,
                                                 h[last_rows], part), part)
        if sp is not None:
            sp.phase("fwd.logits")
        return logits

    # ------------------------------------------------------------ engine API
    def submit(self, req: Request) -> SubmitOutcome:
        """Rejects only requests that can NEVER fit; pool pressure is
        resolved later by SLO-aware preemption."""
        if req.prompt_len + req.max_new_tokens > self.seq_cap:
            return EXCEEDS_SEQ_CAP
        if req.prompt_tokens is None:
            req.prompt_tokens = self._rng.integers(
                0, self.cfg.vocab_size, req.prompt_len)
        return self.sched.submit(req)

    def has_work(self) -> bool:
        return self.sched.has_work()

    def running(self) -> List[Request]:
        return self.sched.running()

    @property
    def queue(self):
        return self.sched.waiting

    def set_budget(self, n: int) -> None:
        self.sched.set_budget(n)

    def drain_for_redrive(self) -> List[Request]:
        return self.sched.drain_for_redrive()

    # ------------------------------------------------------------ fused step
    def _run_mixed(self, tokens, positions, n_rows, bts, last_rows, row_of):
        """Run the fused forward on the step's packed host arrays (``bts``
        [L, W]: one block table per lane; ``row_of``: each lane's first
        packed row and row count).  Returns (logits [N, V] f32 on the
        device, compute_s).  The device is synchronised before and after
        the timed region, so ``compute_s`` is the step's device time plus
        its host work, not its launch time.  With a span record, the
        region ``compute_s`` times is ``step.copy_in``, ``step.forward``
        and ``step.sync_out``, after ``step.pack``'s end and
        ``step.sync_in``; the counters ``lanes``, ``rows`` (the real
        packed rows) and ``lane_slots`` (lanes x rows a lane of the
        lane-major call) ride on the step."""
        sp = self._spans
        t = tokens.shape[0]
        width = bts.shape[1]
        q_len = lane_rows_bucket(max(n for _, n in row_of), self.spec_k,
                                 self.chunk)
        gather, scatter, lane_qpos = lane_major_layout(row_of, positions,
                                                       q_len)
        valid = np.arange(t) < n_rows
        slot = np.clip(positions // self.page, 0, width - 1)
        page_ids = np.where(valid, bts[scatter // q_len, slot],
                            self.pool_pages)
        offs = positions % self.page
        qpos = np.where(valid, positions, 0).astype(np.int32)
        cuda = self.device.type == "cuda"
        if sp is not None:
            sp.args.update(lanes=len(row_of), rows=int(n_rows),
                           lane_slots=len(row_of) * q_len)
            sp.phase("step.pack")
        if cuda:
            torch.cuda.synchronize(self.device)
        if sp is not None:
            sp.phase("step.sync_in")
        t0 = time.perf_counter()

        def dev(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device, dtype)

        lanes = (dev(bts, torch.int32), dev(lane_qpos, torch.int32),
                 dev(gather, torch.long), dev(scatter, torch.long))
        args = (dev(tokens, torch.long), dev(qpos, torch.int32),
                dev(page_ids, torch.long), dev(offs, torch.long), lanes,
                dev(last_rows, torch.long))
        if sp is not None:
            t_fwd = sp.phase("step.copy_in")
        logits = self._mixed_impl(*args)
        if sp is not None:
            sp.span("step.forward", t_fwd)
        if cuda:
            torch.cuda.synchronize(self.device)
        if sp is not None:
            sp.phase("step.sync_out")
        self.forward_passes += 1
        return logits, time.perf_counter() - t0

    def step(self, spans=None) -> StepReport:
        """One fused step.  ``spans`` (``core/obs.py::StepSpans``, from the
        engine's tracer, or None) takes the step's phases in order:
        ``step.plan``, ``step.pack``, ``step.sync_in``, ``step.copy_in``,
        ``step.forward``, ``step.sync_out`` (``_run_mixed``),
        ``step.readback`` (the finite check, argmax and copy to the
        host), ``step.commit``; and the counter ``chunk_tokens``."""
        self._spans = spans
        log_mark = len(self.sched.preempt_log)
        plan = self.sched.plan()
        report = StepReport(kind="idle")
        report.preempted = [s.req for s in plan.preempted]
        report.preempt_pairs = list(self.sched.preempt_log[log_mark:])
        report.prefix_hit_tokens = plan.prefix_hit_tokens
        if spans is not None:
            spans.phase("step.plan")
        if plan.empty:
            return report
        decodes, prefills = plan.decodes, plan.prefills
        report.kind = ("mixed" if decodes and prefills
                       else "decode" if decodes else "prefill")

        # pack the step's real tokens back to back: 1+len(draft) rows per
        # decode lane, ``clen`` rows per prefill chunk
        n_rows = sum(1 + len(s.draft) for s in decodes) \
            + sum(c for _, _, c in prefills)
        n_logits = sum(1 + len(s.draft) for s in decodes) + len(prefills)
        t = bucket_rows(n_rows)
        tokens = np.zeros(t, np.int32)
        positions = np.zeros(t, np.int32)
        last_rows = np.zeros(bucket_rows(n_logits), np.int32)
        lanes: List[tuple] = []
        row_of: List[tuple] = []          # (row_start, n) per lane
        row = 0
        li = 0                            # next logit-row slot
        max_pages = 1
        for s in decodes:
            q = 1 + len(s.draft)          # verify q_len for this lane
            lanes.append(("d", s, li, q))
            pos = s.req.prompt_len + s.req.generated - 1
            tokens[row] = s.last_token
            if s.draft:
                tokens[row + 1:row + q] = np.asarray(s.draft, np.int32)
            positions[row:row + q] = pos + np.arange(q, dtype=np.int32)
            last_rows[li:li + q] = row + np.arange(q, dtype=np.int32)
            li += q
            row_of.append((row, q))
            row += q
            max_pages = max(max_pages, self.kv.pages_needed(pos + q))
        for s, start, clen in prefills:
            lanes.append(("p", s, start, clen, li))
            tokens[row:row + clen] = np.asarray(
                s.req.prompt_tokens, np.int32)[start:start + clen]
            positions[row:row + clen] = start + np.arange(clen,
                                                          dtype=np.int32)
            last_rows[li] = row + clen - 1
            li += 1
            row_of.append((row, clen))
            row += clen
            max_pages = max(max_pages, self.kv.pages_needed(start + clen))
        width = min(self.pps, next_pow2(max_pages))
        bts = np.stack([self.kv.block_table(lane[1].req.req_id, width)
                        for lane in lanes])

        logits, report.compute_s = self._run_mixed(tokens, positions, n_rows,
                                                   bts, last_rows, row_of)
        self.logits_finite &= bool(torch.isfinite(logits).all())
        next_tokens = logits.argmax(dim=-1).cpu().numpy()
        if spans is not None:
            spans.args["chunk_tokens"] = sum(c for _, _, c in prefills)
            spans.phase("step.readback")

        for lane in lanes:
            if lane[0] == "d":
                _, s, li, q = lane
                d = s.draft
                # greedy verify: commit the longest draft prefix matching
                # the model's own argmax chain plus the first correction —
                # token-identical to sequential greedy decode
                g = [int(next_tokens[li + j]) for j in range(q)]
                a = 0
                while a < len(d) and d[a] == g[a]:
                    a += 1
                m = min(a + 1, s.req.max_new_tokens - s.req.generated)
                committed = g[:m]
                if d:
                    report.spec.append((s.req, len(d), m - 1))
                    self.sched.commit_verified(s, m, drafted=len(d),
                                               accepted=m - 1)
                else:
                    self.sched.commit_decode(s)
                s.last_token = committed[-1]
                s.req.generated += m
                s.req.output_tokens.extend(committed)
                report.decode_tokens += m
                report.tokens += m
                report.drafted_tokens += len(d)
                report.accepted_tokens += m - 1
                report.decoded.extend([s.req] * m)
                if s.req.generated >= s.req.max_new_tokens:
                    self.sched.complete(s)
                    report.completed.append(s.req)
            else:
                _, s, start, clen, li = lane
                report.chunks.append((s.req, start, clen, s.chunks_done))
                self.sched.finish_chunk(s, clen)
                report.prefill_tokens += clen
                report.tokens += clen
                if s.prefilled >= s.req.prompt_len:   # final chunk: 1st token
                    first = int(next_tokens[li])
                    s.last_token = first
                    s.req.generated = 1
                    s.req.output_tokens.append(first)
                    # a restart after preemption regenerates the SAME first
                    # token, so only a fresh emission defines TTFT
                    if s.req.prefill_done < 0:
                        report.prefilled.append(s.req)
                    if s.req.generated >= s.req.max_new_tokens:
                        self.sched.complete(s)
                        report.completed.append(s.req)
        if spans is not None:
            spans.phase("step.commit")
        return report
