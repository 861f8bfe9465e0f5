"""Serving launcher: engines + controller co-deployed (the paper's
first-class integration), N latency tenants x R replicas on a virtual
clock; the PyTorch twin of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 32 \
        --qps 4 --device cuda [--full-width] [--tenants 2] [--replicas 2] \
        [--interfere] [--no-controller] [--admit 1] [--listen] \
        [--backend paged [--kv-dtype int8] [--spec-k 3] [--route load]] \
        [--arch rwkv6_1_6b] [--arch jamba_v0_1_52b --repeats 2]

One continuous-batching ``ServingEngine`` per tenant-replica, all sharing
a ``FabricState`` (the PS fabric model injects PCIe-class interference
when ``--interfere`` is set), with the multi-tenancy controller steering
quotas, placements and slice profiles per tenant through the
``ServingActuator``.  Placement state lives in a shared ``DeviceLedger``
built from the ``TenantRegistry``; ``--admit K`` scores K late-arriving
tenants against the live ledger mid-run (paper §2.3).  Every request goes
through the ``Gateway``'s front door and ends in exactly one verdict;
``--listen`` arms its backpressure (bounded door queues, dispatch
deadlines, Kingman-derived rate limits).  Replica dispatch is cache-aware
(``--route cache``, the default): paged replicas publish their prefix
caches into a per-tenant ``PrefixDirectory``, and a per-tenant
``ResponseCache`` shared across replicas primes speculative draft hints.

Virtual time, as in the reference: replicas run in parallel, each engine
owns an availability clock, and the global clock advances to the next
event (arrival, controller sample, step finish, admission).  On one card
the replicas step one after another; each step advances its own engine's
clock by its measured, device-synchronised ``compute_s`` (times the
tenant's slice compute scale, plus the fabric transfer of its prompt
tokens), or by the reference's per-token cost model with ``det_timing``.
The backend is the dense slot cache unless ``--backend paged``.  It
serves ``reduced(get_config(arch))`` unless ``reduce=False``
(``--full-width``); ``repeats`` (``--repeats``) cuts the depth to that
many repeats of the config's layer period.  Each tenant's replicas share
one set of weight tensors (the reference seeds them alike, so they serve
the same weights).

Chaos and fault injection, live migration, planned drains, gray-failure
evacuation, the stuck-lane watchdog and the flight recorder are not
ported yet: their flags are refused with an error naming ROADMAP A5.2.
"""
from __future__ import annotations

import argparse

_PAGE = 16           # KV page size, the reference's engine default
# the reference harness's flags that this port does not carry yet: each is
# refused with an error naming the ROADMAP item that will bring it
_REFUSED_FLAGS = ("--chaos", "--chaos-seed", "--no-recover", "--migrate",
                  "--drain-at", "--trace", "--trace-out")


def with_repeats(cfg, repeats: int):
    """``cfg`` cut (or grown) to ``repeats`` repeats of its layer period:
    a depth cut of a config, its widths untouched."""
    if not cfg.period:
        raise ValueError(f"{cfg.name} has no layer period to repeat")
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    return cfg.replace(repeats=repeats)


def warm_engine(eng, name: str, prompt_len: int) -> None:
    """Run one throw-away request through ``eng`` (kernel build, allocator
    and library warm-up) WITHOUT polluting observable state: the prefix
    directory listener and the shared response cache are detached for the
    drain, and the engine's metrics are reset, so the warm request
    (req_id=-1, virtual time 0) leaves no sample, cache entry or routing
    hint behind."""
    from repro_torch.serving.metrics import TenantMetrics
    from repro_torch.serving.request import Request

    listener, eng.kv.listener = getattr(eng.kv, "listener", None), None
    sched = eng.runtime.sched if eng.runtime is not None else None
    rcache = None
    if sched is not None:
        rcache, sched.response_cache = sched.response_cache, None
    try:
        eng.submit(Request(req_id=-1, tenant=name, prompt_len=prompt_len,
                           max_new_tokens=2, arrival=0.0))
        while eng.has_work():
            eng.finalize_step(eng.step(), 0.0)
    finally:
        eng.kv.listener = listener
        if sched is not None:
            sched.response_cache = rcache
            sched.rc_lookups = 0
            sched.rc_hits = 0
    eng.metrics = TenantMetrics()


def serve(arch: str = "stablelm_3b", requests: int = 32, qps: float = 4.0,
          prompt_len: int = 48, prompt_len_max: int = None, max_new: int = 8,
          slots: int = 4, num_tenants: int = 1, replicas: int = 1,
          interfere: bool = False, with_controller: bool = True,
          seed: int = 0, verbose: bool = True, admit: int = 0,
          backend: str = "dense", kv_dtype: str = "auto",
          prefix_cache: bool = True, spec_k: int = 0, route: str = "cache",
          route_imbalance: int = 4, route_staleness: int = 256,
          response_cache: bool = True, listen: bool = False,
          door_queue: int = 64, door_deadline_ms: float = 1000.0,
          det_timing: bool = False, exact_tokens: bool = False,
          unique_prompts: bool = False, seq_cap: int = 128,
          reduce: bool = True, repeats: int = None, params=None,
          device="cuda"):
    """Virtual-time multi-tenant serving run; returns per-tenant stats
    (one dict per tenant name) and the fleet's keys (``routing``,
    ``gateway``, ``prometheus``, ``device``; ``directory`` and
    ``response_cache`` on the paged backend, ``admission`` with ``admit``,
    ``actions`` and ``arbiter_max_units`` with the controller).

    Prompt lengths are ``prompt_len``, or drawn uniformly from
    ``[prompt_len, prompt_len_max]`` when that is given.  ``params`` are
    the weights to serve (nested dicts of tensors with the plan's names,
    for the config ``arch``, ``reduce``, ``repeats`` and ``exact_tokens``
    select): a mapping from tenant name, or a callable ``(tenant,
    engine_seed) -> params``; ``None`` draws random ones on ``device``
    from each tenant's engine seed (``seed + 17 * i``, admitted tenants
    ``seed + 1000 + n``, as in the reference).

    ``listen`` arms the gateway's backpressure: door queues of
    ``door_queue``, a ``door_deadline_ms`` dispatch deadline (EXPIRED, the
    503 path) and a Kingman-derived rate limiter (REJECTED, the 429 path).
    ``det_timing`` replaces each step's measured time with the
    reference's per-token cost model, so the whole run is reproducible;
    ``exact_tokens`` pins float32 weights and the plain attention path, so
    greedy output is a function of the prompt alone."""
    from collections import deque

    import numpy as np
    import torch
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.admission import (AdmissionConfig,
                                            AdmissionController,
                                            AdmissionVerdict, RateLimiter)
    from repro_torch.core.controller import Controller, ControllerConfig
    from repro_torch.core.ledger import DeviceLedger
    from repro_torch.core.policy import PolicyConfig
    from repro_torch.core.profiles import A100_MIG
    from repro_torch.core.signals import (Snapshot, SystemSignals,
                                          TenantSignals)
    from repro_torch.core.tenancy import (BACKGROUND, TenantRegistry,
                                          TenantSpec)
    from repro_torch.core.topology import Slot, make_p4d_cluster
    from repro_torch.device import resolve_device
    from repro_torch.serving.actuator import FabricState, ServingActuator
    from repro_torch.serving.directory import (CacheAwareRouter,
                                               PrefixDirectory,
                                               ResponseCache, RouterConfig)
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.gateway import DoorConfig, Gateway
    from repro_torch.serving.metrics import LatencyWindow
    from repro_torch.serving.request import Request

    if num_tenants < 1 or replicas < 1:
        raise SystemExit("--tenants and --replicas must be >= 1")
    if route not in ("cache", "load"):
        raise SystemExit("--route must be 'cache' or 'load'")
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduce:
        cfg = reduced(cfg)
    if repeats is not None:
        cfg = with_repeats(cfg, repeats)
    if exact_tokens:
        # float32 + the plain attention path: greedy argmax becomes a pure
        # function of the prompt, independent of batch shape and chunks
        cfg = cfg.replace(dtype="float32")
    paged = backend == "paged"
    names = ["T1"] if num_tenants == 1 else [f"L{i}"
                                             for i in range(num_tenants)]
    # spec_k is passed unconditionally: requesting speculation on the
    # dense backend must hit the engine's ValueError, not silently no-op
    eng_kw = dict(max_slots=slots, seq_cap=seq_cap, page_size=_PAGE,
                  backend=backend, spec_k=spec_k, device=dev)
    if exact_tokens:
        eng_kw["attn_impl"] = "ref"
    if paged:
        eng_kw.update(kv_dtype=kv_dtype, prefix_cache=prefix_cache)
    else:
        # passed on the dense backend too, so that asking for int8 pages
        # there hits the engine's ValueError instead of being ignored
        eng_kw["kv_dtype"] = kv_dtype
    # one response cache per tenant, SHARED across its replicas: a
    # completion on any replica primes speculation fleet-wide
    rcaches = {}

    def tenant_params(name, eng_seed):
        if params is None:
            return None
        if callable(params):
            return params(name, eng_seed)
        return params[name]

    def make_engines(name, eng_seed, n):
        kw = dict(eng_kw)
        if paged and response_cache:
            kw["response_cache"] = rcaches.setdefault(name, ResponseCache())
        # one seed per TENANT, identical across its replicas: replicas of
        # a model serve the same weights, so they share one set of tensors
        first = ServingEngine(cfg, tenant_params(name, eng_seed),
                              seed=eng_seed, **kw)
        return [first] + [ServingEngine(cfg, first.params, seed=eng_seed,
                                        **kw) for _ in range(n - 1)]

    engines = {name: make_engines(name, seed + 17 * i, replicas)
               for i, name in enumerate(names)}
    # cluster-wide KV reuse: every paged replica publishes its prefix
    # cache into a per-tenant content-hash directory, and dispatch routes
    # to the longest held prefix (least-loaded on fallback).  Dense
    # engines never publish, so the router degrades to least-loaded.
    directory = PrefixDirectory(page_size=_PAGE)
    rcfg = RouterConfig(imbalance_bound=route_imbalance,
                        staleness_bound=route_staleness)

    def wire_tenant(name):
        for j, eng in enumerate(engines[name]):
            if eng.runtime is not None:
                directory.attach(name, j, eng.kv)
        return CacheAwareRouter(directory, name, rcfg,
                                cache_aware=route == "cache")

    routers = {name: wire_tenant(name) for name in names}
    fabric = FabricState()
    fabric.t2_active = interfere
    topo = make_p4d_cluster(2)
    # Spread tenant-replicas over the topology's real slots (2 per device),
    # skipping the background tenants' fixed slots, breadth-first across
    # devices so no GPU hosts more than 2 x 2g.20gb slices.  The first
    # devices sit on the contended root; the rest see ambient traffic.
    total = num_tenants * replicas
    reserved = {("h0:g1", 0), ("h0:g0", 1)}      # T2 / T3 below
    pool = [f"h{h}:g{d}" for h in range(2) for d in range(8)]
    free = [Slot(int(d[1]), d, idx)
            for idx in range(2) for d in pool
            if (d, idx) not in reserved]
    if total > len(free):
        raise SystemExit(
            f"{total} tenant-replicas exceed the cluster's capacity "
            f"({len(free)} free 2g slices)")
    # tenant identity as data: the run's registry pins the breadth-first
    # placement into each spec, and the shared ledger is built from it
    registry = TenantRegistry()
    placements = {}
    k = 0
    for i, name in enumerate(names):
        placements[name] = free[k:k + replicas]
        k += replicas
        registry.add(TenantSpec(
            name=name, replicas=replicas, rate=qps, slo_s=0.200,
            priority=1.0 + 0.25 * i,
            placement=tuple(s.key for s in placements[name])))
    registry.add(TenantSpec(
        name="T2", role=BACKGROUND, profile="7g.80gb", units=0,
        pcie_demand=fabric.t2_demand, ps_weight=fabric.t2_ps_weight,
        placement=("h0:g1:s0",)))
    registry.add(TenantSpec(
        name="T3", role=BACKGROUND, profile="2g.20gb", units=2,
        sm_util=0.95, placement=("h0:g0:s1",)))
    ledger = DeviceLedger.from_registry(
        topo, registry, A100_MIG,
        home_devices=("h0:g0",), ambient_units=3)
    # only tenants with a replica on the contended root (r0 = g0/g1)
    # share the hot fabric path
    contended = topo.root_of("h0:g1")
    for name in names:
        fabric.set_on_root(name, any(
            topo.root_of(s.device) == contended for s in placements[name]))
    now = [0.0]
    actuator = ServingActuator(engines, fabric, topo, lambda: now[0],
                               ledger=ledger,
                               rng=np.random.default_rng(seed + 1))
    windows = {name: LatencyWindow() for name in names}

    # ---- request-plane front door -----------------------------------
    # The gateway fronts EVERY request, so the verdict ledger always
    # balances; --listen additionally arms backpressure.
    def door_cfg_for(spec):
        if not listen:
            return DoorConfig(max_queue=1_000_000, deadline_s=None)
        return DoorConfig(
            max_queue=door_queue, deadline_s=door_deadline_ms / 1e3,
            rate_limiter=RateLimiter.kingman(spec, AdmissionConfig()))

    door_cfgs = {name: door_cfg_for(registry[name]) for name in names}
    gateway = Gateway(engines, routers, door_cfgs=door_cfgs,
                      default_cfg=door_cfg_for(
                          TenantSpec(name="_default", rate=qps, slo_s=0.200)),
                      paused_until=actuator.paused_until)

    controller = None
    if with_controller:
        controller = Controller(topo, A100_MIG, actuator,
                                ControllerConfig(policy=PolicyConfig(
                                    tau_s=0.200, persistence=2,
                                    dwell_obs=20, cooldown_obs=10)))
        controller.register_registry(registry, placements={
            **placements, "T2": [Slot(0, "h0:g1", 0)],
            "T3": [Slot(0, "h0:g0", 1)]})

    # warm-up (kernel build, allocator and library warm-up) stays out of
    # the virtual clock, the metrics, the response cache and the directory
    for name in names:
        for eng in engines[name]:
            warm_engine(eng, name, prompt_len)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    rng = np.random.default_rng(seed)
    reqs = {name: [] for name in names}
    pending = {}
    # paged traffic draws each prompt as a shared per-tenant template
    # prefix (page-aligned, so replicas publish identical chain hashes)
    # plus a random tail; dense prompts are left to the engine, which
    # draws them from its seeded generator.  unique_prompts drops the
    # templates: every prompt is drawn here and fully distinct.
    tmpl_len = (prompt_len * 2 // 3) // _PAGE * _PAGE \
        if paged and not unique_prompts else 0

    def make_prompt(templates, n):
        if unique_prompts:
            return rng.integers(0, cfg.vocab_size, n).astype(np.int64)
        if templates is None:
            return None
        head = templates[int(rng.integers(len(templates)))]
        tail = rng.integers(0, cfg.vocab_size, n - tmpl_len)
        return np.concatenate([head, tail]).astype(np.int64)

    def gen_traffic(name, start=0.0):
        templates = (rng.integers(0, cfg.vocab_size, (4, tmpl_len))
                     if tmpl_len else None)
        arrivals = start + np.cumsum(rng.exponential(1.0 / qps, requests))
        lens = ([prompt_len] * requests if prompt_len_max is None else
                rng.integers(prompt_len, prompt_len_max + 1, requests))
        reqs[name] = [Request(req_id=i, tenant=name, prompt_len=int(n),
                              max_new_tokens=max_new, arrival=float(t),
                              slo_ms=200.0,
                              prompt_tokens=make_prompt(templates, int(n)))
                      for i, (t, n) in enumerate(zip(arrivals, lens))]
        pending[name] = deque(reqs[name])

    for name in names:
        gen_traffic(name)
    preempts = {name: 0 for name in names}
    steps = {name: 0 for name in names}
    compute = {name: 0.0 for name in names}
    # per-engine availability clock: engines run in parallel
    avail = {(name, j): 0.0 for name in names for j in range(replicas)}
    next_sample = 1.0
    hi = prompt_len if prompt_len_max is None else prompt_len_max
    if verbose:
        print(f"serving {cfg.name} ({cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.dtype}, {backend}, kv {kv_dtype}) on "
              f"{dev}: {len(names)} tenant(s) x {replicas} replica(s), "
              f"{requests} req/tenant at {qps} qps, prompts "
              f"{prompt_len}-{hi}, max_new {max_new} "
              f"(interference={'on' if interfere else 'off'}, "
              f"controller={'on' if with_controller else 'off'})")

    # ---- §2.3 admission path: K late tenants arrive mid-run ----------
    admission = None
    admit_events = deque()
    admission_log = []
    if admit > 0:
        admission = AdmissionController(topo, registry, ledger,
                                        AdmissionConfig())
        span = requests / qps
        admit_events = deque(
            (span * 0.3 + j * max(1.0, 1.0 / qps),
             TenantSpec(name=f"A{j}", replicas=1, rate=qps,
                        slo_s=0.200, priority=1.0))
            for j in range(admit))

    def on_admitted(spec, slots_, t):
        name = spec.name
        names.append(name)
        engines[name] = make_engines(name, seed + 1000 + len(names), 1)
        routers[name] = wire_tenant(name)
        actuator.engines[name] = engines[name]
        actuator.compute_scales.setdefault(name, 1.0)
        actuator.pauses.setdefault(name, 0.0)
        warm_engine(engines[name][0], name, prompt_len)
        windows[name] = LatencyWindow()
        gateway.door_cfgs[name] = door_cfg_for(spec)
        preempts[name] = 0
        steps[name] = 0
        compute[name] = 0.0
        avail[(name, 0)] = t
        fabric.set_on_root(name, any(
            topo.root_of(s.device) == contended for s in slots_))
        gen_traffic(name, start=t)
        if controller is not None:
            controller.register_tenant(name, "latency", slots_[0],
                                       A100_MIG[spec.profile],
                                       priority=spec.priority,
                                       slo_s=spec.slo_s, replicas=slots_)
        if verbose:
            print(f"  t={t:6.1f}s admitted {name} -> "
                  f"{[s.key for s in slots_]}")

    def run_admissions():
        while admit_events and admit_events[0][0] <= now[0]:
            t, spec = admit_events.popleft()
            verdict, slots_ = admission.decide(spec, now=t)
            admission_log.append((t, spec.name, verdict.value))
            if verdict == AdmissionVerdict.ADMIT:
                on_admitted(registry[spec.name], slots_, t)
            elif verbose:
                print(f"  t={t:6.1f}s {verdict.value} {spec.name}")
        # retry queued tenants so one lands as soon as capacity appears
        if admission.queue:
            for spec, slots_ in admission.retry_queued(now=now[0]):
                admission_log.append((now[0], spec.name, "admit"))
                on_admitted(spec, slots_, now[0])

    def submit_due():
        # front door first (SHED/REJECT/ACCEPT verdicts), then drain the
        # door queues into engines via the cache-aware router
        for name in names:
            q = pending[name]
            while q and q[0].arrival <= now[0]:
                gateway.offer(q.popleft(), now[0])
        gateway.dispatch(now[0])

    def has_pending():
        return bool(admit_events) or any(pending[n] for n in names) or \
            gateway.queued_total() > 0 or \
            any(e.has_work() for n in names for e in engines[n])

    while has_pending():
        if admission is not None:
            run_admissions()
        submit_due()
        if controller and now[0] >= next_sample:
            tenants = {}
            for name in names:
                w = windows[name]
                tenants[name] = TenantSignals(
                    p99=w.quantile(0.99, now[0]),
                    miss_rate=w.miss_rate(0.2, now[0]), rps=1.0,
                    ttft_p99=w.quantile(0.99, now[0]))
            sys_sig = SystemSignals()
            for root in topo.roots():
                sys_sig.pcie_bytes[root] = (
                    fabric.t2_demand if fabric.t2_active
                    and root == "h0:r0" else 1e9)
            controller.on_snapshot(Snapshot(now[0], tenants, sys_sig))
            next_sample += 1.0
        # step every engine that is free, has work, and isn't paused
        stepped = False
        for name in names:
            if now[0] < actuator.paused_until(name):
                continue
            for j, eng in enumerate(engines[name]):
                if avail[(name, j)] > now[0] or not eng.has_work():
                    continue
                rep = eng.step()
                preempts[name] += len(rep.preempted)
                if rep.kind == "idle":
                    continue
                steps[name] += 1
                compute[name] += rep.compute_s
                # only the prompt share of a (possibly mixed) step pays
                # fabric transfer
                transfer = (rep.prefill_tokens * 0.4e6
                            / fabric.bandwidth(name))
                # det_timing: the reference's deterministic token-cost
                # model instead of the measured step time
                comp = (2e-4 + 2e-5 * rep.prefill_tokens
                        + 3e-4 * rep.decode_tokens) if det_timing \
                    else rep.compute_s
                dur = comp * actuator.compute_scale_of(name) + transfer
                end = now[0] + dur
                avail[(name, j)] = end
                # engine timestamps + token-stream mirroring + terminal
                # COMPLETED verdicts
                gateway.finalize(name, eng, rep, end, start_time=now[0])
                for pr in rep.prefilled:
                    windows[name].observe(end, pr.ttft, slo=0.2)
                stepped = True
        if stepped:
            continue
        # nothing runnable now: hop to the next event
        horizon = []
        for name in names:
            if pending[name]:
                horizon.append(pending[name][0].arrival)
            if now[0] < actuator.paused_until(name) and \
                    any(e.has_work() for e in engines[name]):
                horizon.append(actuator.paused_until(name))
        horizon.extend(t for t in avail.values() if t > now[0])
        horizon.extend(t for t, _ in admit_events)
        # door-queued requests: retry a beat later, and never sleep past
        # a dispatch deadline (expiry is an event too)
        for door in gateway.doors.values():
            if door.queue:
                horizon.append(now[0] + 0.02)
                head = door.queue[0]
                if head.deadline is not None:
                    horizon.append(max(head.deadline, now[0] + 1e-9))
        if controller:
            horizon.append(next_sample)
        now[0] = min(horizon) if horizon else now[0] + 0.02

    def q(a, p):
        return float(np.quantile(a, p)) if len(a) else 0.0

    out = {}
    for name in names:
        done = [r for r in reqs[name] if r.done]
        ttfts = np.array([r.ttft for r in done]) * 1e3
        itls = np.array([v for r in done for v in r.itls]) * 1e3
        gen = sum(len(r.output_tokens) for r in done)
        span = (max((r.finished for r in done), default=0.0)
                - reqs[name][0].arrival)
        door = gateway.door(name)
        engs = engines[name]
        # every offered request carries exactly one verdict; the door's
        # ledger is the authoritative accounting (no silent drops)
        out[name] = {
            "completed": len(done),
            "offered": door.offered,
            "shed": door.shed,
            "rejected": door.rejected,
            "expired": door.expired,
            "reject_reasons": dict(door.reject_reasons),
            "redriven": door.redriven,
            "preempted": preempts[name],
            "ttft_p50_ms": q(ttfts, .5), "ttft_p99_ms": q(ttfts, .99),
            "itl_p50_ms": q(itls, .5), "itl_p99_ms": q(itls, .99),
            "tokens_per_s": gen / span if span > 0 else 0.0,
            "generated_tokens": gen,
            "layers": cfg.num_layers,
            "steps": steps[name], "compute_s": compute[name],
            # the warm-up's passes included, as the kernels' counts are
            "forward_passes": sum(e.forward_passes for e in engs),
            "prefill_passes": sum(e.prefill_passes for e in engs),
            "logits_finite": all(e.logits_finite for e in engs),
            "outputs": {int(r.req_id): [int(t) for t in r.output_tokens]
                        for r in done},
            "ttft_by_id": {int(r.req_id): float(r.ttft * 1e3)
                           for r in done},
        }
        o = out[name]
        if verbose:
            print(f"  {name}: completed {len(done)}/{door.offered} "
                  f"(shed {door.shed} rejected {door.rejected} "
                  f"expired {door.expired}) in {o['steps']} steps "
                  f"TTFT p50={o['ttft_p50_ms']:.1f}ms "
                  f"p99={o['ttft_p99_ms']:.1f}ms "
                  f"ITL p50={o['itl_p50_ms']:.1f}ms "
                  f"p99={o['itl_p99_ms']:.1f}ms "
                  f"tokens/s={o['tokens_per_s']:.1f} "
                  f"logits_finite={o['logits_finite']}")
    out["routing"] = {name: routers[name].stats.as_dict() for name in names}
    if paged:
        out["directory"] = directory.stats.as_dict()
        if rcaches:
            out["response_cache"] = {
                name: {"hit_rate": rc.hit_rate(), "entries": len(rc)}
                for name, rc in rcaches.items()}
        if verbose:
            routed = sum(r.stats.routed_cache for r in routers.values())
            n_routed = sum(r.stats.total for r in routers.values())
            print(f"routing: {routed}/{n_routed} cache-routed "
                  f"(directory hit rate "
                  f"{directory.stats.hit_rate():.2f})")
    if admission is not None:
        out["admission"] = {"verdicts": admission.counts(),
                            "log": admission_log,
                            "still_queued": [s.name for s in admission.queue]}
        if verbose:
            print("admission verdicts:", out["admission"]["verdicts"])
    if controller:
        out["actions"] = controller.audit.counts()
        out["arbiter_max_units"] = controller.arbiter.max_used()
        if verbose:
            print("controller actions:", out["actions"])
    out["gateway"] = gateway.counters()
    out["prometheus"] = gateway.prometheus(now[0])
    out["device"] = {
        "device": str(dev), "virtual_s": now[0],
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None)}
    gateway.check()     # offered == completed+rejected+shed+expired+in_flight
    ledger.check()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--qps", type=float, default=4.0)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--prompt-len-max", type=int, default=None,
                    help="draw prompt lengths uniformly from "
                         "[--prompt-len, --prompt-len-max]")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seq-cap", type=int, default=128)
    ap.add_argument("--tenants", type=int, default=1)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--interfere", action="store_true")
    ap.add_argument("--no-controller", action="store_true")
    ap.add_argument("--admit", type=int, default=0,
                    help="late-arriving tenants pushed through admission")
    ap.add_argument("--backend", choices=("dense", "paged"), default="dense",
                    help="engine KV backend: dense slot cache or the paged "
                         "runtime")
    ap.add_argument("--kv-dtype", choices=("auto", "int8"), default="auto",
                    help="paged backend page-pool dtype")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable cross-request prefix-page sharing "
                         "(paged backend)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="paged backend: max speculative draft tokens per "
                         "decode lane (0 = off)")
    ap.add_argument("--route", choices=("cache", "load"), default="cache",
                    help="replica dispatch: longest held prefix via the "
                         "prefix directory ('cache') or least-loaded "
                         "('load')")
    ap.add_argument("--route-imbalance", type=int, default=4,
                    help="max load lead of the cache-route target over "
                         "the least-loaded replica before falling back")
    ap.add_argument("--route-staleness", type=int, default=256,
                    help="max pending directory events before routing "
                         "falls back to least-loaded")
    ap.add_argument("--no-response-cache", action="store_true",
                    help="disable the per-tenant response cache that "
                         "self-primes speculative draft hints")
    ap.add_argument("--listen", action="store_true",
                    help="arm the gateway's backpressure: bounded door "
                         "queues, dispatch deadlines and Kingman-derived "
                         "rate limits")
    ap.add_argument("--door-queue", type=int, default=64,
                    help="--listen: bounded door-queue depth per tenant")
    ap.add_argument("--door-deadline-ms", type=float, default=1000.0,
                    help="--listen: queued requests not dispatched within "
                         "this deadline are EXPIRED")
    ap.add_argument("--det-timing", action="store_true",
                    help="deterministic per-token step-cost model instead "
                         "of the measured step time")
    ap.add_argument("--unique-prompts", action="store_true",
                    help="no shared prompt templates: each prompt is fully "
                         "distinct")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the published config instead of reduced()")
    ap.add_argument("--repeats", type=int, default=None,
                    help="cut the depth to this many repeats of the "
                         "config's layer period")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args, unknown = ap.parse_known_args(argv)
    refused = sorted({u.split("=")[0] for u in unknown
                      if u.split("=")[0] in _REFUSED_FLAGS})
    if refused:
        raise SystemExit(f"error: {', '.join(refused)}: chaos and fault "
                         f"injection, migration, drains and tracing are not "
                         f"ported yet (ROADMAP A5.2)")
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    serve(arch=args.arch, requests=args.requests, qps=args.qps,
          prompt_len=args.prompt_len, prompt_len_max=args.prompt_len_max,
          max_new=args.max_new, slots=args.slots, seq_cap=args.seq_cap,
          num_tenants=args.tenants, replicas=args.replicas,
          interfere=args.interfere, with_controller=not args.no_controller,
          seed=args.seed, admit=args.admit, backend=args.backend,
          kv_dtype=args.kv_dtype, prefix_cache=not args.no_prefix_cache,
          spec_k=args.spec_k, route=args.route,
          route_imbalance=args.route_imbalance,
          route_staleness=args.route_staleness,
          response_cache=not args.no_response_cache, listen=args.listen,
          door_queue=args.door_queue,
          door_deadline_ms=args.door_deadline_ms,
          det_timing=args.det_timing,
          unique_prompts=args.unique_prompts, reduce=not args.full_width,
          repeats=args.repeats, device=args.device)


if __name__ == "__main__":
    main()
