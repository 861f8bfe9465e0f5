"""Serving launcher: engines + controller co-deployed (the paper's
first-class integration), N latency tenants x R replicas on a virtual
clock; the PyTorch twin of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 32 \
        --qps 4 --device cuda [--full-width] [--tenants 2] [--replicas 2] \
        [--interfere] [--no-controller] [--admit 1] [--listen] \
        [--backend paged [--kv-dtype int8] [--spec-k 3] [--route load]] \
        [--chaos [--chaos-seed S] [--no-recover]] [--migrate] \
        [--drain-at T:TENANT:REPLICA] [--trace] [--trace-out PATH] \
        [--arch rwkv6_1_6b] [--arch jamba_v0_1_52b --repeats 2] \
        [--arch deepseek_v2_236b --repeats 6] [--arch phi_3_vision_4_2b] \
        [--arch seamless_m4t_large_v2] [--arch mixtral_8x7b --repeats 20]

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
many repeats of the config's layer period (a prefix, such as DeepSeek-V2's
dense first layer, stays).  Each tenant's replicas share
one set of weight tensors (the reference seeds them alike, so they serve
the same weights).

The failure domains are the reference's: ``--chaos`` arms a seeded
fault schedule (replica crashes, actuator-call failures through the
bounded-retry actuator, stuck decode lanes found by the watchdog, fabric
degradation), with recovery by redrive unless ``--no-recover``;
``--migrate`` ships a failing replica's KV pages to a live peer
(``serving/migrate.py``, chain-hash verified), for crashes, planned drains
(``--drain-at``) and gray failures (a replica whose step cost runs
``gray_threshold`` x its peers' is evacuated and quarantined).
``--trace`` arms the per-request flight recorder (``serving/trace.py``),
and ``--trace-out`` writes its Chrome trace.
"""
from __future__ import annotations

import argparse

_PAGE = 16           # KV page size, the reference's engine default


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
          trace: bool = False, trace_out: str = None,
          chaos: bool = False, chaos_seed: int = None,
          recover: bool = True, faults=None,
          watchdog_timeout_s: float = 1.5,
          migrate: bool = False, drains=None,
          gray_threshold: float = 2.5, gray_cooldown_s: float = 2.0,
          det_timing: bool = False, exact_tokens: bool = False,
          unique_prompts: bool = False, seq_cap: int = 128,
          reduce: bool = True, repeats: int = None, params=None,
          device="cuda"):
    """Virtual-time multi-tenant serving run; returns per-tenant stats
    (one dict per tenant name) and the fleet's keys (``routing``,
    ``gateway``, ``prometheus``, ``device``; ``directory`` and
    ``response_cache`` on the paged backend, ``admission`` with ``admit``,
    ``actions`` and ``arbiter_max_units`` with the controller, ``faults``
    under chaos, ``migrations`` with ``migrate`` or ``drains``, ``trace``
    with the flight recorder).

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
    ``trace`` (or ``trace_out``, a Chrome trace's path) arms the flight
    recorder: per-request segments that tile arrival to verdict, and every
    controller and actuator action on the shared virtual clock; tracing
    never moves the clock.  ``chaos`` (or an explicit ``faults``
    injector) arms the reference's seeded fault schedule; ``recover=False``
    sheds a crashed replica's requests instead of redriving them, and
    ``watchdog_timeout_s`` is the stuck-lane watchdog's.  ``migrate``
    recovers by verified KV-page shipping (crashes, ``drains`` as
    ``(time, tenant, replica)`` triples, and gray failures past
    ``gray_threshold`` x the best live peer's step cost, quarantined for
    ``gray_cooldown_s``).

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
    from repro_torch.core.faults import (FaultInjector, RetryingActuator,
                                         StuckLaneWatchdog)
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
    # ---- failure domains: deterministic fault schedule ---------------
    injector = faults
    if injector is None and chaos:
        injector = FaultInjector.plan(
            chaos_seed if chaos_seed is not None else seed + 7,
            duration_s=max(1.0, requests / qps),
            tenants=list(names), replicas=replicas,
            # a crash needs a survivor to redrive onto
            crashes=1 if replicas > 1 else 0,
            actuator_failures=2, stuck_lanes=1, fabric_windows=1,
            # gray failure only matters when migration can evacuate it;
            # plain chaos keeps the reference's schedule bit for bit
            slow_replicas=1 if (migrate and replicas > 1) else 0)
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
    # under chaos the controller actuates through the bounded-retry
    # wrapper (``controller`` binds later; the lambda resolves at call time)
    retrying = None
    if injector is not None:
        retrying = RetryingActuator(
            actuator, lambda: now[0], faults=injector,
            fsm_for=lambda t: (controller.fsm_for(t)
                               if controller is not None else None))
    watchdog = (StuckLaneWatchdog(timeout_s=watchdog_timeout_s)
                if injector is not None else None)
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
        controller = Controller(topo, A100_MIG,
                                retrying if retrying is not None
                                else actuator,
                                ControllerConfig(policy=PolicyConfig(
                                    tau_s=0.200, persistence=2,
                                    dwell_obs=20, cooldown_obs=10)))
        controller.register_registry(registry, placements={
            **placements, "T2": [Slot(0, "h0:g1", 0)],
            "T3": [Slot(0, "h0:g0", 1)]})

    recorder = None
    if trace or trace_out:
        from repro_torch.serving.trace import FlightRecorder
        recorder = FlightRecorder()

    def warm(name):
        for eng in engines[name]:
            warm_engine(eng, name, prompt_len)
        # the recorder attaches only AFTER warming: the warm request stays
        # out of the trace as it stays out of metrics and the caches
        if recorder is not None:
            for eng in engines[name]:
                eng.tracer = recorder

    # warm-up (kernel build, allocator and library warm-up) stays out of
    # the virtual clock, the metrics, the response cache and the directory
    for name in names:
        warm(name)
    if recorder is not None:
        gateway.tracer = recorder
        actuator.tracer = recorder
        if retrying is not None:
            retrying.tracer = recorder
        if controller is not None:
            controller.tracer = recorder
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
    # ---- lane-migration state ----------------------------------------
    migrations = []                       # completed-migration summaries
    redriven_ids = {name: set() for name in names}   # req_ids that moved
    drain_events = deque(sorted(drains)) if drains else deque()
    step_hist = {}       # (tenant, replica) -> deque of per-token cost
    quarantine = {}      # (tenant, replica) -> readmit time (gray)
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
                                        AdmissionConfig(), tracer=recorder)
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
        warm(name)
        windows[name] = LatencyWindow()
        gateway.door_cfgs[name] = door_cfg_for(spec)
        preempts[name] = 0
        redriven_ids[name] = set()
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

    # ---- failure-domain recovery handlers ----------------------------
    def migrate_replica(name, j, reason):
        """Evacuate replica ``j`` by KV-page shipping: drain its lanes
        WITH state, price the transfer against the fabric, and import
        each page chain into the least-loaded live peer.  Verified
        lanes are adopted warm (handoff span covers the transfer, TTFT
        stamp conserved); cold / checksum-rejected lanes take the
        recompute redrive — never a wrong token.  Returns
        ``(dst, transfer_s)`` or None when there is no live peer or the
        (possibly fault-injected) actuator call did not land."""
        live = [k for k in gateway.live_replicas(name) if k != j]
        if not live:
            return None
        dst = min(live, key=lambda k: (len(engines[name][k].queue)
                                       + len(engines[name][k].active()), k))
        n_before = len(actuator.migrations)
        act = retrying if retrying is not None else actuator
        act.migrate(name, j, dst)
        if len(actuator.migrations) == n_before:
            return None            # injected failure ate the call
        rec = actuator.migrations.pop()
        # the transfer may overlap the source's step in flight, but a
        # lane resumes no earlier than that step's end: its tokens are
        # already stamped there, and a lane resumed before it would emit
        # a token before its own last one
        arrive = max(now[0] + rec["transfer_s"], avail.get((name, j), 0.0))
        moved = rec["warm"] + rec["cold"]
        gateway.adopt_warm(name, rec["warm"], now[0], arrive,
                           from_engine=j, to_engine=dst)
        gateway.redrive(name, rec["cold"], now[0], from_engine=j)
        redriven_ids[name].update(r.req_id for r in moved)
        if watchdog is not None:
            for r in moved:
                watchdog.forget((name, j, r.req_id))
        # the destination stalls for the transfer: migration is fabric
        # traffic like any tenant flow, and it pays in virtual time too
        avail[(name, dst)] = max(avail.get((name, dst), 0.0), arrive)
        migrations.append({
            "t": now[0], "tenant": name, "from": j, "to": dst,
            "reason": reason, "warm": len(rec["warm"]),
            "cold": len(rec["cold"]), "pages": rec["pages"],
            "bytes": rec["bytes"], "transfer_s": rec["transfer_s"],
            "attached_pages": rec["attached_pages"],
            "copied_pages": rec["copied_pages"],
            "verify_failures": rec["verify_failures"]})
        if verbose:
            print(f"  t={now[0]:6.1f}s MIGRATE {name}/r{j}->r{dst} "
                  f"({reason}): {len(rec['warm'])} warm "
                  f"({rec['attached_pages']} attached / "
                  f"{rec['copied_pages']} shipped pages, "
                  f"{rec['bytes'] / 1e6:.2f} MB in "
                  f"{rec['transfer_s'] * 1e3:.1f} ms), "
                  f"{len(rec['cold'])} recompute")
        return dst, rec["transfer_s"]

    def run_drains():
        """Planned scale-down: evacuate the replica's lanes (page
        shipping under ``migrate``, recompute redrive otherwise — never
        shed), then release its slots for good."""
        while drain_events and drain_events[0][0] <= now[0]:
            _, name, j = drain_events.popleft()
            if name not in engines or j >= len(engines[name]):
                continue
            if j not in gateway.live_replicas(name):
                continue
            if len(gateway.live_replicas(name)) <= 1:
                continue             # never drain the last live replica
            gateway.mark_dead(name, j)
            routers[name].mark_dead(j)
            directory.retract_replica(name, j)
            if recorder is not None:
                recorder.on_fault(now[0], "planned_drain", tenant=name,
                                  replica=j)
            res = migrate_replica(name, j, "drain") if migrate else None
            if res is None:
                drained = engines[name][j].drain_requests()
                redriven_ids[name].update(r.req_id for r in drained)
                if watchdog is not None:
                    for r in drained:
                        watchdog.forget((name, j, r.req_id))
                n = gateway.redrive(name, drained, now[0], from_engine=j)
                if verbose:
                    print(f"  t={now[0]:6.1f}s DRAIN {name}/r{j}: "
                          f"redrove {n} request(s) cold")
            ledger.release(name, replica=j)
            avail[(name, j)] = now[0]

    def run_gray_detector():
        """Tail-based gray-failure detection: a replica whose recent
        per-token step cost is ``gray_threshold`` x its best live
        peer's gets evacuated (warm, under ``migrate``) and quarantined
        before the per-lane watchdog would fire."""
        for name in list(names):
            live = [k for k in gateway.live_replicas(name)
                    if (name, k) not in quarantine]
            if len(live) < 2:
                continue
            means = {}
            for k in live:
                h = step_hist.get((name, k))
                if h is not None and len(h) >= 4:
                    means[k] = sum(h) / len(h)
            if len(means) < 2:
                continue
            best = min(means.values())
            if best <= 0:
                continue
            for k, m in sorted(means.items()):
                if m > gray_threshold * best:
                    evacuate_gray(name, k)
                    break            # one evacuation per tenant per tick

    def evacuate_gray(name, j):
        gateway.mark_dead(name, j)       # quarantine: reversible mask
        directory.retract_replica(name, j)
        if recorder is not None:
            recorder.on_fault(now[0], "gray_evacuate", tenant=name,
                              replica=j)
        res = migrate_replica(name, j, "gray")
        if res is None:
            drained = engines[name][j].drain_requests()
            redriven_ids[name].update(r.req_id for r in drained)
            if watchdog is not None:
                for r in drained:
                    watchdog.forget((name, j, r.req_id))
            gateway.redrive(name, drained, now[0], from_engine=j)
        quarantine[(name, j)] = now[0] + gray_cooldown_s
        step_hist.pop((name, j), None)
        if injector is not None:
            injector.log.append((now[0], "gray_evacuate", f"{name}/{j}"))
        if verbose:
            print(f"  t={now[0]:6.1f}s GRAY {name}/r{j}: evacuated, "
                  f"quarantined until t={quarantine[(name, j)]:.1f}s")

    def run_quarantine():
        for (name, j), until in list(quarantine.items()):
            if now[0] >= until:
                del quarantine[(name, j)]
                gateway.mark_live(name, j)
                avail[(name, j)] = max(avail[(name, j)], now[0])
                if verbose:
                    print(f"  t={now[0]:6.1f}s GRAY {name}/r{j}: "
                          f"readmitted")

    def crash_replica(name, j):
        """Replica death: mask it everywhere a request could still reach
        it, release every resource it held, then redrive (or, recovery
        off, shed) its in-flight requests.  Order matters: masking first
        so nothing routes to the corpse, drain releases the pages, the
        verdict/redrive decision comes last."""
        if name not in engines or j >= len(engines[name]):
            return
        live = gateway.live_replicas(name)
        if j not in live:
            if (name, j) in quarantine:
                # the quarantined gray replica died for real: make its
                # mask permanent instead of readmitting a corpse
                del quarantine[(name, j)]
                routers[name].mark_dead(j)
                ledger.release(name, replica=j)
                injector.log.append(
                    (now[0], "crash_in_quarantine", f"{name}/{j}"))
            return                       # already dead
        if len(live) <= 1:
            # never kill the last live replica: redriven work (and all
            # future arrivals) would have nowhere to land — log the
            # skip so replay identity still covers it
            injector.log.append(
                (now[0], "crash_skipped_last_replica", f"{name}/{j}"))
            return
        eng = engines[name][j]
        gateway.mark_dead(name, j)
        routers[name].mark_dead(j)
        directory.retract_replica(name, j)
        if recover and migrate:
            # warm standby adoption: the corpse's pages survive in the
            # shared host pool, so ship them instead of recomputing
            res = migrate_replica(name, j, "crash")
            if res is not None:
                ledger.release(name, replica=j)
                avail[(name, j)] = now[0]
                return
        drained = eng.drain_requests()
        ledger.release(name, replica=j)
        if watchdog is not None:
            for r in drained:
                watchdog.forget((name, j, r.req_id))
        if recover:
            n = gateway.redrive(name, drained, now[0], from_engine=j)
            redriven_ids[name].update(r.req_id for r in drained)
            verb = "redrove"
        else:
            n = gateway.abandon(name, drained, now[0])
            verb = "shed"
        avail[(name, j)] = now[0]        # dead engines never step again
        if verbose:
            print(f"  t={now[0]:6.1f}s CRASH {name}/r{j}: {verb} {n} "
                  f"in-flight request(s) "
                  f"({len(live) - 1} live replica(s) remain)")

    def stick_lane(name, j):
        """Hang one active decode lane (lowest req_id, deterministic) on
        the target replica; the watchdog detects the stalled progress
        and requeues it through the refcount-safe preemption path."""
        if name not in engines or j >= len(engines[name]):
            return
        if j not in gateway.live_replicas(name):
            return
        eng = engines[name][j]
        if eng.runtime is None:
            return
        sched = eng.runtime.sched
        lanes = [s.req.req_id for s in sched.active
                 if s.req.req_id not in sched.stuck]
        if not lanes:
            injector.log.append(
                (now[0], "stuck_skipped_no_lane", f"{name}/{j}"))
            return
        sched.mark_stuck(min(lanes))

    def apply_faults():
        for f in injector.due(now[0]):
            if recorder is not None:
                recorder.on_fault(now[0], f.kind, tenant=f.tenant,
                                  replica=f.replica, method=f.method)
            if f.kind == "replica_crash":
                crash_replica(f.tenant, f.replica)
            elif f.kind == "lane_stuck":
                stick_lane(f.tenant, f.replica)
            # actuator_fail / fabric_degrade armed inside the injector

    def run_watchdog():
        # feed every live lane's token progress, drop lanes that left
        # the active set (completed / preempted / drained), then requeue
        # whatever made no progress for the whole timeout
        live_keys = set()
        for name in names:
            for j in gateway.live_replicas(name):
                eng = engines[name][j]
                if eng.runtime is None:
                    continue
                for s in eng.runtime.sched.active:
                    key = (name, j, s.req.req_id)
                    live_keys.add(key)
                    watchdog.observe(key, s.req.generated, now[0])
        watchdog.prune(live_keys)
        for name, j, rid in watchdog.stale(now[0]):
            sched = engines[name][j].runtime.sched
            seq = sched.find(rid)
            if seq is None or seq in sched.waiting:
                continue
            if recorder is not None:
                recorder.on_preempt(seq.req, now[0],
                                    engine=f"{name}/r{j}")
            sched.preempt(seq)
            preempts[name] += 1
            injector.log.append(
                (now[0], "watchdog_requeue", f"{name}/{j}/{rid}"))
            if verbose:
                print(f"  t={now[0]:6.1f}s WATCHDOG {name}/r{j}: "
                      f"requeued stuck lane req {rid}")

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
        if injector is not None:
            apply_faults()
        if drain_events:
            run_drains()
        if quarantine:
            run_quarantine()
        if injector is not None and migrate and recover:
            run_gray_detector()
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
                if injector is not None:
                    base = dur
                    # transient fabric degradation inflates the step, and
                    # a gray replica quietly runs slow
                    dur *= injector.fabric_factor(now[0])
                    dur *= injector.replica_factor(name, j, now[0])
                    # the gray detector's signal: the step's time over the
                    # model's own prediction, per replica
                    h = step_hist.setdefault((name, j), deque(maxlen=8))
                    h.append(dur / max(base, 1e-12))
                end = now[0] + dur
                avail[(name, j)] = end
                # engine timestamps + token-stream mirroring + terminal
                # COMPLETED verdicts
                gateway.finalize(name, eng, rep, end, start_time=now[0])
                for pr in rep.prefilled:
                    windows[name].observe(end, pr.ttft, slo=0.2)
                stepped = True
        if watchdog is not None:
            run_watchdog()
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
        horizon.extend(t for t, _, _ in drain_events)
        horizon.extend(t for t in quarantine.values() if t > now[0])
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
            # KV pages still held by sequences, per replica (0 after a
            # clean run, dead and drained replicas included)
            "kv_pages_held": [e.kv.reserved_pages for e in engs],
            # TTFTs of requests that survived an evacuation (warm or cold)
            "redriven_ids": sorted(int(i) for i in redriven_ids[name]),
            "redriven_ttft_ms": sorted(
                float(r.ttft * 1e3) for r in done
                if r.req_id in redriven_ids[name]),
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
    if injector is not None:
        out["faults"] = {
            "log": list(injector.log),
            "pending": injector.pending(),
            "recover": recover,
            "redriven": {name: gateway.door(name).redriven
                         for name in names},
            "watchdog_fired": watchdog.fired,
        }
        if retrying is not None:
            out["faults"]["actuator"] = dict(retrying.stats)
            out["faults"]["actuator_time_lost_s"] = retrying.time_lost_s
        if verbose and injector.log:
            print(f"faults: {len(injector.log)} event(s), "
                  f"redriven={out['faults']['redriven']}, "
                  f"watchdog_fired={watchdog.fired}, "
                  f"actuator={out['faults'].get('actuator')}")
    if migrations or migrate or drains:
        out["migrations"] = migrations
        if verbose and migrations:
            warm_n = sum(m["warm"] for m in migrations)
            cold_n = sum(m["cold"] for m in migrations)
            print(f"migrations: {len(migrations)} "
                  f"({warm_n} warm lane(s), {cold_n} recompute, "
                  f"{sum(m['bytes'] for m in migrations) / 1e6:.2f} MB "
                  f"shipped)")
    out["gateway"] = gateway.counters()
    out["prometheus"] = gateway.prometheus(now[0])
    out["device"] = {
        "device": str(dev), "virtual_s": now[0],
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None)}
    gateway.check()     # offered == completed+rejected+shed+expired+in_flight
    ledger.check()
    if recorder is not None:
        recorder.check()    # per-request: segments sum to measured E2E
        out["trace"] = recorder.breakdown(now[0])
        if trace_out:
            recorder.dump(trace_out)
        if verbose:
            print(recorder.table())
            if trace_out:
                print(f"trace written to {trace_out}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="stablelm_3b",
                    help="any config of configs/ (e.g. rwkv6_1_6b, "
                         "jamba_v0_1_52b, deepseek_v2_236b, "
                         "phi_3_vision_4_2b, seamless_m4t_large_v2, "
                         "mixtral_8x7b); the paged backend takes the "
                         "GQA stacks without windows only")
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
    ap.add_argument("--trace", action="store_true",
                    help="arm the per-request flight recorder (span "
                         "timelines whose segments sum to the measured E2E, "
                         "plus controller actions on a shared timeline)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace_event JSON here "
                         "(implies --trace)")
    ap.add_argument("--chaos", action="store_true",
                    help="arm deterministic fault injection: a seeded "
                         "schedule of replica crashes, actuator failures, "
                         "stuck lanes and fabric degradation")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="fault-schedule seed (default: --seed + 7)")
    ap.add_argument("--no-recover", action="store_true",
                    help="keep the fault schedule but shed a crashed "
                         "replica's in-flight requests instead of "
                         "redriving them")
    ap.add_argument("--migrate", action="store_true",
                    help="recover by verified KV-page shipping instead of "
                         "recompute (crashes, drains, gray failures)")
    ap.add_argument("--drain-at", action="append", default=[],
                    metavar="T:TENANT:REPLICA",
                    help="planned scale-down: at virtual time T evacuate "
                         "TENANT's replica REPLICA (repeatable; lanes are "
                         "migrated or redriven, never shed)")
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
    args = ap.parse_args(argv)
    drains = []
    for spec in args.drain_at:
        try:
            t, tenant, rep = spec.split(":")
            drains.append((float(t), tenant, int(rep)))
        except ValueError:
            raise SystemExit(f"--drain-at wants T:TENANT:REPLICA, "
                             f"got {spec!r}")
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
          trace=args.trace, trace_out=args.trace_out,
          chaos=args.chaos, chaos_seed=args.chaos_seed,
          recover=not args.no_recover,
          migrate=args.migrate, drains=drains or None,
          det_timing=args.det_timing,
          unique_prompts=args.unique_prompts, reduce=not args.full_width,
          repeats=args.repeats, device=args.device)


if __name__ == "__main__":
    main()
