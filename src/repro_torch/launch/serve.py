"""Serving launcher: one tenant, one replica, on a virtual clock (the
PyTorch twin of the single-tenant core of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 \
        --device cuda [--full-width] [--arch rwkv6_1_6b] \
        [--arch jamba_v0_1_52b --repeats 2] \
        [--backend paged [--kv-dtype int8] [--spec-k 3]]

Seeded Poisson arrivals at ``qps`` reach one ``ServingEngine``; after a
warm-up drain (kernel build, allocator warm-up) kept out of the metrics,
the engine steps back to back and the virtual clock advances by each
step's measured ``compute_s``.  The backend is the dense slot cache unless
``--backend paged``, as in the reference.  Paged prompts are a shared
per-tenant template (two thirds of the shortest prompt, page-aligned) plus
a random tail; dense prompts are left to the engine, which draws them from
its seeded generator, as in the reference.  It serves
``reduced(get_config(arch))`` unless ``reduce=False`` (``--full-width``);
``repeats`` (``--repeats``) then cuts the depth to that many repeats of
the config's layer period, so that a model larger than one card (Jamba's
published 4 x 8 layers) serves at its published widths.

The reference's multi-tenant, multi-replica harness (gateway, router,
controller, admission, interference, chaos, migration, tracing) is not
ported yet: the port runs as the reference does with ``--no-controller``,
and the harness's other flags are refused with an error naming ROADMAP A5.
"""
from __future__ import annotations

import argparse
from collections import deque

import numpy as np

_PAGE = 16           # KV page size, the reference's engine default
# the reference harness's flags that this port does not carry yet: each is
# refused with an error naming the ROADMAP item that will bring it
_REFUSED_FLAGS = ("--interfere", "--admit", "--listen", "--door-queue",
                  "--door-deadline-ms", "--route", "--route-imbalance",
                  "--route-staleness", "--no-response-cache", "--trace",
                  "--trace-out", "--chaos", "--chaos-seed", "--no-recover",
                  "--migrate", "--drain-at", "--det-timing",
                  "--unique-prompts")


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
    and library warm-up), then reset the engine's metrics so the warm
    request (req_id=-1, virtual time 0) leaves no sample behind."""
    from repro_torch.serving.metrics import TenantMetrics
    from repro_torch.serving.request import Request

    eng.submit(Request(req_id=-1, tenant=name, prompt_len=prompt_len,
                       max_new_tokens=2, arrival=0.0))
    while eng.has_work():
        eng.finalize_step(eng.step(), 0.0)
    eng.metrics = TenantMetrics()


def serve(arch: str = "stablelm_3b", requests: int = 32, qps: float = 4.0,
          prompt_len: int = 48, prompt_len_max: int = None, max_new: int = 8,
          slots: int = 4, seq_cap: int = 128, seed: int = 0,
          verbose: bool = True, kv_dtype: str = "auto",
          prefix_cache: bool = True, spec_k: int = 0, reduce: bool = True,
          backend: str = "dense", params=None, repeats: int = None,
          device="cuda"):
    """Virtual-time single-tenant serving run; returns its stats.

    Prompt lengths are ``prompt_len``, or drawn uniformly from
    ``[prompt_len, prompt_len_max]`` when that is given.  ``params`` are
    the weights to serve (a nested dict of tensors with the plan's names,
    for the config ``arch``, ``reduce`` and ``repeats`` select); ``None``
    draws random ones from ``seed``."""
    import torch
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.device import resolve_device
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request

    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduce:
        cfg = reduced(cfg)
    if repeats is not None:
        cfg = with_repeats(cfg, repeats)
    name = "T1"
    paged = backend == "paged"
    eng = ServingEngine(cfg, params, max_slots=slots, seq_cap=seq_cap,
                        page_size=_PAGE, seed=seed, backend=backend,
                        kv_dtype=kv_dtype, prefix_cache=prefix_cache,
                        spec_k=spec_k, device=dev)
    # warm-up (kernel build, allocator and library warm-up) stays out of
    # the virtual clock and the metrics
    warm_engine(eng, name, prompt_len)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    rng = np.random.default_rng(seed)
    hi = prompt_len if prompt_len_max is None else prompt_len_max
    lens = rng.integers(prompt_len, hi + 1, requests)
    tmpl_len = (prompt_len * 2 // 3) // _PAGE * _PAGE
    templates = (rng.integers(0, cfg.vocab_size, (4, tmpl_len)) if paged
                 else None)
    arrivals = np.cumsum(rng.exponential(1.0 / qps, requests))
    reqs = []
    for i, (n, t) in enumerate(zip(lens, arrivals)):
        prompt = None
        if paged:
            head = templates[int(rng.integers(len(templates)))]
            tail = rng.integers(0, cfg.vocab_size, int(n) - tmpl_len)
            prompt = np.concatenate([head, tail]).astype(np.int64)
        reqs.append(Request(req_id=i, tenant=name, prompt_len=int(n),
                            max_new_tokens=max_new, arrival=float(t),
                            slo_ms=200.0, prompt_tokens=prompt))
    if verbose:
        print(f"serving {cfg.name} ({cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.dtype}, {backend}, kv {kv_dtype}) on "
              f"{dev}: "
              f"{requests} req at {qps} qps, prompts {prompt_len}-{hi}, "
              f"max_new {max_new}")

    pending = deque(reqs)
    rejected = []
    now = 0.0
    steps = 0
    compute_s = 0.0
    while pending or eng.has_work():
        while pending and pending[0].arrival <= now:
            r = pending.popleft()
            if not eng.submit(r):
                rejected.append(r)
        if eng.has_work():
            rep = eng.step()
            if rep.kind != "idle":
                end = now + rep.compute_s
                eng.finalize_step(rep, end, start_time=now)
                now = end
                steps += 1
                compute_s += rep.compute_s
                continue
            if not pending:
                raise RuntimeError("the engine holds work but planned an "
                                   "empty step with no arrival to wait for")
        if pending:
            now = max(now, pending[0].arrival)

    done = [r for r in reqs if r.done]
    ttfts = np.array([r.ttft for r in done]) * 1e3
    itls = np.array([v for r in done for v in r.itls]) * 1e3
    gen = sum(len(r.output_tokens) for r in done)
    span = max((r.finished for r in done), default=0.0) - float(arrivals[0])

    def q(a, p):
        return float(np.quantile(a, p)) if len(a) else 0.0

    out = {
        "completed": len(done), "offered": len(reqs),
        "layers": cfg.num_layers,
        "rejected": len(rejected), "steps": steps,
        "backend": backend, "forward_passes": eng.forward_passes,
        "prefill_passes": eng.prefill_passes,
        "compute_s": compute_s, "virtual_s": now,
        "ttft_p50_ms": q(ttfts, .5), "ttft_p99_ms": q(ttfts, .99),
        "itl_p50_ms": q(itls, .5), "itl_p99_ms": q(itls, .99),
        "tokens_per_s": gen / span if span > 0 else 0.0,
        "generated_tokens": gen,
        "prompt_tokens": int(sum(r.prompt_len for r in reqs)),
        "logits_finite": eng.logits_finite,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
        "outputs": {int(r.req_id): [int(t) for t in r.output_tokens]
                    for r in done},
    }
    if verbose:
        print(f"  {name}: completed {len(done)}/{len(reqs)} "
              f"(rejected {len(rejected)}) in {steps} steps "
              f"TTFT p50={out['ttft_p50_ms']:.1f}ms "
              f"p99={out['ttft_p99_ms']:.1f}ms "
              f"ITL p50={out['itl_p50_ms']:.1f}ms "
              f"p99={out['itl_p99_ms']:.1f}ms "
              f"tokens/s={out['tokens_per_s']:.1f} "
              f"logits_finite={out['logits_finite']}")
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
    ap.add_argument("--kv-dtype", choices=("auto", "int8"), default="auto")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--spec-k", type=int, default=0)
    ap.add_argument("--full-width", action="store_true",
                    help="serve the published config instead of reduced()")
    ap.add_argument("--repeats", type=int, default=None,
                    help="cut the depth to this many repeats of the "
                         "config's layer period")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", choices=("dense", "paged"), default="dense",
                    help="engine KV backend: dense slot cache or the paged "
                         "runtime")
    ap.add_argument("--tenants", type=int, default=1)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--no-controller", action="store_true",
                    help="accepted for the reference's command lines: the "
                         "port has no controller yet (ROADMAP A5)")
    args, unknown = ap.parse_known_args(argv)
    refused = sorted({u.split("=")[0] for u in unknown
                      if u.split("=")[0] in _REFUSED_FLAGS})
    if args.tenants != 1:
        refused.append("--tenants > 1")
    if args.replicas != 1:
        refused.append("--replicas > 1")
    if refused:
        raise SystemExit(f"error: {', '.join(refused)}: the reference's "
                         f"multi-tenant harness is not ported yet "
                         f"(ROADMAP A5)")
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    serve(arch=args.arch, requests=args.requests, qps=args.qps,
          prompt_len=args.prompt_len, prompt_len_max=args.prompt_len_max,
          max_new=args.max_new, slots=args.slots, seq_cap=args.seq_cap,
          seed=args.seed, kv_dtype=args.kv_dtype,
          prefix_cache=not args.no_prefix_cache, spec_k=args.spec_k,
          reduce=not args.full_width, backend=args.backend,
          repeats=args.repeats, device=args.device)


if __name__ == "__main__":
    main()
