"""Where a serving step's time goes on the card: an engine at full width
under ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch stablelm_3b|rwkv6_1_6b|jamba_v0_1_52b] [--repeats 2] \
        [--backend dense|paged] [--requests 8] [--kv-dtype int8] \
        [--out profile.json]

Submits ``requests`` prompts of 64..1024 tokens at once to a warmed engine
(kernel build, library warm-up) and drains them twice, each time on a
fresh engine over the same weights: first without the profiler, for the
steps' compute time, then under it.  The profiler adds host time to every
launch but not device time, so the device's busy time under it (the union
of kernel intervals) over the first drain's compute time is the busy share
of an unprofiled step.  Prints both, the kernels launched per step, and
device time grouped by kernel family (with each family's share of the busy
time) and by kernel name.  The backend is the dense slot cache unless
``--backend paged``, as in ``launch/serve.py``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch

_FAMILIES = (("paged_attention", ("paged_attention",)),
             ("flash_attention", ("flash_attention",)),
             ("rwkv6_scan", ("rwkv6_scan",)),
             ("selective_scan", ("selective_scan",)),
             ("matmul", ("gemm", "gemv", "cutlass", "sm90_xmma", "nvjet")),
             ("index/scatter", ("index", "scatter", "gather")),
             ("reduce", ("reduce", "norm")))


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in _FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "elementwise/other"


def busy_union(intervals) -> float:
    """Total length covered by (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--backend", choices=("dense", "paged"), default="dense")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--kv-dtype", choices=("auto", "int8"), default="auto")
    ap.add_argument("--repeats", type=int, default=None,
                    help="cut the depth to this many repeats of the "
                         "config's layer period (full width)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import warm_engine, with_repeats
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request

    cfg = get_config(args.arch)
    if args.repeats is not None:
        cfg = with_repeats(cfg, args.repeats)
    params = None
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in rng.integers(64, 1025, args.requests)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def drain(profile: bool):
        """A fresh warmed engine serves every prompt, its steps under the
        profiler if ``profile``; returns (steps, summed compute_s, host
        seconds, profiler or None)."""
        nonlocal params
        eng = ServingEngine(cfg, params=params, max_slots=8, seq_cap=2048,
                            page_size=16, seed=args.seed,
                            backend=args.backend, kv_dtype=args.kv_dtype,
                            device="cuda")
        params = eng.params
        warm_engine(eng, "T1", 64)
        for i, p in enumerate(prompts):
            if not eng.submit(Request(req_id=i, tenant="T1",
                                      prompt_len=len(p),
                                      max_new_tokens=args.max_new,
                                      arrival=0.0, prompt_tokens=p)):
                raise RuntimeError(f"request {i} refused")
        prof = torch.profiler.profile(activities=acts) if profile else None
        steps, compute_s = 0, 0.0
        with prof if profile else contextlib.nullcontext():
            t0 = time.perf_counter()
            while eng.has_work():
                rep = eng.step()
                eng.finalize_step(rep, 0.0)
                steps += 1
                compute_s += rep.compute_s
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return steps, compute_s, wall, prof

    plain_steps, plain_compute_s, _, _ = drain(profile=False)
    torch.cuda.empty_cache()
    steps, compute_s, wall, prof = drain(profile=True)
    if steps != plain_steps:
        raise RuntimeError(f"the profiled drain took {steps} steps, the "
                           f"unprofiled one {plain_steps}")
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy_us = busy_union(intervals)
    by_name, by_family = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        fam = family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + us
    span_us = (max(e for _, e in intervals) - min(s for s, _ in intervals)
               if intervals else 0.0)
    out = {
        "device": torch.cuda.get_device_name(0), "arch": args.arch,
        "layers": cfg.num_layers,
        "backend": args.backend, "kv_dtype": args.kv_dtype, "steps": steps,
        "unprofiled_steps_compute_s": plain_compute_s,
        "host_wall_s": wall, "steps_compute_s": compute_s,
        "device_busy_s": busy_us / 1e6, "device_span_s": span_us / 1e6,
        "idle_share_of_compute": 1.0 - busy_us / 1e6 / compute_s,
        "idle_share_unprofiled": 1.0 - busy_us / 1e6 / plain_compute_s,
        "kernels": len(kernels), "kernels_per_step": len(kernels) / steps,
        "by_family_s": {k: v / 1e6 for k, v in sorted(
            by_family.items(), key=lambda kv: -kv[1])},
        "by_family_share_of_busy": {k: v / busy_us for k, v in sorted(
            by_family.items(), key=lambda kv: -kv[1])},
        "top_kernels_s": {k: v / 1e6 for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:15]},
    }
    print(json.dumps(out, indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
