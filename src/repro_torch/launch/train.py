"""Training launcher, the PyTorch twin of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_3b \
        --steps 200 --batch 8 --seq 128 --device cpu

trains the reduced config on the pipeline's batches, as the reference
does (``--checkpoint PATH`` writes the final parameters in the
reference's container).

    PYTHONPATH=src python -m repro_torch.launch.train --full-width \
        --device cuda [--arch stablelm_3b]

trains the published config (bf16, remat on) on one card: one synthetic
batch of ``--batch`` x ``--seq`` tokens (2 x 4096 by default,
``train_4k``'s length) memorised for ``--steps`` steps (6), with
AdamW(lr 1e-3, 2 warmup steps), and prints each step's time, loss and
gradient norm, the tokens a second and the peak of allocated memory.
Every config trains through the port's kernels, the two recurrences
through their hand-written backward kernels too (ROADMAP A7.2):
``--arch rwkv6_1_6b --lr 1e-4`` trains RWKV-6 1.6B at full width and
depth (at 1e-3 its random weights overflow bf16 within two steps: the
channel-mix runs on the residual stream without a norm, as in the
reference), and

    PYTHONPATH=src python -m repro_torch.launch.train --full-width \
        --device cuda --arch jamba_v0_1_52b --period-layers 2

trains Jamba at its published widths cut in depth to the first two layers
of its period (Mamba + dense FFN, Mamba + MoE; its 51.6 B parameters do
not fit one card).  ``examples/train_small.py``'s twin on the card is

    PYTHONPATH=src python -m repro_torch.launch.train --arch \
        jamba_v0_1_52b --steps 200 --batch 8 --seq 64 --lr 1e-3 \
        --device cuda --expect-loss-drop

(the reduced branch warms up for and logs every ``max(steps // 10, 1)``
steps, 20 here, as the example does).  ``--full`` runs the plan-level dry
run of the published config's ``train_4k`` step on the production mesh
(``launch/dryrun.py``), as the reference's ``--full`` runs its dry run.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Optional

import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.models.params import plan_leaves
from repro_torch.training import optimizer as opt
from repro_torch.training.data import SyntheticTokenPipeline
from repro_torch.training.trainer import (batch_to_torch, make_train_step,
                                          train, trainable)

FULL_WIDTH = dict(steps=6, batch=2, seq=4096, lr=1e-3, warmup=2)
REDUCED = dict(steps=100, batch=8, seq=128, lr=3e-4)


def frontend_of(cfg) -> Optional[dict]:
    """The data pipeline's frontend options for ``cfg`` (patch embeds for
    a VLM, frames for an enc-dec model)."""
    if cfg.frontend.kind == "vision":
        return {"kind": "vision", "num_prefix": cfg.frontend.num_prefix,
                "embed_dim": cfg.frontend.embed_dim}
    if cfg.frontend.kind == "audio":
        return {"kind": "audio", "embed_dim": cfg.frontend.embed_dim}
    return None


def with_period_layers(cfg, layers: int):
    """``cfg`` cut in depth to the first ``layers`` layers of its period,
    repeated once: a depth cut, its widths untouched."""
    if not cfg.period or not 1 <= layers <= len(cfg.period):
        raise ValueError(f"{cfg.name}: cannot keep {layers} layers of a "
                         f"period of {len(cfg.period)}")
    return cfg.replace(period=cfg.period[:layers], repeats=1)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bad_grad_leaves(params, grads) -> list:
    """Paths of the leaves whose gradient is not finite or is all zero."""
    def walk(p, g, prefix):
        if isinstance(p, dict):
            return [x for k in sorted(p)
                    for x in walk(p[k], g[k], prefix + (k,))]
        ok = bool(torch.isfinite(g).all()) and bool((g != 0).any())
        return [] if ok else ["/".join(prefix)]
    return walk(params, grads, ())


def step_profile(prof, step_ms: float) -> dict:
    """Device time of a profiled step: the union of its kernels' intervals
    (busy), the idle share of an unprofiled step of ``step_ms``, and the
    time by kernel family (``launch/profile_serve.py``'s families)."""
    from repro_torch.launch.profile_serve import busy_union, family
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = busy_union([(e.time_range.start, e.time_range.end)
                          for e in kernels])
    by_family, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_family[family(e.name)] = by_family.get(family(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    return {
        "device_busy_ms": busy_us / 1e3, "kernels": len(kernels),
        "idle_share_unprofiled": 1.0 - busy_us / 1e3 / step_ms,
        "by_family_ms": {k: v / 1e3 for k, v in sorted(
            by_family.items(), key=lambda kv: -kv[1])},
        "by_family_share_of_busy": {k: v / busy_us for k, v in sorted(
            by_family.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": {k: v / 1e3 for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]}}


def train_full_width(arch: str = "stablelm_3b", *, steps: int = 6,
                     batch: int = 2, seq: int = 4096, lr: float = 1e-3,
                     warmup: int = 2, seed: int = 0, device="cuda",
                     profile: bool = False, cfg=None,
                     period_layers: Optional[int] = None,
                     log=print) -> dict:
    """Train ``arch``'s published config (or ``cfg``; cut to the first
    ``period_layers`` layers of its period if given, ``with_period_layers``,
    the cut named under ``cut``) on one memorised synthetic batch, with
    remat, through ``make_train_step``'s step.
    Returns the losses, gradient norms and step times (ms,
    device-synchronised; ``optimizer_ms`` the part of each spent in
    ``apply_updates``), tokens a second over the unprofiled steps after
    the first, the peak of allocated memory (CUDA), and the leaves whose
    gradient was not finite or all zero at some step (checked after each
    step, outside its time and the profiler);
    with ``profile`` (CUDA) the last step runs under ``torch.profiler`` and
    ``profile`` holds where its device time went (``step_profile``)."""
    dev = resolve_device(device)
    cfg = cfg or get_config(arch)
    cut = ""
    if period_layers is not None:
        cut = (f"depth cut to the first {period_layers} layer(s) of its "
               f"{len(cfg.period)}-layer period, 1 repeat ({period_layers} "
               f"of {len(cfg.layer_specs())} layers), widths as published")
        cfg = with_period_layers(cfg, period_layers)
    pipe = SyntheticTokenPipeline(cfg.vocab_size, batch, seq, seed=seed,
                                  frontend=frontend_of(cfg))
    data = batch_to_torch(next(pipe), dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = trainable(Model(cfg, generator=gen, device=dev).params, dev,
                       copy=False)
    n_params = sum(p.numel() for p in plan_leaves(params))
    state = opt.init_state(params)
    ocfg = opt.AdamWConfig(lr=lr, warmup_steps=warmup, total_steps=steps)
    held = {}

    def on_grads(params, grads):
        # the backward's end (the optimizer's start), and the gradients
        # for the check made after the timed step
        _sync(dev)
        held.update(t1=time.perf_counter(), grads=grads)

    step_fn = make_train_step(cfg, ocfg, remat=True, on_grads=on_grads)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, norms, step_ms, opt_ms, bad = [], [], [], [], set()
    prof = None
    for i in range(steps):
        if profile and i == steps - 1:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
        _sync(dev)
        t0 = time.perf_counter()
        with prof if prof is not None else contextlib.nullcontext():
            params, state, aux = step_fn(params, state, data)
            _sync(dev)
        t2 = time.perf_counter()
        bad.update(bad_grad_leaves(params, held.pop("grads")))
        step_ms.append((t2 - t0) * 1e3)
        opt_ms.append((t2 - held.pop("t1")) * 1e3)
        losses.append(float(aux["loss"]))
        norms.append(float(aux["grad_norm"]))
        log(f"  step {i}  loss={losses[-1]:.4f}  gnorm={norms[-1]:.4f}  "
            f"{step_ms[-1]:.1f} ms")
    timed = step_ms[1:steps - 1 if prof is not None else steps] or step_ms
    tokens = batch * seq
    out = {"arch": cfg.name, "cut": cut, "layers": len(cfg.layer_specs()),
           "params": n_params, "dtype": cfg.dtype, "batch": batch,
           "seq": seq, "steps": steps, "losses": losses,
           "grad_norms": norms, "step_ms": step_ms, "optimizer_ms": opt_ms,
           "tokens_per_s": tokens / (sum(timed) / len(timed) / 1e3),
           "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
           "bad_grad_leaves": sorted(bad), "leaves": len(plan_leaves(params))}
    if prof is not None:
        out["profile"] = step_profile(prof, sum(timed) / len(timed))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--full", action="store_true",
                    help="the plan-level dry run of the full config's "
                         "train_4k step on the production mesh")
    ap.add_argument("--full-width", action="store_true",
                    help="train the published config on one memorised "
                         "batch (bf16, remat)")
    ap.add_argument("--period-layers", type=int, default=None,
                    help="with --full-width: cut the depth to the first N "
                         "layers of the config's period, 1 repeat")
    ap.add_argument("--expect-loss-drop", action="store_true",
                    help="exit non-zero unless the last loss is below the "
                         "first (examples/train_small.py's check)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.full:
        from repro_torch.launch.dryrun import dryrun
        return dryrun(args.arch, "train_4k")
    defaults = FULL_WIDTH if args.full_width else REDUCED
    steps = args.steps or defaults["steps"]
    batch = args.batch or defaults["batch"]
    seq = args.seq or defaults["seq"]
    lr = args.lr or defaults["lr"]
    if args.full_width:
        print(f"training {args.arch} full width for {steps} steps "
              f"(batch={batch}, seq={seq}, bf16, remat) on {args.device}")
        res = train_full_width(args.arch, steps=steps, batch=batch, seq=seq,
                               lr=lr, warmup=FULL_WIDTH["warmup"],
                               seed=args.seed, device=args.device,
                               period_layers=args.period_layers)
        peak = res["peak_mem_bytes"]
        if res["cut"]:
            print(res["cut"])
        print(f"{res['layers']} layers, {res['params'] / 1e9:.3f} B "
              f"params; step ms {[round(t, 1) for t in res['step_ms']]}; "
              f"{res['tokens_per_s']:.0f} tokens/s; peak "
              f"{peak / 2**30 if peak else float('nan'):.2f} GiB; losses "
              f"{[round(x, 4) for x in res['losses']]}; leaves without a "
              f"finite nonzero gradient: {res['bad_grad_leaves'] or 'none'}")
        return res

    cfg = reduced(get_config(args.arch))
    pipe = SyntheticTokenPipeline(cfg.vocab_size, batch, seq, seed=args.seed,
                                  frontend=frontend_of(cfg))
    print(f"training {cfg.name} for {steps} steps "
          f"(batch={batch}, seq={seq}) on {args.device}")
    every = max(steps // 10, 1)
    res = train(cfg, iter(pipe), steps,
                opt.AdamWConfig(lr=lr, warmup_steps=every,
                                total_steps=steps),
                seed=args.seed, device=args.device, log_every=every,
                log_fn=lambda i, loss, gn:
                print(f"  step {i:4d}  loss={loss:.4f}  gnorm={gn:.2f}"))
    print(f"final loss: {res.losses[-1]:.4f} "
          f"(start {res.losses[0]:.4f})")
    if args.expect_loss_drop and not res.losses[-1] < res.losses[0]:
        raise SystemExit("training failed to reduce loss")
    if args.checkpoint:
        from repro_torch.training import checkpoint
        n = checkpoint.save(args.checkpoint, res.final_params,
                            {"arch": args.arch, "steps": steps})
        print(f"checkpoint written: {args.checkpoint} ({n} bytes)")
    return res


if __name__ == "__main__":
    main()
