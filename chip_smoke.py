#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from a checkout of the repository (it imports ``src/repro_torch``
beside this file, and nothing of the JAX package).  Phases, each printed
on its own line:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build every kernel of the paths from the checkout's sources (one
   ``nvcc`` per source, all started together), and count each library's
   tensor-core instructions (``HMMA`` from mma.sync, ``HGMMA`` from
   wgmma, in ``cuobjdump --dump-sass``): a tensor-core kernel's library
   with none fails;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the paths give it (paged attention: the runtime's lane-major
   call first, then the same rows row-major, as the JAX runtime calls,
   with ragged rows, pad rows, poisoned pages past the lengths, int8
   pages, GQA and a chunk past one 64-row query tile; flash attention:
   StableLM's prefill and the ragged, end-aligned, non-causal,
   windowed/softcapped GQA and head_dim-72 cases, then the head_dim-128
   geometries of phase 4's serves: OLMo 2's MHA, StarCoder2's group of
   9, Gemma 2's global and windowed layers with softcap 50 and Granite's
   group of 4; paged attention at OLMo 2's H = KV = 32 too; the WKV scan: RWKV-6
   prefill and decode, a ragged S, bf16 inputs and the other head widths
   at ragged B, H and S; the selective scan: Jamba's Mamba prefill with
   bf16 and f32 x, a ragged S, decode, two chained halves, D off the
   channel tile, N = 1, 13 and 64, and delta * A past the exponential's
   flush to 0), with its
   device time (replays of a CUDA graph of 20 calls; the eager time of
   back-to-back calls beside it), the plain version's, a one-call library
   yardstick's where PyTorch has one (also from a graph) and the least
   time the card could take;
4. full-width models (bf16, random weights from a seeded
   ``torch.Generator``) served through ``repro_torch.launch.serve``:
   StableLM-3B on the paged engine (bf16, then int8 page pools), then
   StableLM-3B, RWKV-6 1.6B and Jamba v0.1 (its published widths, depth
   cut to two repeats of its 8-layer period, 16 layers) on the dense
   slot-cache engine, then StableLM-3B on the bf16 and on the int8 dense
   slot cache (``REPRO_KV_INT8=1``) with the same requests, OLMo 2 7B
   dense and paged, Granite 3 8B,
   StarCoder2 7B and Gemma 2 27B dense (head_dim 128); every request must
   complete with finite logits, and every pass must go through each of the
   path's kernels once per layer of the kernel's mixer (the counts are
   zeroed before each run);
5. engine parity on the card: full width, depth cut to 2 layers, float32
   (TF32 off), identical tokens for the paged and dense StableLM engines
   with kernels against plain versions, dense against paged, and the
   RWKV-6 and Jamba (one Mamba + MoE layer and the attention layer) dense
   engines with the kernels against the plain versions;
6. the multi-tenant harness (gateway, actuator, controller, admission)
   serving full-width StableLM-3B in bf16 through
   ``repro_torch.launch.serve``: (a) the paper's experiment, 2 latency
   tenants x 2 dense replicas beside the ETL and trainer background
   tenants, interference and the gateway's backpressure on, with the
   controller and then without it (same seed); (b) cache-aware routing,
   1 tenant x 2 paged replicas with the response cache; (c) (a)'s fleet
   with 16 requests a tenant, run twice with the deterministic step-cost
   model, which must give identical
   outputs, controller actions and gateway counters.  The controller must
   act in (a) and not without it, and flash and paged attention must
   launch during the phase;
7. the failure domains: (a) full-width StableLM-3B in bf16, 1 tenant x 4
   paged replicas under the seeded chaos schedule with live migration, a
   planned drain and the flight recorder (its Chrome trace written under
   ``chiprun_out/``): every request completes, none is shed, the drain,
   the crash and the gray replica are each evacuated by migration, at
   least one lane moves warm and every shipped page verifies, no replica
   holds a KV page at the end, and paged attention launches; (b) a migration's token
   identity on the kernels: StableLM-3B full width x 2 layers in float32,
   a few paged steps on one engine, its lanes shipped with their pages to
   a second engine on the same weights and finished there, must give the
   tokens of an uninterrupted run.

The line before the last is the kernels' JSON summary, the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero before printing a result.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import functools
import gc
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and the op rate
# for the inputs' type (bf16 on the tensor cores; f32 outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def least_time(torch, nbytes, ops, dtype):
    """(ms, what binds, bytes, ops): the larger of the bytes over the HBM
    rate and the operations over the peak rate for ``dtype``."""
    name = "float32" if dtype == torch.float32 else "bfloat16"
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


# ------------------------------------------------------------------ phase 1
def device_info(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    info = {"nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0]}
    log(f"[1/7] device: {info['kind']} x{info['count']}, torch "
        f"{info['torch']}, CUDA {info['cuda']}, python {info['python']}")
    log(smi)
    return info


# ------------------------------------------------------------------ phase 2
def kernel_modules() -> dict:
    """The wrapper module of every kernel of the paths, by kernel name."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.selective_scan import kernel as scan_kernel
    return {"paged_attention_mixed": pa_kernel,
            "flash_attention": fa_kernel, "rwkv6_scan": wkv_kernel,
            "selective_scan": scan_kernel}


def zero_counts() -> None:
    for mod in kernel_modules().values():
        mod.launches = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in kernel_modules().items()}


# kernels redesigned for the tensor cores: their libraries must hold
# tensor-core instructions
TENSOR_CORE_KERNELS = ("paged_attention_mixed", "flash_attention")


def tensor_core_count(so: Path) -> dict:
    """Tensor-core instructions in a built library's SASS: ``HMMA``
    (mma.sync) and ``HGMMA`` (wgmma) lines of ``cuobjdump --dump-sass``."""
    from repro_torch.kernels.build import nvcc_path
    cuobjdump = Path(nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(so)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout.splitlines()
    return {op: sum(f"{op}." in ln or f"{op} " in ln for ln in sass)
            for op in ("HMMA", "HGMMA")}


def build_kernels() -> dict:
    builders = {name: mod.build for name, mod in kernel_modules().items()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:
        futures = {name: pool.submit(fn) for name, fn in builders.items()}
        built = {name: f.result() for name, f in futures.items()}
    out = {}
    for name, b in built.items():
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        mma = tensor_core_count(b.path)
        out[name] = {"so": b.path.name, "build_s": b.build_s,
                     "ptxas": ptxas, "tensor_core_sass": mma}
        log(f"[2/7] built {name}: {b.path.name} in {b.build_s:.1f}s; "
            f"tensor-core instructions in its SASS: HMMA {mma['HMMA']}, "
            f"HGMMA {mma['HGMMA']}")
        for ln in ptxas:
            log(f"      ptxas: {ln}")
        if name in TENSOR_CORE_KERNELS and not sum(mma.values()):
            raise AssertionError(f"{name}: no tensor-core instruction in "
                                 f"{b.path.name}")
    log(f"[2/7] all kernels built in {time.perf_counter() - t0:.1f}s")
    return out


# ------------------------------------------------------------------ phase 3
def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3,
            graph: bool = False) -> float:
    """Mean device time of ``fn()`` by CUDA events (inputs stay L2-warm):
    over ``iters`` back-to-back eager calls, or, with ``graph``, over
    replays of a CUDA graph that holds ``iters`` calls.  The graph leaves
    the host out: an eager call shorter than its wrapper's host time
    measures the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    reps = 1
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        run, reps = g.replay, 5
    else:
        def run():
            for _ in range(iters):
                fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def kernel_ms(torch, fn) -> tuple:
    """(device time from a CUDA graph, eager time) of one kernel call."""
    return cuda_ms(torch, fn, graph=True), cuda_ms(torch, fn)


def main_path_step(torch, *, heads, kv, hd, layout="lane", chunk=64,
                   page=16, lanes=8, pps=128, pool_pages=1024, seed=0,
                   device="cuda"):
    """One fused step's attention call: 7 decode rows and one prefill
    chunk of ``chunk`` rows from 8 lanes of ``chunk``..1056 tokens.
    ``layout="lane"`` is the serving path's call (``serving/
    paged_runtime.py::lane_major_layout``): one lane per sequence, Q = the
    chunk, pad slots at position 0 on their lane's table.  ``"row"`` is the
    JAX runtime's call: each packed row its own Q=1 lane carrying its
    lane's table, padded to the row bucket (80 for a 64-row chunk) with
    pad rows at position 0 on a zero table.  Pool pages
    past each lane's length (and slots past it in its last page) are
    poisoned, so the causal page walk must mask them."""
    import numpy as np
    from repro_torch.serving.paged_runtime import lane_major_layout
    from repro_torch.serving.sched import bucket_rows
    rng = np.random.default_rng(seed)
    lens = rng.integers(chunk, 1056 + 1, lanes)
    perm = rng.permutation(pool_pages)
    i0 = int(np.argmin(perm))                       # lane 0 owns page 0,
    perm[0], perm[i0] = perm[i0], perm[0]           # which pad rows read
    tables = perm[:lanes * pps].reshape(lanes, pps).astype(np.int32)
    k = rng.standard_normal((pool_pages + 1, page, kv, hd)).astype(np.float32)
    v = rng.standard_normal((pool_pages + 1, page, kv, hd)).astype(np.float32)
    for lane, n in enumerate(lens):
        last, off = divmod(int(n), page)
        k[tables[lane, last], off:] = 1e4
        v[tables[lane, last], off:] = -1e4
        k[tables[lane, last + 1:]] = 1e4
        v[tables[lane, last + 1:]] = -1e4
    # packed rows: one per decode lane, then the chunk
    positions = [int(n) - 1 for n in lens[:-1]]
    start = int(lens[-1]) - chunk
    positions += list(range(start, start + chunk))
    row_of = [(i, 1) for i in range(lanes - 1)] + [(lanes - 1, chunk)]
    n = len(positions)
    b = bucket_rows(n)
    positions = np.array(positions + [0] * (b - n), np.int32)
    q = rng.standard_normal((b, heads, hd)).astype(np.float32)
    if layout == "lane":
        gather, _, qpos = lane_major_layout(row_of, positions, chunk)
        q = q[gather].reshape(lanes, chunk, heads, hd)
        bt = tables
    else:
        bt = np.zeros((b, pps), np.int32)
        for lane, (r0, rows) in enumerate(row_of):
            bt[r0:r0 + rows] = tables[lane]
        qpos = positions[:, None].copy()
        q = q[:, None]
    return {name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for name, a in (("q", q), ("k", k), ("v", v), ("bt", bt),
                            ("qpos", qpos))}


def attention_bound(torch, q, k_pages, bt, qpos, k_scales=None):
    """Least time for one call: each input byte read once (only the pages
    the rows' positions reach), the output written once, against the ops
    these positions need, over the card's peaks."""
    b, qn, h, hd = q.shape
    page, kv = k_pages.shape[1], k_pages.shape[2]
    pos = qpos.long()
    n_pages = pos // page + 1                                # [B, Q]
    touched = set()
    bt_c, np_c = bt.cpu(), n_pages.max(dim=1).values.cpu()
    for lane in range(b):
        touched.update(bt_c[lane, :int(np_c[lane])].tolist())
    page_bytes = page * kv * hd * k_pages.element_size()
    nbytes = (2 * q.numel() * q.element_size()            # q in, out
              + 2 * len(touched) * page_bytes               # K and V pages
              + bt.numel() * 4 + qpos.numel() * 4)
    if k_scales is not None:
        nbytes += 2 * len(touched) * page * kv * 4
    ops = 4 * hd * h * int((pos + 1).sum())                 # QK^T and PV
    return least_time(torch, nbytes, ops, q.dtype)


def sdpa_yardstick(torch, q, k_pages, v_pages, bt, qpos, k_scales=None,
                   v_scales=None):
    """One PyTorch call computing the same function on the already
    gathered (and dequantized) K/V: ``scaled_dot_product_attention`` with
    the positional mask.  Timed here only; the port never calls it."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.ref import _gather_pages
    b, qn, h, hd = q.shape
    g = h // k_pages.shape[2]
    kg = _gather_pages(k_pages, bt, k_scales).to(q.dtype)   # [B, T, KV, hd]
    vg = _gather_pages(v_pages, bt, v_scales).to(q.dtype)
    t = kg.shape[1]
    qs = q.transpose(1, 2)                                  # [B, H, Q, hd]
    ks = kg.repeat_interleave(g, dim=2).transpose(1, 2)     # [B, H, T, hd]
    vs = vg.repeat_interleave(g, dim=2).transpose(1, 2)
    mask = (torch.arange(t, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None]                   # [B, 1, Q, T]

    def call():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    return call


def check_kernels(torch) -> dict:
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_mixed_ref)
    from repro_torch.models.attention import _quantize_kv

    # name, H, KV, hd, dtype, int8 pages, tolerance, layout, chunk; the
    # first is the serving path's call, the second the same rows row-major
    # (the row-major cases keep the shapes of the earlier design's record)
    cases = [("stablelm bf16 lane-major", 32, 32, 80, torch.bfloat16, False,
              2e-2, "lane", 64),
             ("stablelm bf16 row-major", 32, 32, 80, torch.bfloat16, False,
              2e-2, "row", 64),
             ("stablelm int8 pages row-major", 32, 32, 80, torch.bfloat16,
              True, 2e-2, "row", 64),
             ("stablelm f32 row-major", 32, 32, 80, torch.float32, False,
              2e-3, "row", 64),
             ("gqa bf16 (H=32, KV=8) row-major", 32, 8, 128, torch.bfloat16,
              False, 2e-2, "row", 64),
             ("stablelm int8 pages lane-major", 32, 32, 80, torch.bfloat16,
              True, 2e-2, "lane", 64),
             ("stablelm f32 lane-major", 32, 32, 80, torch.float32, False,
              2e-3, "lane", 64),
             ("gqa bf16 int8 pages (H=32, KV=8) lane-major", 32, 8, 128,
              torch.bfloat16, True, 2e-2, "lane", 64),
             ("stablelm bf16 lane-major, a 128-row chunk", 32, 32, 80,
              torch.bfloat16, False, 2e-2, "lane", 128),
             ("olmo2 bf16 (H=KV=32, hd=128) lane-major", 32, 32, 128,
              torch.bfloat16, False, 2e-2, "lane", 64)]
    results = []
    for name, heads, kv, hd, dt, int8, tol, layout, chunk in cases:
        x = main_path_step(torch, heads=heads, kv=kv, hd=hd, layout=layout,
                           chunk=chunk)
        q = x["q"].to(dt)
        kw = {}
        if int8:
            kq, ks = _quantize_kv(x["k"])
            vq, vs = _quantize_kv(x["v"])
            kp, vp = kq, vq
            kw = dict(k_scales=ks.float().contiguous(),
                      v_scales=vs.float().contiguous())
        else:
            kp, vp = x["k"].to(dt), x["v"].to(dt)
        args = (q, kp, vp, x["bt"], x["qpos"])
        out = pa_kernel.paged_attention_mixed(*args, **kw)
        torch.cuda.synchronize()
        ref = paged_attention_mixed_ref(*args, **kw)
        err = float((out.float() - ref.float()).abs().max())
        ok = bool(torch.allclose(out.float(), ref.float(), rtol=tol,
                                 atol=tol))
        extra = ""
        if int8:
            # int8 pages against the same pages in full precision
            fp = paged_attention_mixed_ref(q, x["k"].to(dt), x["v"].to(dt),
                                           x["bt"], x["qpos"])
            live = x["qpos"] > 0
            fp_err = float((out.float() - fp.float())[live].abs().max())
            ok = ok and bool(torch.allclose(out.float()[live],
                                            fp.float()[live], rtol=0.05,
                                            atol=0.05))
            extra = f", vs fp pages {fp_err:.3g} (tol 0.05)"
        ms, eager_ms = kernel_ms(
            torch, lambda: pa_kernel.paged_attention_mixed(*args, **kw))
        plain_ms = cuda_ms(torch, lambda: paged_attention_mixed_ref(
            *args, **kw), iters=5)
        lib_ms = cuda_ms(torch, sdpa_yardstick(torch, *args, **kw),
                         graph=True)
        bound_ms, bound_by, nbytes, ops = attention_bound(
            torch, q, kp, x["bt"], x["qpos"], kw.get("k_scales"))
        res = {"case": name, "layout": layout,
               "shape": {"B": q.shape[0], "Q": q.shape[1],
                                       "H": heads, "KV": kv, "hd": hd,
                                       "page": kp.shape[1],
                                       "width": x["bt"].shape[1],
                                       "pool_pages": kp.shape[0]},
               "dtype": str(dt).replace("torch.", ""), "int8_pages": int8,
               "max_abs_err": err, "tol": tol, "ok": ok, "ms": ms,
               "eager_ms": eager_ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": nbytes, "ops": ops}
        results.append(res)
        log(f"[3/7] paged_attention_mixed {name}: B={q.shape[0]} "
            f"Q={q.shape[1]} "
            f"H={heads} KV={kv} hd={hd}: max_abs_err {err:.3g} (tol {tol})"
            f"{extra}; kernel {ms:.4f} ms (eager {eager_ms:.4f}), plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
            f"{ops / 1e9:.3f} Gop)")
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"on {name}: max_abs_err {err}")
        del x, q, kp, vp, args, out, ref
        torch.cuda.empty_cache()
    return {"paged_attention_mixed": results}


def flash_inputs(torch, b, s, t, h, kv, hd, dtype, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to("cuda", dtype)
            for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd))]


def flash_mask(torch, s, t, causal, window):
    """[S, T] bool: the (query, key) pairs the end-aligned mask keeps."""
    pos_q = torch.arange(s, device="cuda")[:, None] + (t - s)
    pos_k = torch.arange(t, device="cuda")[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device="cuda")
    if causal:
        mask &= pos_k <= pos_q
    if window:
        mask &= pos_k > pos_q - window
    return mask


def flash_bound(torch, q, k, mask):
    """Least time for one call: q, k, v read once and the output written
    once, against QK^T and PV over the (query, key) pairs the mask keeps
    (4 * hd operations per pair and query head)."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    es = q.element_size()
    nbytes = 2 * b * s * h * hd * es + 2 * b * t * kv * hd * es
    ops = 4 * hd * h * b * int(mask.sum())
    return least_time(torch, nbytes, ops, q.dtype)


def check_flash(torch) -> list:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    # name, B, S, T, H, KV, hd, causal, window, softcap, dtype, tol
    cases = [
        ("stablelm prefill bf16", 1, 1024, 1024, 32, 32, 80, True, 0, None,
         torch.bfloat16, 2e-2),
        ("stablelm prefill f32", 1, 1024, 1024, 32, 32, 80, True, 0, None,
         torch.float32, 2e-3),
        ("ragged S=T=1000 bf16", 1, 1000, 1000, 32, 32, 80, True, 0, None,
         torch.bfloat16, 2e-2),
        ("end-aligned S=64 T=192 bf16", 1, 64, 192, 32, 32, 80, True, 0,
         None, torch.bfloat16, 2e-2),
        ("non-causal S=T=512 bf16", 1, 512, 512, 32, 32, 80, False, 0, None,
         torch.bfloat16, 2e-2),
        ("gqa H=32 KV=8 hd=128 window 256 softcap 50 bf16", 1, 1024, 1024,
         32, 8, 128, True, 256, 50.0, torch.bfloat16, 2e-2),
        ("hd=72 (padded to 80) S=T=1024 bf16", 1, 1024, 1024, 32, 32, 72,
         True, 0, None, torch.bfloat16, 2e-2),
        # the head_dim-128 geometries that phase 4's serves launch
        ("olmo2 H=KV=32 hd=128 bf16", 1, 1024, 1024, 32, 32, 128, True, 0,
         None, torch.bfloat16, 2e-2),
        ("starcoder2 H=36 KV=4 (group 9) hd=128 bf16", 1, 1024, 1024, 36, 4,
         128, True, 0, None, torch.bfloat16, 2e-2),
        ("gemma2 global H=32 KV=16 hd=128 softcap 50 bf16", 1, 1024, 1024,
         32, 16, 128, True, 0, 50.0, torch.bfloat16, 2e-2),
        ("gemma2 local H=32 KV=16 hd=128 window 4096 softcap 50 bf16", 1,
         1024, 1024, 32, 16, 128, True, 4096, 50.0, torch.bfloat16, 2e-2),
        ("granite H=32 KV=8 hd=128 bf16", 1, 1024, 1024, 32, 8, 128, True, 0,
         None, torch.bfloat16, 2e-2),
    ]
    results = []
    for (name, b, s, t, h, kv, hd, causal, window, cap, dt,
         tol) in cases:
        q, k, v = flash_inputs(torch, b, s, t, h, kv, hd, dt, seed=s + t)
        kw = dict(causal=causal, window=window, softcap=cap)
        out = fa_kernel.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, **kw)
        err = float((out.float() - ref.float()).abs().max())
        ok = bool(torch.allclose(out.float(), ref.float(), rtol=tol,
                                 atol=tol))
        ms, eager_ms = kernel_ms(
            torch, lambda: fa_kernel.flash_attention(q, k, v, **kw))
        plain_ms = cuda_ms(torch, lambda: flash_attention_ref(q, k, v, **kw),
                           iters=5)
        mask = flash_mask(torch, s, t, causal, window)
        lib_ms = None
        if cap is None:
            # one SDPA call on [B, H, S, hd] views (prepared untimed); the
            # port never calls it
            qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
            plain_causal = causal and s == t and not window
            sdpa_kw = (dict(is_causal=True) if plain_causal else
                       dict(attn_mask=mask) if causal or window else {})
            lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, ks, vs, enable_gqa=kv != h, **sdpa_kw), graph=True)
        bound_ms, bound_by, nbytes, ops = flash_bound(torch, q, k, mask)
        res = {"case": name, "shape": {"B": b, "S": s, "T": t, "H": h,
                                       "KV": kv, "hd": hd},
               "causal": causal, "window": window, "softcap": cap,
               "dtype": str(dt).replace("torch.", ""), "max_abs_err": err,
               "tol": tol, "ok": ok, "ms": ms, "eager_ms": eager_ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "ops": ops}
        results.append(res)
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none (softcap)"
        log(f"[3/7] flash_attention {name}: B={b} S={s} T={t} H={h} KV={kv} "
            f"hd={hd}: max_abs_err {err:.3g} (tol {tol}); kernel {ms:.4f} "
            f"ms (eager {eager_ms:.4f}), plain {plain_ms:.4f} ms, sdpa {lib}, "
            f"bound "
            f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
            f"{ops / 1e9:.3f} Gop)")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain "
                                 f"version on {name}: max_abs_err {err}")
        del q, k, v, out, ref, mask
        torch.cuda.empty_cache()
    return results


def wkv_inputs(torch, b, s, h, hd, dtype, seed):
    """r/k/v/w as the kernel tests draw them (w in (0.45, 0.95)), u and a
    random initial state s0."""
    import numpy as np
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, hd)) * 0.5 for _ in range(3))
    w = 0.45 + 0.5 / (1 + np.exp(-rng.standard_normal((b, s, h, hd))))
    u = rng.standard_normal((h, hd)) * 0.5
    s0 = rng.standard_normal((b, h, hd, hd)) * 0.1

    def dev(a, dt):
        return torch.from_numpy(a.astype(np.float32)).to("cuda", dt)
    return ([dev(a, dtype) for a in (r, k, v, w)]
            + [dev(u, torch.float32), dev(s0, torch.float32)])


def wkv_bound(torch, r):
    """Least time for one call: r, k, v, w, u and s0 read once, y and the
    final state written once, against the operations the function needs
    per head and step.  Since y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i,
    the bonus term is O(hd): 5 hd operations (r u k and its sum, then
    v_j times it, added to y_j).  The O(hd^2) work is 5 operations per
    state element: r_i S_ij and its sum (2), w_i S_ij + k_i v_j (3).  Over
    the f32 rate for f32 inputs (the bf16 tensor-core rate for bf16)."""
    b, s, h, hd = r.shape
    es = r.element_size()
    n = b * s * h * hd
    nbytes = 5 * n * es + h * hd * 4 + 2 * b * h * hd * hd * 4
    ops = 5 * hd * (hd + 1) * h * b * s
    return least_time(torch, nbytes, ops, r.dtype)


def check_wkv(torch) -> list:
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

    # name, B, S, H, hd, dtype, y tolerance (the state is held to 1e-4)
    cases = [("rwkv6 prefill f32", 1, 1024, 32, 64, torch.float32, 1e-4),
             ("rwkv6 decode B=8 S=1 f32", 8, 1, 32, 64, torch.float32, 1e-4),
             ("ragged S=1000 f32", 1, 1000, 32, 64, torch.float32, 1e-4),
             # y comes out in bf16: one bf16 ulp is 2^-8 of |y|
             ("bf16 inputs S=1024", 1, 1024, 32, 64, torch.bfloat16, 1e-2),
             # the column-tile geometry's edges: the other head widths (1
             # key row a lane at hd 16, 8 at hd 128, whose decode takes the
             # column-tile kernel too), S off the 64-step chunk and the
             # 16-step pair of groups, B = 3 x H = 5 blocks
             ("hd 16, B=3 H=5 S=33 f32", 3, 33, 5, 16, torch.float32, 1e-4),
             ("hd 32, B=3 H=5 S=1000 f32", 3, 1000, 5, 32, torch.float32,
              1e-4),
             ("hd 128, B=3 H=5 S=33 f32", 3, 33, 5, 128, torch.float32,
              1e-4),
             ("hd 128 decode B=8 S=1 f32", 8, 1, 5, 128, torch.float32,
              1e-4),
             ("hd 128, B=3 H=5 S=70 bf16", 3, 70, 5, 128, torch.bfloat16,
              1e-2)]
    results = []
    for name, b, s, h, hd, dt, tol in cases:
        args = wkv_inputs(torch, b, s, h, hd, dt, seed=s + b)
        y, sf = wkv_kernel.rwkv6_scan(*args)
        torch.cuda.synchronize()
        yr, sr = rwkv6_scan_ref(*args)
        err = float((y.float() - yr.float()).abs().max())
        s_err = float((sf - sr).abs().max())
        ok = (bool(torch.allclose(y.float(), yr.float(), rtol=tol, atol=tol))
              and bool(torch.allclose(sf, sr, rtol=1e-4, atol=1e-4)))
        ms, eager_ms = kernel_ms(torch, lambda: wkv_kernel.rwkv6_scan(*args))
        plain_ms = cuda_ms(torch, lambda: rwkv6_scan_ref(*args), iters=3,
                           warmup=1)
        bound_ms, bound_by, nbytes, ops = wkv_bound(torch, args[0])
        res = {"case": name, "shape": {"B": b, "S": s, "H": h, "hd": hd},
               "dtype": str(dt).replace("torch.", ""),
               "max_abs_err": max(err, s_err), "y_err": err,
               "state_err": s_err, "tol": tol, "ok": ok, "ms": ms,
               "eager_ms": eager_ms, "plain_ms": plain_ms, "library_ms": None,
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "ops": ops}
        results.append(res)
        log(f"[3/7] rwkv6_scan {name}: B={b} S={s} H={h} hd={hd}: "
            f"max_abs_err y {err:.3g} (rtol = atol = {tol}), state "
            f"{s_err:.3g} (rtol = atol = 1e-4); kernel {ms:.4f} ms (eager "
            f"{eager_ms:.4f}), plain {plain_ms:.4f} ms, library "
            f"none, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} Gop)")
        if not ok:
            raise AssertionError(f"WKV kernel disagrees with its plain "
                                 f"version on {name}: y {err}, state {s_err}")
        del args, y, sf, yr, sr
        torch.cuda.empty_cache()
    return results


def scan_inputs(torch, b, s, d, n, x_dtype, seed, with_h0=True,
                wide_a=False):
    """x/delta/a/b/c/d (and h0) as the kernel tests draw them: delta in
    (0, ~0.3), A negative, B/C/x of spread 0.5; everything but x f32, as
    ``models/ssm.py::_ssm_coeffs`` hands them over.  wide_a: A log-uniform
    in (-1000, -0.01) and delta uniform in (0, 1) instead, so delta * A
    spans the whole range the exponential sees."""
    import numpy as np
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, s, d)) * 0.5,
              np.abs(rng.standard_normal((b, s, d))) * 0.1,
              -np.abs(rng.standard_normal((d, n))) - 0.1,
              rng.standard_normal((b, s, n)) * 0.5,
              rng.standard_normal((b, s, n)) * 0.5,
              rng.standard_normal((d,))]
    if wide_a:
        arrays[1] = rng.uniform(0, 1, (b, s, d))
        arrays[2] = -np.exp(rng.uniform(np.log(0.01), np.log(1000.0),
                                        (d, n)))
    if with_h0:
        arrays.append(rng.standard_normal((b, d, n)) * 0.1)
    out = [torch.from_numpy(a.astype(np.float32)).to("cuda")
           for a in arrays]
    out[0] = out[0].to(x_dtype)
    return out


# special-function-unit exponentials per clock per SM on sm_90 (CUDA C++
# programming guide's throughput table) and the H100 SXM's boost clock
SFU_PER_CLK_SM, SM_COUNT, BOOST_HZ = 16, 132, 1.98e9


def scan_bound(torch, x, n, with_h0):
    """Least time for one call: x, delta, A, B, C, D (and h0, when one is
    given) read once, y and the final state written once, against the f32
    operations the function needs: per (step, channel, state) delta*A,
    its exponential, dx*B_n, the state's multiply-add (2) and C_n*h's
    multiply-add (2); per (step, channel) delta*x and D*x + the sum (3).
    The inputs but x are f32 and so is the arithmetic, so the f32 rate
    applies whatever x's type.  Also returns the exponentials' time on the
    special-function units alone, a floor the data sheet's rates miss."""
    b, s, d = x.shape
    es = x.element_size()
    nbytes = (2 * b * s * d * es + b * s * d * 4 + d * n * 4
              + 2 * b * s * n * 4 + d * 4 + b * d * n * 4 * (2 if with_h0
                                                           else 1))
    ops = b * s * d * (7 * n + 3)
    exp_ms = b * s * d * n / (SFU_PER_CLK_SM * SM_COUNT * BOOST_HZ) * 1e3
    return least_time(torch, nbytes, ops, torch.float32) + (exp_ms,)


def check_scan(torch) -> list:
    from repro_torch.kernels.selective_scan import kernel as scan_kernel
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    def chained(fn, x, dt, a, bm, cm, dd, h0):
        """The scan over S as two halves chained through the state."""
        h = x.shape[1] // 2
        y1, h1 = fn(x[:, :h].contiguous(), dt[:, :h].contiguous(), a,
                    bm[:, :h].contiguous(), cm[:, :h].contiguous(), dd, h0)
        y2, h2 = fn(x[:, h:].contiguous(), dt[:, h:].contiguous(), a,
                    bm[:, h:].contiguous(), cm[:, h:].contiguous(), dd, h1)
        return torch.cat([y1, y2], 1), h2

    # name, B, S, D, N, x dtype, h0, y tolerance (the state is held to
    # 1e-4); bf16 y leaves the kernel rounded, one bf16 ulp is 2^-8 of |y|
    cases = [("jamba prefill x bf16", 1, 1024, 8192, 16, torch.bfloat16,
              False, 1e-2),
             ("jamba prefill x f32", 1, 1024, 8192, 16, torch.float32,
              False, 1e-4),
             ("ragged S=1000 x f32", 1, 1000, 8192, 16, torch.float32, True,
              1e-4),
             ("decode B=8 S=1 x bf16", 8, 1, 8192, 16, torch.bfloat16, True,
              1e-2),
             ("two chained halves of S=1024 x f32", 1, 1024, 8192, 16,
              torch.float32, True, 1e-4),
             # the channel tile's edges (64 channels a block for N <= 16,
             # 16 for N = 64): D off the tile, the state counts' padding
             # (N = 1 and 13 in the 16-state build), one step
             ("D=8200 S=70 x bf16", 1, 70, 8200, 16, torch.bfloat16, True,
              1e-2),
             ("N=1 D=8200 S=45 x f32", 2, 45, 8200, 1, torch.float32, True,
              1e-4),
             # D % 8 != 0: x and delta staged element by element
             ("N=13 D=1001 S=50 x f32", 2, 50, 1001, 13, torch.float32, True,
              1e-4),
             ("N=64 D=8200 S=1 x bf16", 3, 1, 8200, 64, torch.bfloat16, True,
              1e-2),
             ("N=64 S=40 x f32", 1, 40, 1024, 64, torch.float32, True, 1e-4),
             # delta * A (log2 units) from 0 to past -126, where the SFU's
             # 2^x flushes to 0 and the plain exp passes through denormals
             ("exponent range past -126 x f32", 2, 96, 1024, 16,
              torch.float32, True, 1e-4)]
    results = []
    for name, b, s, d, n, dt, with_h0, tol in cases:
        args = scan_inputs(torch, b, s, d, n, dt, seed=s + b,
                           with_h0=with_h0,
                           wide_a=name.startswith("exponent range"))
        kernel_fn, plain_fn = scan_kernel.selective_scan, selective_scan_ref
        extra = ""
        if name.startswith("two chained"):
            whole_y, whole_h = kernel_fn(*args)
            kernel_fn = functools.partial(chained, kernel_fn)
            plain_fn = functools.partial(chained, plain_fn)
        y, hf = kernel_fn(*args)
        torch.cuda.synchronize()
        yr, hr = plain_fn(*args)
        err = float((y.float() - yr.float()).abs().max())
        h_err = float((hf - hr).abs().max())
        ok = (bool(torch.allclose(y.float(), yr.float(), rtol=tol, atol=tol))
              and bool(torch.allclose(hf, hr, rtol=1e-4, atol=1e-4)))
        if name.startswith("two chained"):
            # the chained halves against one call over the whole sequence
            c_err = max(float((y - whole_y).abs().max()),
                        float((hf - whole_h).abs().max()))
            ok = ok and bool(torch.allclose(y, whole_y, rtol=1e-4,
                                            atol=1e-4)) and bool(
                torch.allclose(hf, whole_h, rtol=1e-4, atol=1e-4))
            extra = f", chained vs one call {c_err:.3g} (tol 1e-4)"
            del whole_y, whole_h
        ms, eager_ms = kernel_ms(torch, lambda: kernel_fn(*args))
        plain_ms = cuda_ms(torch, lambda: plain_fn(*args), iters=3,
                           warmup=1)
        bound_ms, bound_by, nbytes, ops, exp_ms = scan_bound(
            torch, args[0], n, with_h0)
        res = {"case": name, "shape": {"B": b, "S": s, "D": d, "N": n},
               "x_dtype": str(dt).replace("torch.", ""), "h0": with_h0,
               "max_abs_err": max(err, h_err), "y_err": err,
               "state_err": h_err, "tol": tol, "ok": ok, "ms": ms,
               "eager_ms": eager_ms, "plain_ms": plain_ms, "library_ms": None,
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "ops": ops, "sfu_exp_ms": exp_ms}
        results.append(res)
        log(f"[3/7] selective_scan {name}: B={b} S={s} D={d} N={n}: "
            f"max_abs_err y {err:.3g} (rtol = atol = {tol}), state "
            f"{h_err:.3g} (rtol = atol = 1e-4){extra}; kernel {ms:.4f} ms "
            f"(eager {eager_ms:.4f}), plain {plain_ms:.4f} ms, library "
            f"none, bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} Gop; "
            f"the exponentials alone on the SFUs {exp_ms:.4f} ms)")
        if not ok:
            raise AssertionError(f"selective scan kernel disagrees with its "
                                 f"plain version on {name}: y {err}, state "
                                 f"{h_err}")
        del args, y, hf, yr, hr
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------------ phase 4
# tag, arch, backend, the path's kernels, serve options
SERVE_RUNS = (
    ("stablelm_3b paged bf16", "stablelm_3b", "paged",
     ("paged_attention_mixed",), dict(requests=8, max_new=32)),
    ("stablelm_3b paged int8", "stablelm_3b", "paged",
     ("paged_attention_mixed",), dict(requests=4, max_new=8,
                                      kv_dtype="int8")),
    ("stablelm_3b dense bf16", "stablelm_3b", "dense", ("flash_attention",),
     dict(requests=8, max_new=32)),
    ("rwkv6_1_6b dense bf16", "rwkv6_1_6b", "dense", ("rwkv6_scan",),
     dict(requests=8, max_new=32)),
    ("jamba_v0_1_52b dense bf16", "jamba_v0_1_52b", "dense",
     ("selective_scan", "flash_attention"),
     dict(requests=8, max_new=32, repeats=2)),
    # the int8 dense slot cache beside its bf16 twin (the same requests,
    # prompts and max_new, run back to back), then the GQA configs at
    # head_dim 128
    ("stablelm_3b dense bf16, int8's twin", "stablelm_3b", "dense",
     ("flash_attention",), dict(requests=4, max_new=16)),
    ("stablelm_3b dense int8", "stablelm_3b", "dense", ("flash_attention",),
     dict(requests=4, max_new=16, env={"REPRO_KV_INT8": "1"})),
    ("olmo2_7b dense bf16", "olmo2_7b", "dense", ("flash_attention",),
     dict(requests=4, max_new=16)),
    ("olmo2_7b paged bf16", "olmo2_7b", "paged", ("paged_attention_mixed",),
     dict(requests=4, max_new=16)),
    ("granite_3_8b dense bf16", "granite_3_8b", "dense",
     ("flash_attention",), dict(requests=4, max_new=16)),
    ("starcoder2_7b dense bf16", "starcoder2_7b", "dense",
     ("flash_attention",), dict(requests=4, max_new=16)),
    ("gemma2_27b dense bf16", "gemma2_27b", "dense", ("flash_attention",),
     dict(requests=4, max_new=16)),
)
# per kernel: the mixer whose layers launch it, and the passes that do
# (flash runs in prefill only; the others in every forward pass)
KERNEL_PATH = {"paged_attention_mixed": ("attn", "forward_passes"),
               "flash_attention": ("attn", "prefill_passes"),
               "rwkv6_scan": ("rwkv6", "forward_passes"),
               "selective_scan": ("mamba", "forward_passes")}


def serve_full_width(torch) -> dict:
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve, with_repeats

    runs = {}
    for tag, arch, backend, knames, kw in SERVE_RUNS:
        kw = dict(kw)
        env = kw.pop("env", {})
        cfg = get_config(arch)
        if "repeats" in kw:
            cfg = with_repeats(cfg, kw["repeats"])
        mixers = [layer.mixer for layer in cfg.layer_specs()]
        gc.collect()
        torch.cuda.empty_cache()
        zero_counts()
        t0 = time.perf_counter()
        with mock.patch.dict(os.environ, env):
            run = serve(arch=arch, backend=backend, reduce=False, qps=20.0,
                        prompt_len=64, prompt_len_max=1024, slots=8,
                        seq_cap=2048, seed=0, device="cuda",
                        with_controller=False, **kw)
        wall = time.perf_counter() - t0
        counts = read_counts()
        out = dict(run["T1"], peak_mem_bytes=run["device"]["peak_mem_bytes"])
        out.pop("outputs")
        out.pop("ttft_by_id")
        checks = {}
        for kname in knames:
            mixer, passes_key = KERNEL_PATH[kname]
            checks[kname] = (counts[kname], out[passes_key],
                             mixers.count(mixer), passes_key.split("_")[0])
        out.update(kernels=list(knames), launches=dict(
            (k, c[0]) for k, c in checks.items()), counts=counts,
            wall_s=wall, env=env)
        runs[tag] = out
        launched = ", ".join(
            f"{k} launches {n} ({p} {kind} passes x {lay} {KERNEL_PATH[k][0]}"
            f" layers)" for k, (n, p, lay, kind) in checks.items())
        log(f"[4/7] serve {tag} full width ({out['layers']} layers"
            f"{', ' + str(env) if env else ''}): "
            f"completed {out['completed']}/{out['offered']}, {out['steps']} "
            f"steps, TTFT p50 {out['ttft_p50_ms']:.2f} ms p99 "
            f"{out['ttft_p99_ms']:.2f} ms, ITL p50 {out['itl_p50_ms']:.2f} "
            f"ms p99 {out['itl_p99_ms']:.2f} ms, {out['tokens_per_s']:.1f} "
            f"tokens/s, peak memory {out['peak_mem_bytes'] / 2**30:.2f} "
            f"GiB, {launched}, wall {wall:.1f} s")
        if out["completed"] != out["offered"]:
            raise AssertionError(f"{tag}: not every request completed")
        if not out["logits_finite"]:
            raise AssertionError(f"{tag}: non-finite logits")
        for kname, (n, passes, layers, _) in checks.items():
            if n == 0 or n != passes * layers:
                raise AssertionError(f"{tag}: {n} {kname} launches for "
                                     f"{passes} passes x {layers} layers")
    return runs


# ------------------------------------------------------------------ phase 5
PARITY_TRACE = [(200, 8), (37, 12), (120, 6), (9, 10), (250, 5)]


def serve_trace(torch, cfg, params, backend, impl) -> tuple:
    """Drain PARITY_TRACE through a fresh engine; returns (tokens per
    request, step kinds, launch counts of the run)."""
    import numpy as np
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request

    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n, _ in PARITY_TRACE]
    eng = ServingEngine(cfg, params=params, max_slots=4, seq_cap=512,
                        page_size=16, chunk_tokens=64, attn_impl=impl,
                        backend=backend, device="cuda")
    reqs = [Request(req_id=i, tenant="T1", prompt_len=len(p),
                    max_new_tokens=mn, arrival=0.0, prompt_tokens=p.copy())
            for i, (p, (_, mn)) in enumerate(zip(prompts, PARITY_TRACE))]
    for r in reqs:
        if not eng.submit(r):
            raise AssertionError(f"{backend}/{impl}: request {r.req_id} "
                                 f"refused")
    zero_counts()
    kinds = []
    while eng.has_work():
        rep = eng.step()
        eng.finalize_step(rep, float(len(kinds)))
        kinds.append(rep.kind)
        if len(kinds) > 500:
            raise AssertionError(f"{backend}/{impl}: the engine did not "
                                 f"drain")
    if not eng.logits_finite:
        raise AssertionError(f"{backend}/{impl}: non-finite logits")
    return [r.output_tokens for r in reqs], kinds, read_counts()


def engine_parity(torch) -> dict:
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tf32 = ("torch.backends.cuda.matmul.allow_tf32=False, "
            "cudnn.allow_tf32=False")
    out = {}
    cfg = get_config("stablelm_3b").replace(repeats=2, dtype="float32")
    params = Model(cfg, seed=1, device="cuda").params
    runs = {(be, impl): serve_trace(torch, cfg, params, be, impl)
            for be in ("paged", "dense") for impl in ("auto", "ref")}
    del params
    tokens = {key: r[0] for key, r in runs.items()}
    kinds = runs[("paged", "auto")][1]
    n_tok = sum(len(o) for o in tokens[("paged", "ref")])
    checks = {
        "paged kernel vs plain": tokens[("paged", "auto")]
        == tokens[("paged", "ref")],
        "dense kernel vs plain": tokens[("dense", "auto")]
        == tokens[("dense", "ref")],
        "dense vs paged": tokens[("dense", "auto")]
        == tokens[("paged", "auto")],
    }
    launched = (runs[("paged", "auto")][2]["paged_attention_mixed"] > 0
                and runs[("dense", "auto")][2]["flash_attention"] > 0
                and not any(runs[(be, "ref")][2][k] for be in
                            ("paged", "dense") for k in runs[(be, "ref")][2]))
    for name, same in checks.items():
        log(f"[5/7] engine parity, stablelm_3b full width x 2 layers, "
            f"float32 ({tf32}): {name}, {n_tok} tokens over "
            f"{len(PARITY_TRACE)} requests ({kinds.count('mixed')} mixed "
            f"steps of {len(kinds)} paged), identical={same}")
    out["stablelm_3b"] = {"checks": checks, "tokens": tokens[("paged",
                                                              "ref")]}
    cfg = get_config("rwkv6_1_6b").replace(repeats=2, dtype="float32")
    params = Model(cfg, seed=2, device="cuda").params
    rk = serve_trace(torch, cfg, params, "dense", "auto")
    rr = serve_trace(torch, cfg, params, "dense", "ref")
    del params
    same = rk[0] == rr[0]
    launched = (launched and rk[2]["rwkv6_scan"] > 0
                and rr[2]["rwkv6_scan"] == 0)
    log(f"[5/7] engine parity, rwkv6_1_6b full width x 2 layers, float32 "
        f"({tf32}): dense kernel vs plain, "
        f"{sum(len(o) for o in rr[0])} tokens over {len(PARITY_TRACE)} "
        f"requests, {rk[2]['rwkv6_scan']} scan launches, identical={same}")
    checks["rwkv6 dense kernel vs plain"] = same
    out["rwkv6_1_6b"] = {"identical": same, "tokens": rr[0]}
    # Jamba: one Mamba + MoE layer and the attention layer of its period
    jamba = get_config("jamba_v0_1_52b")
    cfg = jamba.replace(period=(jamba.period[1], jamba.period[4]),
                        repeats=1, dtype="float32")
    gc.collect()
    torch.cuda.empty_cache()
    params = Model(cfg, seed=3, device="cuda").params
    jk = serve_trace(torch, cfg, params, "dense", "auto")
    jr = serve_trace(torch, cfg, params, "dense", "ref")
    del params
    same = jk[0] == jr[0]
    launched = (launched and jk[2]["selective_scan"] > 0
                and jk[2]["flash_attention"] > 0
                and not any(jr[2].values()))
    log(f"[5/7] engine parity, jamba_v0_1_52b full width, period cut to "
        f"(mamba+moe, attn+dense), float32 ({tf32}): dense kernel vs "
        f"plain, {sum(len(o) for o in jr[0])} tokens over "
        f"{len(PARITY_TRACE)} requests, {jk[2]['selective_scan']} scan and "
        f"{jk[2]['flash_attention']} flash launches, identical={same}")
    checks["jamba dense kernel vs plain"] = same
    out["jamba_v0_1_52b"] = {"identical": same, "tokens": jr[0]}
    if not launched:
        raise AssertionError("a parity run's kernel route did not launch "
                             "its kernel, or a plain run did")
    bad = [name for name, same in checks.items() if not same]
    if bad:
        raise AssertionError(f"tokens differ: {bad}")
    return out


# ------------------------------------------------------------------ phase 6
# full-width StableLM-3B in bf16 behind the harness; prompts of 256-1024
# tokens, 16 new tokens, 4 lanes a replica.  40 requests a tenant at 10
# qps keep a dense replica (~3 requests/s at full width) loaded past its
# TTFT SLO for several one-second controller samples.
HARNESS = dict(arch="stablelm_3b", reduce=False, prompt_len=256,
               prompt_len_max=1024, max_new=16, slots=4, seq_cap=2048,
               seed=0, device="cuda", verbose=False)
EXPERIMENT = dict(num_tenants=2, replicas=2, interfere=True, listen=True,
                  requests=40, qps=10.0)
# (c) takes (a)'s fleet with fewer requests: under the cost model its
# steps barely batch, so each request costs it many steps
DET_EXPERIMENT = dict(EXPERIMENT, requests=16)
ROUTING = dict(num_tenants=1, replicas=2, backend="paged", route="cache",
               response_cache=True, requests=24, qps=10.0)
_FLEET = ("routing", "directory", "response_cache", "admission", "actions",
          "arbiter_max_units", "gateway", "prometheus", "device")


def harness_run(torch, smi: str, tag: str, weights, **kw) -> dict:
    """One serve() of the harness with its launches; prints one line per
    tenant and one for the fleet, each beside the card and power limit."""
    from repro_torch.launch.serve import serve

    gc.collect()
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.perf_counter()
    out = serve(**HARNESS, **kw, params=weights)
    wall = time.perf_counter() - t0
    counts = read_counts()
    names = [k for k in out if k not in _FLEET]
    for name in names:
        o = out[name]
        log(f"[6/7] ({smi}) {tag} {name}: completed {o['completed']} / "
            f"offered {o['offered']} / shed {o['shed']} / rejected "
            f"{o['rejected']} {o['reject_reasons']} / expired "
            f"{o['expired']}, TTFT p50 {o['ttft_p50_ms']:.2f} ms p99 "
            f"{o['ttft_p99_ms']:.2f} ms, ITL p99 {o['itl_p99_ms']:.2f} ms, "
            f"{o['steps']} steps, measured compute {o['compute_s']:.3f} s, "
            f"logits_finite={o['logits_finite']}")
    log(f"[6/7] ({smi}) {tag} fleet: actions {out.get('actions')}, "
        f"arbiter_max_units {out.get('arbiter_max_units')}, routing "
        f"{out['routing']}, directory {out.get('directory')}, response "
        f"cache {out.get('response_cache')}, virtual "
        f"{out['device']['virtual_s']:.3f} s, wall {wall:.1f} s, peak "
        f"memory {out['device']['peak_mem_bytes'] / 2**30:.2f} GiB, "
        f"launches {counts}")
    if not kw.get("det_timing"):
        for name in names:
            out[name].pop("outputs")
    out["launches"] = counts
    out["wall_s"] = wall
    out.pop("prometheus")
    for name in names:
        if not out[name]["logits_finite"]:
            raise AssertionError(f"{tag} {name}: non-finite logits")
        if not out[name]["completed"]:
            raise AssertionError(f"{tag} {name}: nothing completed")
    return out


def harness(torch, smi: str) -> dict:
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model

    # every run serves the weights serve() would draw from each tenant's
    # engine seed; drawn once and shared by the runs
    cfg = get_config(HARNESS["arch"])
    cache = {}

    def weights(tenant, seed):
        if seed not in cache:
            cache[seed] = Model(cfg, seed=seed,
                                device=HARNESS["device"]).params
        return cache[seed]

    runs = {
        "(a) controller on": harness_run(torch, smi, "(a) controller on",
                                         weights, **EXPERIMENT),
        "(a) controller off": harness_run(torch, smi, "(a) controller off",
                                          weights, with_controller=False,
                                          **EXPERIMENT),
        "(b) paged routing": harness_run(torch, smi, "(b) paged routing",
                                         weights, **ROUTING),
    }
    det = [harness_run(torch, smi, f"(c) det_timing run {i}", weights,
                       det_timing=True, **DET_EXPERIMENT) for i in (1, 2)]
    runs["(c) det_timing"] = det[0]
    cache.clear()
    on, off = runs["(a) controller on"], runs["(a) controller off"]
    names = [k for k in det[0] if k.startswith("L")]
    same = {
        "outputs": [d[n]["outputs"] for d in det for n in names],
        "ttft_by_id": [d[n]["ttft_by_id"] for d in det for n in names],
        "actions": [d.get("actions") for d in det],
        "gateway": [d["gateway"] for d in det],
    }
    identical = {k: v[:len(v) // 2] == v[len(v) // 2:]
                 for k, v in same.items()}
    for n in names:
        det[0][n].pop("outputs")
    flash = sum(r["launches"]["flash_attention"] for r in
                (on, off, *det))
    paged = runs["(b) paged routing"]["launches"]["paged_attention_mixed"]
    checks = {
        "controller acted in (a)": sum(on["actions"].values()) >= 1,
        "no actions without the controller": "actions" not in off,
        "arbiter within 7 units": on["arbiter_max_units"] <= 7,
        "det_timing runs identical": all(identical.values()),
        "flash launched on the dense runs": flash > 0,
        "paged attention launched on the paged run": paged > 0,
        "cache-routed requests": runs["(b) paged routing"]["routing"]["T1"][
            "routed_cache"] > 0,
    }
    log(f"[6/7] ({smi}) det_timing runs identical: {identical}; flash "
        f"launches over the dense runs {flash}, paged launches {paged}")
    for name, ok in checks.items():
        log(f"[6/7] check {name}: {ok}")
    runs["checks"] = checks
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"harness checks failed: {bad}")
    return runs


# ------------------------------------------------------------------ phase 7
# the failure domains at full width: one tenant on 4 paged replicas.  The
# chaos schedule (seed 7) crashes r2 at 1.20 s, slows r0 4x from 1.25 s
# and sticks a lane on r1 at 1.62 s; the drain takes r3 at 1.0 s.  So the
# drain, the crash and the gray evacuation of r0 each leave a live peer
# (with 3 replicas the drain and the crash leave r0 alone, and the gray
# detector, which needs two live replicas, never fires)
FAILURES = dict(arch="stablelm_3b", reduce=False, backend="paged",
                num_tenants=1, replicas=4, requests=24, qps=10.0,
                prompt_len=256, prompt_len_max=1024, max_new=16, slots=4,
                seq_cap=2048, seed=0, chaos=True, migrate=True,
                drains=[(1.0, "T1", 3)], with_controller=False,
                device="cuda", verbose=False)


def failure_domains(torch, smi: str) -> dict:
    """(a) chaos, migration, a drain and the flight recorder on full-width
    StableLM-3B; (b) a migrated lane's tokens on the kernels."""
    from repro_torch.launch.serve import serve

    gc.collect()
    torch.cuda.empty_cache()
    trace_path = ROOT / "chiprun_out" / "phase7_trace.json"
    trace_path.parent.mkdir(exist_ok=True)
    zero_counts()
    t0 = time.perf_counter()
    out = serve(**FAILURES, trace_out=str(trace_path))
    wall = time.perf_counter() - t0
    counts = read_counts()
    t1, faults = out["T1"], out["faults"]
    migs = out["migrations"]
    trace = json.loads(trace_path.read_text())
    log(f"[7/7] ({smi}) (a) failure domains, stablelm_3b full width bf16, "
        f"1 tenant x 4 paged replicas: completed {t1['completed']} / "
        f"offered {t1['offered']} / shed {t1['shed']}, redriven "
        f"{t1['redriven']} {t1['redriven_ids']}, TTFT p50 "
        f"{t1['ttft_p50_ms']:.2f} ms p99 {t1['ttft_p99_ms']:.2f} ms, ITL "
        f"p99 {t1['itl_p99_ms']:.2f} ms, redriven TTFT "
        f"{[round(x, 2) for x in t1['redriven_ttft_ms']]} ms, "
        f"{t1['steps']} steps, KV pages held {t1['kv_pages_held']}, "
        f"virtual {out['device']['virtual_s']:.3f} s, wall {wall:.1f} s, "
        f"peak memory {out['device']['peak_mem_bytes'] / 2**30:.2f} GiB, "
        f"launches {counts}")
    log(f"[7/7] ({smi}) (a) faults {faults['log']}, watchdog_fired "
        f"{faults['watchdog_fired']}, actuator {faults.get('actuator')}")
    for m in migs:
        log(f"[7/7] ({smi}) (a) migration t={m['t']:.3f} s {m['reason']} "
            f"r{m['from']}->r{m['to']}: {m['warm']} warm / {m['cold']} "
            f"cold, {m['pages']} pages ({m['attached_pages']} attached, "
            f"{m['copied_pages']} copied), {m['bytes']} bytes, modelled "
            f"transfer {m['transfer_s'] * 1e3:.3f} ms, verify failures "
            f"{m['verify_failures']}")
    log(f"[7/7] (a) Chrome trace: {len(trace['traceEvents'])} events in "
        f"{trace_path.relative_to(ROOT)}")
    reasons = {m["reason"] for m in migs}
    checks = {
        "every request completed": t1["completed"] == t1["offered"] == 24,
        "nothing shed": t1["shed"] == 0,
        "the drain evacuated its replica": "drain" in reasons,
        "the crashed replica's lanes migrated": "crash" in reasons,
        "the gray replica was evacuated": "gray" in reasons,
        "a lane moved warm": sum(m["warm"] for m in migs) >= 1,
        "every shipped page verified": all(m["verify_failures"] == 0
                                           for m in migs),
        "no KV page held at the end": not any(t1["kv_pages_held"]),
        # serve() ran the recorder's segment lint before returning
        "the trace finished every request": out["trace"]["T1"][
            "completed"] == t1["offered"],
        "paged attention launched": counts["paged_attention_mixed"] > 0,
        "finite logits": t1["logits_finite"],
    }
    res = {"a": dict(t1, faults=faults, migrations=migs, launches=counts,
                     wall_s=wall, virtual_s=out["device"]["virtual_s"],
                     peak_mem_bytes=out["device"]["peak_mem_bytes"],
                     trace_events=len(trace["traceEvents"]))}
    res["a"].pop("outputs")
    res["b"] = migration_parity(torch)
    checks["migrated tokens identical"] = res["b"]["identical"]
    checks["every digest verified"] = res["b"]["verified"]
    for name, ok in checks.items():
        log(f"[7/7] check {name}: {ok}")
    res["checks"] = checks
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"failure-domain checks failed: {bad}")
    return res


def migration_parity(torch) -> dict:
    """PARITY_TRACE on StableLM-3B full width x 2 layers, float32, the
    kernel route: a few paged steps on engine A, every lane drained with
    its pages and imported into engine B on the same weights, finished
    there; the tokens must equal an uninterrupted run's."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.migrate import PageImporter
    from repro_torch.serving.request import Request

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("stablelm_3b").replace(repeats=2, dtype="float32")
    params = Model(cfg, seed=1, device="cuda").params
    base, _, _ = serve_trace(torch, cfg, params, "paged", "auto")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n, _ in PARITY_TRACE]

    def engine():
        return ServingEngine(cfg, params=params, max_slots=4, seq_cap=512,
                             page_size=16, chunk_tokens=64, backend="paged",
                             device="cuda")

    src, dst = engine(), engine()
    reqs = [Request(req_id=i, tenant="T1", prompt_len=len(p),
                    max_new_tokens=mn, arrival=0.0, prompt_tokens=p.copy())
            for i, (p, (_, mn)) in enumerate(zip(prompts, PARITY_TRACE))]
    for r in reqs:
        if not src.submit(r):
            raise AssertionError(f"request {r.req_id} refused")
    zero_counts()
    for i in range(9):
        src.finalize_step(src.step(), float(i))
    t0 = time.perf_counter()
    mans = src.drain_requests(ship_state=True)
    importer = PageImporter(dst.runtime)
    warm = 0
    for man in mans:
        if importer.import_lane(man):
            warm += 1
        elif not dst.submit(man.req):
            raise AssertionError(f"request {man.req.req_id} refused")
    move_s = time.perf_counter() - t0
    steps = 9
    while dst.has_work():
        dst.finalize_step(dst.step(), float(steps))
        steps += 1
        if steps > 500:
            raise AssertionError("the destination did not drain")
    counts = read_counts()
    tokens = [r.output_tokens for r in reqs]
    shipped = sum(len(m.pages) for m in mans)
    nbytes = sum(m.total_bytes for m in mans)
    identical = tokens == base
    verified = importer.verify_failures == 0 and warm == sum(
        m.warm for m in mans) and warm >= 1
    del params
    log(f"[7/7] (b) migration parity, stablelm_3b full width x 2 layers, "
        f"float32: {warm} of {len(mans)} lanes warm after 9 steps, "
        f"{shipped} pages ({nbytes} bytes) exported and imported in "
        f"{move_s * 1e3:.1f} ms, paged launches {counts['paged_attention_mixed']}"
        f", verify failures {importer.verify_failures}, "
        f"{sum(len(t) for t in tokens)} tokens, identical={identical}")
    if counts["paged_attention_mixed"] == 0:
        raise AssertionError("the migrated run did not launch paged "
                             "attention")
    return {"identical": identical, "verified": verified, "warm": warm,
            "lanes": len(mans), "pages": shipped, "bytes": nbytes,
            "move_s": move_s}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device; this "
                         "script runs on an NVIDIA GPU only")
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: {SRC / 'repro_torch'} not found; run "
                         f"from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    report = {"device": device_info(torch)}
    report["build"] = build_kernels()
    report["kernels"] = check_kernels(torch)
    report["kernels"]["flash_attention"] = check_flash(torch)
    report["kernels"]["rwkv6_scan"] = check_wkv(torch)
    report["kernels"]["selective_scan"] = check_scan(torch)
    report["serve"] = serve_full_width(torch)
    report["parity"] = engine_parity(torch)
    report["harness"] = harness(torch, report["device"]["nvidia_smi"])
    report["failures"] = failure_domains(torch, report["device"]["nvidia_smi"])
    report["total_s"] = time.perf_counter() - t0
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # per kernel: its source, the TPU kernel it replaces, and the serve
    # run of phase 4 whose launches it reports; times from its first
    # (main-path) case of phase 3
    meta = {
        "paged_attention_mixed": (
            "src/repro_torch/kernels/paged_attention/csrc/"
            "paged_attention.cu",
            "src/repro/kernels/paged_attention/kernel.py:80",
            "stablelm_3b paged bf16"),
        "flash_attention": (
            "src/repro_torch/kernels/flash_attention/csrc/"
            "flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:85",
            "stablelm_3b dense bf16"),
        "rwkv6_scan": (
            "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
            "src/repro/kernels/rwkv6_scan/kernel.py:54",
            "rwkv6_1_6b dense bf16"),
        "selective_scan": (
            "src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu",
            "src/repro/kernels/selective_scan/kernel.py:58",
            "jamba_v0_1_52b dense bf16"),
    }
    summary = {"kernels": []}
    for name, (source, replaces, run) in meta.items():
        cases = report["kernels"][name]
        main_case = cases[0]
        summary["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": report["serve"][run]["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"]})
    log(f"total {report['total_s']:.1f} s")
    print(report["device"]["nvidia_smi"])
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
