#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from a checkout of the repository (it imports ``src/repro_torch``
beside this file, and nothing of the JAX package).  Phases, each printed
on its own line:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build every kernel of the path from the checkout's sources (one
   ``nvcc`` per source, all started together);
3. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (ragged rows, pad rows, poisoned pages
   past the lengths), with its time, the plain version's, a one-call
   library yardstick's and the least time the card could take;
4. full-width StableLM-3B (bf16, random weights from a seeded
   ``torch.Generator``) served through ``repro_torch.launch.serve`` with
   the paged engine, then a shorter pass with int8 page pools; every
   request must complete with finite logits, through the kernel;
5. engine parity on the card: full width, depth cut to 2 layers, float32
   (TF32 off), the kernel against the plain version, identical tokens.

The line before the last is the kernels' JSON summary, the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero before printing a result.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and the op rate
# for the inputs' type (bf16 on the tensor cores; f32 outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ phase 1
def device_info(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    info = {"nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0]}
    log(f"[1/5] device: {info['kind']} x{info['count']}, torch "
        f"{info['torch']}, CUDA {info['cuda']}, python {info['python']}")
    log(smi)
    return info


# ------------------------------------------------------------------ phase 2
def build_kernels() -> dict:
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    builders = {"paged_attention_mixed": pa_kernel.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:
        futures = {name: pool.submit(fn) for name, fn in builders.items()}
        built = {name: f.result() for name, f in futures.items()}
    out = {}
    for name, b in built.items():
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        out[name] = {"so": b.path.name, "build_s": b.build_s,
                     "ptxas": ptxas}
        log(f"[2/5] built {name}: {b.path.name} in {b.build_s:.1f}s")
        for ln in ptxas:
            log(f"      ptxas: {ln}")
    log(f"[2/5] all kernels built in {time.perf_counter() - t0:.1f}s")
    return out


# ------------------------------------------------------------------ phase 3
def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls
    (inputs stay L2-warm), by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main_path_step(torch, *, heads, kv, hd, page=16, lanes=8, pps=128,
                   pool_pages=1024, chunk=64, seed=0, device="cuda"):
    """One fused step's attention call as the serving path makes it: 7
    decode rows and one 64-row prefill chunk from 8 lanes of 64..1056
    tokens, padded to the row bucket (80) with pad rows at position 0 and
    a zero table; each row is its own Q=1 lane carrying its lane's table.
    Pool pages past each lane's length (and slots past it in its last
    page) are poisoned, so the causal page walk must mask them."""
    import numpy as np
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
    rows_t, rows_p = [], []
    for lane in range(lanes - 1):                   # decode rows
        rows_t.append(tables[lane])
        rows_p.append(int(lens[lane]) - 1)
    start = int(lens[-1]) - chunk                   # a prefill chunk
    for i in range(chunk):
        rows_t.append(tables[-1])
        rows_p.append(start + i)
    n = len(rows_p)
    b = n if n <= 16 else -(-n // 16) * 16          # serving/sched.bucket_rows
    bt = np.zeros((b, pps), np.int32)
    bt[:n] = np.stack(rows_t)
    qpos = np.zeros((b, 1), np.int32)
    qpos[:n, 0] = rows_p
    q = rng.standard_normal((b, 1, heads, hd)).astype(np.float32)
    return {name: torch.from_numpy(a).to(device) for name, a in
            (("q", q), ("k", k), ("v", v), ("bt", bt), ("qpos", qpos))}


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
    dtype = "float32" if q.dtype == torch.float32 else "bfloat16"
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


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

    cases = [("stablelm bf16", 32, 32, 80, torch.bfloat16, False, 2e-2),
             ("stablelm int8 pages", 32, 32, 80, torch.bfloat16, True, 2e-2),
             ("stablelm f32", 32, 32, 80, torch.float32, False, 2e-3),
             ("gqa bf16 (H=32, KV=8)", 32, 8, 128, torch.bfloat16, False,
              2e-2)]
    results = []
    for name, heads, kv, hd, dt, int8, tol in cases:
        x = main_path_step(torch, heads=heads, kv=kv, hd=hd)
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
            live = x["qpos"][:, 0] > 0
            fp_err = float((out.float() - fp.float())[live].abs().max())
            ok = ok and bool(torch.allclose(out.float()[live],
                                            fp.float()[live], rtol=0.05,
                                            atol=0.05))
            extra = f", vs fp pages {fp_err:.3g} (tol 0.05)"
        ms = cuda_ms(torch, lambda: pa_kernel.paged_attention_mixed(
            *args, **kw))
        plain_ms = cuda_ms(torch, lambda: paged_attention_mixed_ref(
            *args, **kw), iters=5)
        lib_ms = cuda_ms(torch, sdpa_yardstick(torch, *args, **kw))
        bound_ms, bound_by, nbytes, ops = attention_bound(
            torch, q, kp, x["bt"], x["qpos"], kw.get("k_scales"))
        res = {"case": name, "shape": {"B": q.shape[0], "Q": q.shape[1],
                                       "H": heads, "KV": kv, "hd": hd,
                                       "page": kp.shape[1],
                                       "width": x["bt"].shape[1],
                                       "pool_pages": kp.shape[0]},
               "dtype": str(dt).replace("torch.", ""), "int8_pages": int8,
               "max_abs_err": err, "tol": tol, "ok": ok, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bytes": nbytes, "ops": ops}
        results.append(res)
        log(f"[3/5] paged_attention_mixed {name}: B={q.shape[0]} Q=1 "
            f"H={heads} KV={kv} hd={hd}: max_abs_err {err:.3g} (tol {tol})"
            f"{extra}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
            f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} Gop)")
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"on {name}: max_abs_err {err}")
        del x, q, kp, vp, args, out, ref
        torch.cuda.empty_cache()
    return {"paged_attention_mixed": results}


# ------------------------------------------------------------------ phase 4
def serve_full_width(torch) -> dict:
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.launch.serve import serve

    layers = get_config("stablelm_3b").num_layers
    runs = {}
    for tag, kw in (("bf16", dict(requests=8, max_new=32)),
                    ("int8", dict(requests=4, max_new=8, kv_dtype="int8"))):
        gc.collect()
        torch.cuda.empty_cache()
        pa_kernel.launches = 0
        t0 = time.perf_counter()
        out = serve(arch="stablelm_3b", reduce=False, qps=20.0,
                    prompt_len=64, prompt_len_max=1024, slots=8,
                    seq_cap=2048, seed=0, device="cuda", **kw)
        wall = time.perf_counter() - t0
        launches = pa_kernel.launches
        out.pop("outputs")
        out.update(launches=launches, wall_s=wall)
        runs[tag] = out
        log(f"[4/5] serve stablelm_3b full width ({tag}): completed "
            f"{out['completed']}/{out['offered']}, {out['steps']} steps, "
            f"TTFT p50 {out['ttft_p50_ms']:.2f} ms p99 "
            f"{out['ttft_p99_ms']:.2f} ms, ITL p50 {out['itl_p50_ms']:.2f} "
            f"ms p99 {out['itl_p99_ms']:.2f} ms, {out['tokens_per_s']:.1f} "
            f"tokens/s, peak memory {out['peak_mem_bytes'] / 2**30:.2f} "
            f"GiB, kernel launches {launches} ({out['forward_passes']} "
            f"forward passes x {layers} layers), wall {wall:.1f} s")
        if out["completed"] != out["offered"]:
            raise AssertionError(f"{tag}: not every request completed")
        if not out["logits_finite"]:
            raise AssertionError(f"{tag}: non-finite logits")
        if launches < out["steps"] * layers or \
                launches != out["forward_passes"] * layers:
            raise AssertionError(f"{tag}: {launches} kernel launches for "
                                 f"{out['forward_passes']} forward passes")
    return runs


# ------------------------------------------------------------------ phase 5
def engine_parity(torch) -> dict:
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("stablelm_3b").replace(repeats=2, dtype="float32")
    params = Model(cfg, seed=1, device="cuda").params
    trace = [(200, 8), (37, 12), (120, 6), (9, 10), (250, 5)]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n, _ in trace]
    outputs = {}
    for impl in ("auto", "ref"):
        eng = ServingEngine(cfg, params=params, max_slots=4, seq_cap=512,
                            page_size=16, chunk_tokens=64, attn_impl=impl,
                            device="cuda")
        reqs = [Request(req_id=i, tenant="T1", prompt_len=len(p),
                        max_new_tokens=mn, arrival=0.0,
                        prompt_tokens=p.copy())
                for i, (p, (_, mn)) in enumerate(zip(prompts, trace))]
        for r in reqs:
            if not eng.submit(r):
                raise AssertionError(f"{impl}: request {r.req_id} refused")
        kinds = []
        while eng.has_work():
            rep = eng.step()
            eng.finalize_step(rep, float(len(kinds)))
            kinds.append(rep.kind)
            if len(kinds) > 500:
                raise AssertionError(f"{impl}: the engine did not drain")
        outputs[impl] = [r.output_tokens for r in reqs]
        del eng
    same = outputs["auto"] == outputs["ref"]
    log(f"[5/5] engine parity, stablelm_3b full width x 2 layers, float32 "
        f"(torch.backends.cuda.matmul.allow_tf32=False, "
        f"cudnn.allow_tf32=False): kernel vs plain attention, "
        f"{sum(len(o) for o in outputs['ref'])} tokens over {len(trace)} "
        f"requests, {kinds.count('mixed')} mixed steps of {len(kinds)}, "
        f"identical={same}")
    if not same:
        raise AssertionError(f"kernel tokens {outputs['auto']} != plain "
                             f"tokens {outputs['ref']}")
    return {"identical": same, "tokens": outputs["ref"]}


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
    report["serve"] = serve_full_width(torch)
    report["parity"] = engine_parity(torch)
    report["total_s"] = time.perf_counter() - t0
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    main_case = report["kernels"]["paged_attention_mixed"][0]
    summary = {"kernels": [{
        "name": "paged_attention_mixed", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/"
                  "paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:80",
        "launches": report["serve"]["bf16"]["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in
                           report["kernels"]["paged_attention_mixed"]),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]}
    log(f"total {report['total_s']:.1f} s")
    print(report["device"]["nvidia_smi"])
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
