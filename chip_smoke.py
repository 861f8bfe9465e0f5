#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from a checkout of the repository (it imports ``src/repro_torch``
beside this file, and nothing of the JAX package).  Phases, each printed
on its own line:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build every kernel of the paths from the checkout's sources (one
   ``nvcc`` per source, all started together: the four forwards and the
   three backwards), and count each library's tensor-core instructions
   (``HMMA`` from mma.sync, ``HGMMA`` from wgmma, in ``cuobjdump
   --dump-sass``): a tensor-core kernel's library with none fails (the
   scans' CUDA-core backwards are counted, not required to have any), and
   the flash backward's library must hold wgmma (``HGMMA``) ones;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the paths give it (paged attention: the runtime's lane-major
   call first, then the same rows row-major, as the JAX runtime calls,
   with ragged rows, pad rows, poisoned pages past the lengths, int8
   pages, GQA and a chunk past one 64-row query tile; flash attention:
   StableLM's prefill and the ragged, end-aligned, non-causal,
   windowed/softcapped GQA and head_dim-72 cases, then the head_dim-128
   geometries of phase 4's serves: OLMo 2's MHA, StarCoder2's group of
   9, Gemma 2's global and windowed layers with softcap 50 and Granite's
   group of 4, then Phi-3-vision's prefill (576 patches + 1024 tokens, hd
   96), SeamlessM4T's non-causal encoder (S = T = 1024 and 777) and its
   prefill cross-attention (one BOS row over 1024 frames), and MLA's
   prefill (128 heads of 128 + 64, V zero-padded; and the reduced 32 + 16
   in f32); paged attention at OLMo 2's H = KV = 32 too; the WKV scan: RWKV-6
   prefill and decode, a ragged S, bf16 inputs and the other head widths
   at ragged B, H and S; the selective scan: Jamba's Mamba prefill with
   bf16 and f32 x, a ragged S, decode, two chained halves, D off the
   channel tile, N = 1, 13 and 64, and delta * A past the exponential's
   flush to 0; the flash backward: the training shape S = T = 4096, H =
   KV = 32, hd 80 in bf16 (two calls must give the same bits), OLMo 2's
   at hd 128, f32 at hd 64, GQA with a window and softcap at hd 128,
   non-causal T != S and MLA's hd 192, against its plain version on the
   forward kernel's output and log-sum-exp, each gradient within 2e-2
   (bf16) or 2e-3 (f32) of its max |value|, each case printed with the
   design the source runs for it (wgmma, mma or cuda_cores); the WKV
   backward at
   RWKV-6's training shape B 2, S 4096, H 32, hd 64, then a ragged S with
   an initial state and a cotangent on the final state, hd 16, 32 and 128
   at ragged B and H, and w past f32 underflow; the selective-scan
   backward at Jamba's training shape B 2, S 4096, D 8192, N 16 with x in
   bf16, then x in f32, a ragged S, D off the channel tile, N = 1, 13 and
   64, h0 with a cotangent on the final state, and delta * A past the
   exponential's flush to 0; each backward against its plain version by
   formula on the same inputs, every gradient within 2e-3 (2e-2 for bf16
   x) of its max |value|), with its
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
   StarCoder2 7B and Gemma 2 27B dense (head_dim 128), then DeepSeek-V2
   (MLA, its dense first layer and 6 repeats of its MoE layer, 7 layers),
   Phi-3-vision (576 zero patch embeds before each prompt), SeamlessM4T
   (24 encoder and 24 cross-attending decoder layers, zero frames) and
   Mixtral 8x7B (20 of its 32 layers) dense; every request must complete
   with finite logits, and every pass must go through each of the path's
   kernels once per layer that launches it (flash: each attention layer,
   each cross-attention block and each encoder layer of a prefill; the
   counts are zeroed before each run);
5. engine parity on the card, float32 (TF32 off): full width, depth cut
   to 2 layers, identical tokens for the paged and dense StableLM engines
   with kernels against plain versions, dense against paged, and the
   RWKV-6 and Jamba (one Mamba + MoE layer and the attention layer) dense
   engines with the kernels against the plain versions; then reduced
   DeepSeek-V2, Phi-3-vision and SeamlessM4T on the dense engine, kernels
   against plain versions;
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
   tokens of an uninterrupted run;
8. training (``repro_torch.launch.train``): (a) full-width StableLM-3B,
   (c) full-width RWKV-6 1.6B (lr 1e-4, see ``TRAIN_RUNS``) and (d)
   Jamba at its published widths cut to the first two layers of its
   period, each in bf16 with remat, one batch of 2 x 4096 tokens
   memorised for 6 AdamW steps: the loss must fall, every leaf get a
   finite nonzero gradient, the peak stay under 75 GiB, and each layer's
   kernels launch exactly steps x 2 times (forward; remat runs it again in
   the backward) and steps times (backward), no other kernel launching;
   step times, tokens a second, peak memory, gradient norms and losses
   are printed, and the last step runs under ``torch.profiler`` for its
   device time by kernel family and the device's idle share; (b) and (e)
   reduced StableLM, RWKV-6 and Jamba in float32 trained 3 steps on the
   kernels, each step's loss and every leaf's gradient held to the plain
   versions' on the same weights and batch (1e-5 relative; 1e-4 of the
   leaf's max |grad|); (f) ``examples/train_small.py``'s twin (reduced
   Jamba, 200 steps) on the card: the loss must fall;
9. the launch layer (``repro_torch.launch``): the plan-level dry run of
   the eleven configs x the four input shapes x both production meshes
   (analytic per-device estimates, one line a config); then an NCCL
   process group of one rank (a ``FileStore`` in a temporary directory)
   and its 1 x 1 ``DeviceMesh``; full-width StableLM-3B trained 2 steps
   through ``build_step``'s train step on phase 8 (a)'s seed, weights and
   batch, whose losses must be phase 8 (a)'s first two bit for bit (at
   world size 1 nothing is gathered or summed), with flash launched 2 x 2
   x 32 times and its backward 2 x 32; a prefill (batch 2, prompt 1024)
   and 4 serve steps through ``build_step`` on the trained weights, whose
   tokens must be the direct ``prefill`` / ``decode_step`` calls'; the
   steps' collective tally (``launch/collectives.py``) must be 0 bytes at
   world size 1, and the peak memory and the largest parameter gather
   alive at once are printed; the dry run prints each step's analytic
   collective bytes a device (``launch/dryrun.py::collective_bytes``);
   (e) the same train step under ``make_policy(..., seq_parallel=True)``
   (Megatron's sequence parallelism, ``build_step``'s override) for 2
   steps on the same seed, weights and batch, whose losses must be (a)'s
   bit for bit; (f) full-width StableLM-3B served dense and paged by the
   engines under ``policy=make_policy(<decode shape>), mesh=`` the 1 x 1
   mesh, in turns with the unsharded engines on the same weights and
   prompts (unsharded, policy, policy, unsharded), every run the same
   tokens, each path's kernel launched once a pass and layer; (h) the
   dense run again under the decode policy of a 1 x 1 x 1 ``("pod",
   "data", "model")`` mesh (the slots' owner and the logits' gather over
   the batch axes at extent 1), the same tokens, its tally 0 bytes; (i)
   full-width Granite-3-8B served paged unsharded and under the policy,
   the same tokens, and paged attention at its per-rank shapes of a
   ``model`` axis of 4 (8 query heads over 2 KV heads) and 16 (2 over 1,
   hd 128) against the plain version (2e-2) and timed beside the whole
   shape; (j) its policy runtime's lanes exported mid-trace and imported
   into an unsharded engine, the unmigrated run's tokens; (k) the train
   step on the pod mesh, its losses phase 8 (a)'s bit for bit, and a
   batch-1 ``long_500k`` serve step of full-width StarCoder2-7B on its
   4096-token window's cache, the logits ``decode_step``'s bit for bit;
   the tally over (a) to (k) must be 0 bytes; (g) each kernel on a sharded
   path against its plain version at the per-rank shape a 4-way
   ``model`` axis gives it (heads or channels / 4: flash forward and
   backward at StableLM-3B's S = T = 4096 with 8 heads of 80, MLA's 32
   heads at hd 192, the WKV forward and backward at RWKV-6's B 2, S 4096,
   8 heads of 64, the selective scan's forward in its checkpoint mode and
   its backward at Jamba's B 2, S 4096, D 2048, N 16, and paged attention
   at StableLM-3B's 8 of 32 heads of 80 and OLMo 2's 8 of 32 of 128),
   phase 3's tolerances, each timed beside its plain version.

The line before the last is the kernels' JSON summary, the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero before printing a result.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import functools
import gc
import json
import math
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
    log(f"[1/8] device: {info['kind']} x{info['count']}, torch "
        f"{info['torch']}, CUDA {info['cuda']}, python {info['python']}")
    log(smi)
    return info


# ------------------------------------------------------------------ phase 2
def kernel_modules() -> dict:
    """The wrapper module of every kernel of the paths, by kernel name."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import kernel_bwd as fab_kernel
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6_scan import kernel_bwd as wkvb_kernel
    from repro_torch.kernels.selective_scan import kernel as scan_kernel
    from repro_torch.kernels.selective_scan import kernel_bwd as scanb_kernel
    return {"paged_attention_mixed": pa_kernel,
            "flash_attention": fa_kernel, "flash_attention_bwd": fab_kernel,
            "rwkv6_scan": wkv_kernel, "selective_scan": scan_kernel,
            "rwkv6_scan_bwd": wkvb_kernel,
            "selective_scan_bwd": scanb_kernel}


def zero_counts() -> None:
    for mod in kernel_modules().values():
        mod.launches = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in kernel_modules().items()}


# kernels redesigned for the tensor cores: their libraries must hold
# tensor-core instructions; those redesigned for wgmma must hold wgmma's
TENSOR_CORE_KERNELS = ("paged_attention_mixed", "flash_attention",
                       "flash_attention_bwd")
WGMMA_KERNELS = ("flash_attention_bwd",)


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
        log(f"[2/8] built {name}: {b.path.name} in {b.build_s:.1f}s; "
            f"tensor-core instructions in its SASS: HMMA {mma['HMMA']}, "
            f"HGMMA {mma['HGMMA']}")
        for ln in ptxas:
            log(f"      ptxas: {ln}")
        if name in TENSOR_CORE_KERNELS and not sum(mma.values()):
            raise AssertionError(f"{name}: no tensor-core instruction in "
                                 f"{b.path.name}")
        if name in WGMMA_KERNELS and not mma["HGMMA"]:
            raise AssertionError(f"{name}: no wgmma (HGMMA) instruction in "
                                 f"{b.path.name}")
    log(f"[2/8] all kernels built in {time.perf_counter() - t0:.1f}s")
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
        log(f"[3/8] paged_attention_mixed {name}: B={q.shape[0]} "
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
        # the geometries of phase 4's Phi-3-vision, SeamlessM4T and
        # DeepSeek-V2 serves
        ("phi3v prefill H=KV=32 hd=96 S=T=1600 bf16", 1, 1600, 1600, 32, 32,
         96, True, 0, None, torch.bfloat16, 2e-2),
        ("seamless encoder non-causal H=KV=16 hd=64 S=T=1024 bf16", 1, 1024,
         1024, 16, 16, 64, False, 0, None, torch.bfloat16, 2e-2),
        ("seamless encoder non-causal S=T=777 bf16", 1, 777, 777, 16, 16, 64,
         False, 0, None, torch.bfloat16, 2e-2),
        ("seamless cross-attention non-causal S=1 T=1024 bf16", 1, 1, 1024,
         16, 16, 64, False, 0, None, torch.bfloat16, 2e-2),
        ("mla prefill H=KV=128 hd=128+64 (V padded) S=T=1024 bf16", 1, 1024,
         1024, 128, 128, 192, True, 0, None, torch.bfloat16, 2e-2),
        ("mla reduced hd=32+16 (V padded) S=T=250 f32", 1, 250, 250, 4, 4, 48,
         True, 0, None, torch.float32, 2e-3),
    ]
    # MLA's V is its 128 (reduced: 32) columns, zero-padded to the Q/K width
    v_width = {192: 128, 48: 32}
    results = []
    for (name, b, s, t, h, kv, hd, causal, window, cap, dt,
         tol) in cases:
        q, k, v = flash_inputs(torch, b, s, t, h, kv, hd, dt, seed=s + t)
        if name.startswith("mla"):
            v[..., v_width[hd]:] = 0
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
        log(f"[3/8] flash_attention {name}: B={b} S={s} T={t} H={h} KV={kv} "
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


def flash_bwd_bound(torch, q, k, mask):
    """Least time for one backward call: q, k, v, o, dO and lse read once
    and dq, dk, dv written once, against the five products of the
    backward (S, dP, dV, dK, dQ: 10 * hd operations per kept pair and
    query head, 2.5 times the forward's)."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    es = q.element_size()
    nbytes = 4 * (b * s * h * hd + b * t * kv * hd) * es + 4 * b * h * s
    ops = 10 * hd * h * b * int(mask.sum())
    return least_time(torch, nbytes, ops, q.dtype)


def check_flash_bwd(torch) -> list:
    """The forward as training launches it (asked for its log-sum-exp)
    against ``flash_attention_ref``: o within ``tol``, lse within ``tol``
    with +inf in the same rows.  Then the backward kernel on the kernel's
    o and lse against ``flash_attention_bwd_ref`` on the plain version's
    (same q, k, v and random dO), each gradient within ``tol`` of its own
    max |value|; timed beside the plain version and SDPA's backward (the
    port never calls SDPA).  Each case prints the design the source runs
    for it (``kernel_bwd.design``); at the training shape a second call
    must give the same bits."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import kernel_bwd as fab_kernel
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)

    # name, B, S, T, H, KV, hd, causal, window, softcap, dtype, tol; the
    # first is the training shape (phase 8's StableLM-3B layer at batch 1)
    cases = [
        ("stablelm train bf16 S=T=4096", 1, 4096, 4096, 32, 32, 80, True, 0,
         None, torch.bfloat16, 2e-2),
        ("olmo2 train bf16 S=T=4096 hd=128", 1, 4096, 4096, 32, 32, 128,
         True, 0, None, torch.bfloat16, 2e-2),
        ("f32 H=KV=8 hd=64 S=T=1024", 1, 1024, 1024, 8, 8, 64, True, 0, None,
         torch.float32, 2e-3),
        ("gqa H=32 KV=8 hd=128 window 256 softcap 50 bf16", 1, 1024, 1024,
         32, 8, 128, True, 256, 50.0, torch.bfloat16, 2e-2),
        ("non-causal S=512 T=777 H=KV=16 hd=64 bf16", 2, 512, 777, 16, 16, 64,
         False, 0, None, torch.bfloat16, 2e-2),
        ("mla H=KV=128 hd=128+64 (V padded) S=T=1024 bf16", 1, 1024, 1024,
         128, 128, 192, True, 0, None, torch.bfloat16, 2e-2),
    ]
    results = []
    for (name, b, s, t, h, kv, hd, causal, window, cap, dt,
         tol) in cases:
        q, k, v = flash_inputs(torch, b, s, t, h, kv, hd, dt, seed=s + t + 1)
        if name.startswith("mla"):
            v[..., 128:] = 0
        do = flash_inputs(torch, b, s, s, h, h, hd, dt, seed=s + 7)[0]
        kw = dict(causal=causal, window=window, softcap=cap)
        o, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_ref(q, k, v, return_lse=True, **kw)
        live = torch.isfinite(lse_ref)
        errs = {"o": float((o.float() - o_ref.float()).abs().max()),
                "lse": float((lse - lse_ref)[live].abs().max())}
        ok = bool(torch.allclose(o.float(), o_ref.float(), rtol=tol,
                                 atol=tol)) and bool(torch.allclose(
                                     lse[live], lse_ref[live], rtol=tol,
                                     atol=tol)) and bool(torch.equal(
                                         torch.isinf(lse), ~live))
        args = (q, k, v, o, lse, do)
        design = fab_kernel.design(hd, dt, fab_kernel.aligned(q, k, v, do))
        grads = fab_kernel.flash_attention_bwd(*args, **kw)
        torch.cuda.synchronize()
        same_bits = None
        if not results:
            # the training shape: no atomics, so a second call repeats
            again = fab_kernel.flash_attention_bwd(*args, **kw)
            torch.cuda.synchronize()
            same_bits = all(bool(torch.equal(g, g2))
                            for g, g2 in zip(grads, again))
            ok = ok and same_bits
            del again
        refs = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
        scales = {}
        for gname, g, r in zip(("dq", "dk", "dv"), grads, refs):
            scales[gname] = float(r.float().abs().max())
            errs[gname] = float((g.float() - r.float()).abs().max())
            ok = ok and errs[gname] <= tol * scales[gname] and bool(
                torch.isfinite(g).all())
        err = max(errs[g] for g in ("dq", "dk", "dv"))
        del grads, refs, o_ref, lse_ref, live
        iters = 5 if s * t > 2 ** 22 or h > 64 else 20
        ms, eager_ms = (cuda_ms(torch, lambda: fab_kernel.flash_attention_bwd(
            *args, **kw), iters=iters, graph=True),
            cuda_ms(torch, lambda: fab_kernel.flash_attention_bwd(*args, **kw),
                    iters=iters))
        plain_ms = cuda_ms(torch, lambda: flash_attention_bwd_ref(*args, **kw),
                           iters=2, warmup=1)
        mask = flash_mask(torch, s, t, causal, window)
        lib_ms = None
        if cap is None:
            # SDPA's backward on [B, H, S, hd] views, its forward outside
            # the timing; the port never calls it
            qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            plain_causal = causal and s == t and not window
            sdpa_kw = (dict(is_causal=True) if plain_causal else
                       dict(attn_mask=mask) if causal or window else {})
            out = F.scaled_dot_product_attention(qs, ks, vs,
                                                 enable_gqa=kv != h,
                                                 **sdpa_kw)
            dos = do.transpose(1, 2)
            lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
                out, (qs, ks, vs), dos, retain_graph=True), iters=iters)
            del qs, ks, vs, out, dos
        bound_ms, bound_by, nbytes, ops = flash_bwd_bound(torch, q, k, mask)
        res = {"case": name, "shape": {"B": b, "S": s, "T": t, "H": h,
                                       "KV": kv, "hd": hd},
               "causal": causal, "window": window, "softcap": cap,
               "dtype": str(dt).replace("torch.", ""), "design": design,
               "same_bits": same_bits, "max_abs_err": err,
               "errs": errs, "grad_max_abs": scales, "tol": tol,
               "ok": ok, "ms": ms,
               "eager_ms": eager_ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": nbytes, "ops": ops}
        results.append(res)
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none (softcap)"
        bits = "" if same_bits is None else f", same bits twice {same_bits}"
        log(f"[3/8] flash_attention_bwd {name} ({design}{bits}): B={b} S={s} "
            f"T={t} H={h} KV={kv} hd={hd}: forward o {errs['o']:.3g}, lse "
            f"{errs['lse']:.3g} (tol {tol}); max_abs_err dq {errs['dq']:.3g} "
            f"dk {errs['dk']:.3g} dv {errs['dv']:.3g} (tol {tol} x max|grad| "
            f"{scales['dq']:.3g} {scales['dk']:.3g} {scales['dv']:.3g}); "
            f"kernel {ms:.4f} ms (eager {eager_ms:.4f}), plain "
            f"{plain_ms:.4f} ms, sdpa backward {lib}, bound {bound_ms:.4f} "
            f"ms ({bound_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} Gop)")
        if not ok:
            raise AssertionError(f"flash forward (with lse) or backward "
                                 f"kernel disagrees with its plain version "
                                 f"on {name}: {errs}, max|grad| {scales}, "
                                 f"same bits twice {same_bits}")
        del q, k, v, o, lse, do, args, mask
        torch.cuda.empty_cache()
    return results


def hold_grads(torch, names, grads, refs, tol):
    """Each gradient against its plain version, relative to the plain
    version's own max |value|: (ok, max abs errors, max |value|s)."""
    errs, scales, ok = {}, {}, True
    for name, g, r in zip(names, grads, refs):
        scales[name] = float(r.float().abs().max())
        errs[name] = float((g.float() - r.float()).abs().max())
        ok = ok and bool(torch.isfinite(g).all()) and \
            errs[name] <= tol * scales[name]
    return ok, errs, scales


def wkv_bwd_bound(torch, r):
    """Least time for one backward call: r, k, v, w and dy read once, dr,
    dk, dv and dw written once (and u, du, s0, the cotangent of s_final
    and ds0), against the f32 operations the gradient needs: per state
    element and step the rerun of S (2), the adjoint G (2) and the sums
    of dr, dk, dw and dv (2 each); per head and step ~10 hd for the u
    terms and du."""
    b, s, h, hd = r.shape
    n = b * s * h * hd
    nbytes = 9 * n * 4 + 2 * h * hd * 4 + 3 * b * h * hd * hd * 4
    ops = (12 * hd + 10) * hd * h * b * s
    return least_time(torch, nbytes, ops, torch.float32)


def short_kernel_name(name: str) -> str:
    """A profiler's kernel name without its return type, namespace and
    arguments: 'wkv_bwd_cluster_kernel<64>'."""
    name = name.replace("void ", "", 1).replace("(anonymous namespace)::", "")
    return name.split("(")[0]


def check_wkv_bwd(torch) -> list:
    """The WKV backward kernel against ``rwkv6_scan_bwd_ref`` on the same
    inputs and cotangents, every gradient within 2e-3 of its own max
    |value|, f32 throughout; timed beside the plain version (a Python
    loop over S: at the training shape timed once, after no warm-up).  At
    the training shape also: two calls give the same bits, and each CUDA
    kernel of a call is timed apart under ``torch.profiler`` (the split).
    Logs how many clusters of each head width's kernel the card holds at
    once."""
    import numpy as np
    from repro_torch.kernels.rwkv6_scan import kernel_bwd as wkvb_kernel
    from repro_torch.kernels.rwkv6_scan.kernel import HEAD_DIMS
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_bwd_ref
    from repro_torch.launch.profile_wkv_bwd import kernel_split

    fits = {hd: wkvb_kernel.max_clusters(hd) for hd in HEAD_DIMS}
    log("[3/8] rwkv6_scan_bwd: clusters the card holds at once, by head "
        "width: " + ", ".join(
            f"hd {hd} ({wkvb_kernel.cluster_size(hd)} blocks) {n}"
            for hd, n in fits.items()))
    # name, B, S, H, hd, s0 and a cotangent on s_final, w_log = 6 on some
    # channels; the first is the training shape (phase 8's RWKV-6 layer)
    cases = [("rwkv6 train B=2 S=4096 H=32 hd=64", 2, 4096, 32, 64, False,
              False),
             ("ragged S=1000, s0 and ds_final", 2, 1000, 8, 64, True, False),
             ("hd 16, B=3 H=5 S=45", 3, 45, 5, 16, True, False),
             ("hd 32, B=3 H=5 S=70", 3, 70, 5, 32, True, False),
             ("hd 128, B=3 H=5 S=70", 3, 70, 5, 128, True, False),
             ("w past f32 underflow (w_log = 6 on a third of the channels)",
              2, 200, 4, 64, True, True),
             ("hd 128, S=1000, a cluster of 8", 2, 1000, 4, 128, True,
              False),
             ("more clusters than fit at once, B=4 H=40 S=333", 4, 333, 40,
              64, True, False)]
    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    tol = 2e-3
    results = []
    for name, b, s, h, hd, with_state, underflow in cases:
        r, k, v, w, u, s0 = wkv_inputs(torch, b, s, h, hd, torch.float32,
                                       seed=s + hd)
        rng = np.random.default_rng(s + hd + 1)
        if underflow:
            # w = exp(-exp(6)) = exp(-403) is 0 in f32
            w[..., ::3] = float(np.exp(-np.exp(6.0)))
        if not with_state:
            s0.zero_()
        dy = torch.from_numpy(rng.standard_normal((b, s, h, hd)).astype(
            np.float32)).to("cuda")
        dsf = (torch.from_numpy((rng.standard_normal((b, h, hd, hd)) * 0.1)
                                .astype(np.float32)).to("cuda")
               if with_state else torch.zeros_like(s0))
        args = (r, k, v, w, u, s0, dy, dsf)
        grads = wkvb_kernel.rwkv6_scan_bwd(*args)
        torch.cuda.synchronize()
        refs = rwkv6_scan_bwd_ref(*args)
        ok, errs, scales = hold_grads(torch, names, grads, refs, tol)
        del refs
        extra = {}
        if not results:
            again = wkvb_kernel.rwkv6_scan_bwd(*args)
            torch.cuda.synchronize()
            extra["same_bits"] = all(torch.equal(x, y)
                                     for x, y in zip(grads, again))
            del again
            extra["split_ms"] = kernel_split(
                lambda: wkvb_kernel.rwkv6_scan_bwd(*args))
            log(f"[3/8] rwkv6_scan_bwd {name}: two calls give the same "
                f"bits: {extra['same_bits']}; kernels of one call: " +
                "; ".join(f"{short_kernel_name(kname)} {kms:.4f} ms"
                          for kname, kms in extra["split_ms"].items()))
            ok = ok and extra["same_bits"]
        del grads
        big = s * b * h > 2 ** 16
        ms = cuda_ms(torch, lambda: wkvb_kernel.rwkv6_scan_bwd(*args),
                     iters=5 if big else 20, graph=True)
        plain_ms = cuda_ms(torch, lambda: rwkv6_scan_bwd_ref(*args),
                           iters=1 if big else 3, warmup=0 if big else 1)
        bound_ms, bound_by, nbytes, ops = wkv_bwd_bound(torch, r)
        err = max(errs.values())
        results.append({
            "case": name, "shape": {"B": b, "S": s, "H": h, "hd": hd},
            "dtype": "float32", "s0_and_ds_final": with_state,
            "w_underflow": underflow, "max_abs_err": err, "errs": errs,
            "grad_max_abs": scales, "tol": tol, "ok": ok, "ms": ms,
            "plain_ms": plain_ms, "plain_iters": 1 if big else 3,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "ops": ops,
            "cluster_blocks": wkvb_kernel.cluster_size(hd),
            "max_clusters": fits[hd], **extra})
        log(f"[3/8] rwkv6_scan_bwd {name}: B={b} S={s} H={h} hd={hd}: "
            f"max_abs_err " + " ".join(f"{g} {errs[g]:.3g}" for g in names)
            + f" (tol {tol} x max|grad| " + " ".join(
                f"{scales[g]:.3g}" for g in names) + f"); kernel {ms:.4f} "
            f"ms, plain {plain_ms:.1f} ms ({'1 call' if big else '3 calls'}),"
            f" library none, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} Gop)")
        if not ok:
            raise AssertionError(f"WKV backward kernel disagrees with its "
                                 f"plain version on {name}: {errs}, "
                                 f"max|grad| {scales}, {extra}")
        del args, r, k, v, w, u, s0, dy, dsf
        torch.cuda.empty_cache()
    return results


def scan_bwd_bound(torch, x, n):
    """Least time for one backward call: x, delta and dy read once, dx and
    ddelta written once, B, C, dB, dC, A, dA, D, dD, h0, the cotangent of
    h_final and dh0 once each, against the f32 operations the gradient
    needs: per (step, channel, state) the rerun of h with its exponential
    (4), the adjoint (3), ddelta's and dA's terms (5), dx's, dB's and
    dC's (4); per (step, channel) ~8.  Also returns the exponentials' time
    on the special-function units, once (the design evaluates them twice
    in the backward and once in the forward's checkpoint mode)."""
    b, s, d = x.shape
    es = x.element_size()
    nbytes = (b * s * d * (3 * es + 8) + 4 * b * s * n * 4
              + 2 * d * n * 4 + 2 * d * 4 + 3 * b * d * n * 4)
    ops = b * s * d * (16 * n + 8)
    exp_ms = b * s * d * n / (SFU_PER_CLK_SM * SM_COUNT * BOOST_HZ) * 1e3
    return least_time(torch, nbytes, ops, torch.float32) + (exp_ms,)


def check_scan_ckpt(torch) -> dict:
    """The forward kernel's checkpoint mode: h before every 32nd step
    against the plain version's h at each chunk start (chunks chained
    through the state), within 2e-3 of the plain h's max |value|, and y and
    h_final as without it; at the training shape also the mode's extra
    time (graph replay)."""
    from repro_torch.kernels.selective_scan import kernel as scan_kernel
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    from repro_torch.launch.profile_scan_bwd import inputs
    # name, B, S, D, N, x dtype, h0; the 1-step-group instance below 8
    # steps, ragged chunks, the 64-state build, the training shape
    cases = (("S=1", 2, 1, 1024, 16, "float32", True),
             ("S=7 (1-step groups) x bf16", 2, 7, 1024, 16, "bfloat16",
              True),
             ("S=33 N=64", 2, 33, 1024, 64, "float32", True),
             ("ragged S=1000 D=8200 N=13", 1, 1000, 8200, 13, "float32",
              True),
             ("jamba train B=2 S=4096 D=8192 N=16 x bf16", 2, 4096, 8192,
              16, "bfloat16", False))
    tol, chunk = 2e-3, scan_kernel.CKPT_STEPS
    out = {"cases": []}
    for name, b, s, d, n, dt, state in cases:
        args = inputs(b, s, d, n, dt, state=state)[:7]
        x, delta, a, bm, cm, dd, h = args
        y, hf, ckpt = scan_kernel.scan(*args, ckpt=True)
        y0, hf0 = scan_kernel.scan(*args)
        torch.cuda.synchronize()
        same = torch.equal(y, y0) and torch.equal(hf, hf0)
        want = torch.empty_like(ckpt)
        for k in range(ckpt.shape[1]):
            want[:, k] = h
            sl = slice(k * chunk, (k + 1) * chunk)
            _, h = selective_scan_ref(
                x[:, sl].contiguous(), delta[:, sl].contiguous(), a,
                bm[:, sl].contiguous(), cm[:, sl].contiguous(), dd, h)
        scale = float(want.abs().max())
        err = float((ckpt - want).abs().max())
        ok = same and bool(torch.isfinite(ckpt).all()) and \
            err <= tol * scale
        res = {"case": name, "shape": {"B": b, "S": s, "D": d, "N": n},
               "x_dtype": dt, "max_abs_err": err, "h_max_abs": scale,
               "tol": tol, "same_y_and_h_final": same, "ok": ok}
        if s >= 4096:
            res["fwd_ms"] = cuda_ms(torch, lambda: scan_kernel.scan(*args),
                                    iters=5, graph=True)
            res["fwd_ckpt_ms"] = cuda_ms(
                torch, lambda: scan_kernel.scan(*args, ckpt=True), iters=5,
                graph=True)
            out["extra_ms"] = res["fwd_ckpt_ms"] - res["fwd_ms"]
        out["cases"].append(res)
        log(f"[3/8] selective_scan checkpoint mode {name}: B={b} S={s} "
            f"D={d} N={n}: {ckpt.shape[1]} checkpoints, max_abs_err {err:.3g}"
            f" (tol {tol} x max|h| {scale:.3g}); y and h_final as without "
            f"the mode: {same}" + (
                f"; forward {res['fwd_ms']:.4f} ms, in checkpoint mode "
                f"{res['fwd_ckpt_ms']:.4f} ms (+{out['extra_ms']:.4f})"
                if "fwd_ms" in res else ""))
        if not ok:
            raise AssertionError(f"the forward's checkpoints disagree with "
                                 f"the plain h on {name}: {res}")
        del args, x, delta, a, bm, cm, dd, h, y, hf, ckpt, y0, hf0, want
        torch.cuda.empty_cache()
    return out


def check_scan_bwd(torch) -> list:
    """The selective-scan backward kernel against
    ``selective_scan_bwd_ref`` on the same inputs and cotangents, every
    gradient within 2e-3 (x f32) or 2e-2 (x bf16: dy comes in bf16 and dx
    leaves rounded) of its own max |value|; timed (a direct call, which
    first makes the checkpoints with the forward's checkpoint mode) beside
    the plain version (a Python loop over S: at the training shape timed
    once).  At the training shape also: two calls give the same bits, the
    call with the forward's checkpoints given (what a training step runs)
    plus the checkpoint mode's extra time in the forward, and each CUDA
    kernel of a call timed apart under ``torch.profiler`` (the split).
    Logs how many of the walk's blocks an SM holds."""
    from repro_torch.kernels.selective_scan import kernel as scan_kernel
    from repro_torch.kernels.selective_scan import kernel_bwd as scanb_kernel
    from repro_torch.kernels.selective_scan.ref import selective_scan_bwd_ref
    from repro_torch.launch.profile_scan_bwd import CASES, inputs
    from repro_torch.launch.profile_wkv_bwd import kernel_split

    fits = {(n, dt): scanb_kernel.blocks_per_sm(n, dt) for n in (16, 64)
            for dt in (torch.float32, torch.bfloat16)}
    log("[3/8] selective_scan_bwd: the walk's blocks an SM: " + ", ".join(
        f"N {n} x {str(dt).replace('torch.', '')} {b_sm}"
        for (n, dt), b_sm in fits.items()))
    ckpt_check = check_scan_ckpt(torch)
    names = ("dx", "ddelta", "da", "db", "dc", "dd", "dh0")
    results = []
    for name, b, s, d, n, dtn, with_state, wide in CASES:
        dt = getattr(torch, dtn)
        tol = 2e-2 if dt == torch.bfloat16 else 2e-3
        args = inputs(b, s, d, n, dtn, state=with_state, wide=wide)
        x = args[0]
        grads = scanb_kernel.selective_scan_bwd(*args)
        torch.cuda.synchronize()
        refs = selective_scan_bwd_ref(*args)
        ok, errs, scales = hold_grads(torch, names, grads, refs, tol)
        del refs
        extra = {}
        if not results:
            again = scanb_kernel.selective_scan_bwd(*args)
            torch.cuda.synchronize()
            extra["same_bits"] = all(torch.equal(p, q)
                                     for p, q in zip(grads, again))
            del again
            _, _, ckpt = scan_kernel.scan(*args[:7], ckpt=True)
            given = scanb_kernel.selective_scan_bwd(*args, ckpt=ckpt)
            torch.cuda.synchronize()
            extra["same_bits_ckpt_given"] = all(
                torch.equal(p, q) for p, q in zip(grads, given))
            del given
            extra["ckpt_given_ms"] = cuda_ms(
                torch, lambda: scanb_kernel.selective_scan_bwd(
                    *args, ckpt=ckpt), iters=5, graph=True)
            extra["ckpt_extra_ms"] = ckpt_check["extra_ms"]
            extra["train_ms"] = (extra["ckpt_given_ms"]
                                 + extra["ckpt_extra_ms"])
            del ckpt
            extra["split_ms"] = kernel_split(
                lambda: scanb_kernel.selective_scan_bwd(*args))
            log(f"[3/8] selective_scan_bwd {name}: two calls give the same "
                f"bits: {extra['same_bits']} (and with the forward's "
                f"checkpoints given: {extra['same_bits_ckpt_given']}); with "
                f"them given {extra['ckpt_given_ms']:.4f} ms, + the "
                f"checkpoint mode's {extra['ckpt_extra_ms']:.4f} ms in the "
                f"forward = {extra['train_ms']:.4f} ms a training step pays;"
                f" kernels of one direct call: " + "; ".join(
                    f"{short_kernel_name(kname)} {kms:.4f} ms"
                    for kname, kms in extra["split_ms"].items()))
            ok = ok and extra["same_bits"] and extra["same_bits_ckpt_given"]
        del grads
        big = s * b * d > 2 ** 24
        direct_ms = cuda_ms(
            torch, lambda: scanb_kernel.selective_scan_bwd(*args),
            iters=5 if big else 20, graph=True)
        plain_ms = cuda_ms(torch, lambda: selective_scan_bwd_ref(*args),
                           iters=1 if big else 3, warmup=0 if big else 1)
        bound_ms, bound_by, nbytes, ops, exp_ms = scan_bwd_bound(torch, x, n)
        err = max(errs.values())
        b_sm = fits[(16 if n <= 16 else 64, dt)]
        results.append({
            "case": name, "shape": {"B": b, "S": s, "D": d, "N": n},
            "x_dtype": dtn, "h0_and_dh_final": with_state, "wide_a": wide,
            "max_abs_err": err, "errs": errs, "grad_max_abs": scales,
            "tol": tol, "ok": ok,
            # the main path's call: the forward's checkpoints given
            "ms": extra.get("ckpt_given_ms", direct_ms),
            "direct_ms": direct_ms, "plain_ms": plain_ms,
            "plain_iters": 1 if big else 3, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops, "sfu_exp_ms": exp_ms, "blocks_per_sm": b_sm,
            **extra})
        log(f"[3/8] selective_scan_bwd {name}: B={b} S={s} D={d} N={n}: "
            f"max_abs_err " + " ".join(f"{g} {errs[g]:.3g}" for g in names)
            + f" (tol {tol} x max|grad| " + " ".join(
                f"{scales[g]:.3g}" for g in names) + f"); kernel "
            f"{direct_ms:.4f} ms a direct call, plain {plain_ms:.1f} ms "
            f"({'1 call' if big else '3 calls'}), library none, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
            f"{ops / 1e9:.3f} Gop; the exponentials once on the SFUs "
            f"{exp_ms:.4f} ms)")
        if not ok:
            raise AssertionError(f"selective-scan backward kernel disagrees "
                                 f"with its plain version on {name}: {errs}, "
                                 f"max|grad| {scales}, {extra}")
        del args, x
        torch.cuda.empty_cache()
    results[0]["checkpoint_mode"] = ckpt_check
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
        log(f"[3/8] rwkv6_scan {name}: B={b} S={s} H={h} hd={hd}: "
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
        log(f"[3/8] selective_scan {name}: B={b} S={s} D={d} N={n}: "
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
    # MLA, the VLM frontend and the encoder-decoder; Mixtral cut to 20 of
    # its 32 layers (54.55 GiB of bf16 weights)
    ("deepseek_v2_236b dense bf16", "deepseek_v2_236b", "dense",
     ("flash_attention",), dict(requests=4, max_new=16, repeats=6)),
    ("phi_3_vision_4_2b dense bf16", "phi_3_vision_4_2b", "dense",
     ("flash_attention",), dict(requests=4, max_new=16)),
    ("seamless_m4t_large_v2 dense bf16", "seamless_m4t_large_v2", "dense",
     ("flash_attention",), dict(requests=4, max_new=16)),
    ("mixtral_8x7b dense bf16", "mixtral_8x7b", "dense",
     ("flash_attention",), dict(requests=4, max_new=16, repeats=20)),
)
# per kernel: the mixer whose layers launch it, and the passes that do
# (flash runs in prefill only; the others in every forward pass)
KERNEL_PATH = {"paged_attention_mixed": ("attn", "forward_passes"),
               "flash_attention": ("attn", "prefill_passes"),
               "rwkv6_scan": ("rwkv6", "forward_passes"),
               "selective_scan": ("mamba", "forward_passes")}


def launching_layers(cfg, kname: str) -> int:
    """Launches of ``kname`` per pass of its kind: one per layer of its
    mixer; flash also once per cross-attention block and per encoder
    layer of a prefill."""
    layers = cfg.layer_specs()
    n = sum(layer.mixer == KERNEL_PATH[kname][0] for layer in layers)
    if kname == "flash_attention":
        n += sum(layer.cross_attn for layer in layers)
        n += cfg.encoder.num_layers if cfg.encoder is not None else 0
    return n


def weight_bytes(cfg) -> int:
    """Bytes of the config's weights, by its plan."""
    import numpy as np
    from repro_torch.models.model import model_plan
    from repro_torch.models.params import plan_leaves, torch_dtype
    return sum(int(np.prod(p.shape)) * torch_dtype(p.dtype).itemsize
               for p in plan_leaves(model_plan(cfg)))


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
        weights = weight_bytes(cfg)
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
                             launching_layers(cfg, kname),
                             passes_key.split("_")[0])
        out.update(kernels=list(knames), launches=dict(
            (k, c[0]) for k, c in checks.items()), counts=counts,
            wall_s=wall, env=env, weight_bytes=weights)
        runs[tag] = out
        launched = ", ".join(
            f"{k} launches {n} ({p} {kind} passes x {lay} launching layers)"
            for k, (n, p, lay, kind) in checks.items())
        log(f"[4/8] serve {tag} full width ({out['layers']} layers, "
            f"weights {weights / 2**30:.2f} GiB"
            f"{', ' + str(env) if env else ''}): "
            f"completed {out['completed']}/{out['offered']}, {out['steps']} "
            f"steps, TTFT p50 {out['ttft_p50_ms']:.2f} ms p99 "
            f"{out['ttft_p99_ms']:.2f} ms, ITL p50 {out['itl_p50_ms']:.2f} "
            f"ms p99 {out['itl_p99_ms']:.2f} ms, {out['tokens_per_s']:.1f} "
            f"tokens/s, peak memory {out['peak_mem_bytes'] / 2**30:.2f} "
            f"GiB, logits_finite={out['logits_finite']}, {launched}, wall "
            f"{wall:.1f} s")
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
    from repro_torch.configs.base import get_config, reduced
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
        log(f"[5/8] engine parity, stablelm_3b full width x 2 layers, "
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
    log(f"[5/8] engine parity, rwkv6_1_6b full width x 2 layers, float32 "
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
    log(f"[5/8] engine parity, jamba_v0_1_52b full width, period cut to "
        f"(mamba+moe, attn+dense), float32 ({tf32}): dense kernel vs "
        f"plain, {sum(len(o) for o in jr[0])} tokens over "
        f"{len(PARITY_TRACE)} requests, {jk[2]['selective_scan']} scan and "
        f"{jk[2]['flash_attention']} flash launches, identical={same}")
    checks["jamba dense kernel vs plain"] = same
    out["jamba_v0_1_52b"] = {"identical": same, "tokens": jr[0]}
    # MLA, the VLM frontend and the encoder-decoder at their reduced
    # widths (flash at hd 32 + 16 with V padded, hd 64 with the patch
    # prefix, hd 64 non-causal in the encoder and over the frames)
    for seed, arch in enumerate(("deepseek_v2_236b", "phi_3_vision_4_2b",
                                 "seamless_m4t_large_v2"), start=4):
        cfg = reduced(get_config(arch)).replace(dtype="float32")
        params = Model(cfg, seed=seed, device="cuda").params
        rk = serve_trace(torch, cfg, params, "dense", "auto")
        rr = serve_trace(torch, cfg, params, "dense", "ref")
        del params
        same = rk[0] == rr[0]
        launched = (launched and rk[2]["flash_attention"] > 0
                    and not any(rr[2].values()))
        log(f"[5/8] engine parity, {arch} reduced, float32 ({tf32}): dense "
            f"kernel vs plain, {sum(len(o) for o in rr[0])} tokens over "
            f"{len(PARITY_TRACE)} requests, {rk[2]['flash_attention']} "
            f"flash launches, identical={same}")
        checks[f"{arch} reduced dense kernel vs plain"] = same
        out[f"{arch} reduced"] = {"identical": same, "tokens": rr[0]}
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
        log(f"[6/8] ({smi}) {tag} {name}: completed {o['completed']} / "
            f"offered {o['offered']} / shed {o['shed']} / rejected "
            f"{o['rejected']} {o['reject_reasons']} / expired "
            f"{o['expired']}, TTFT p50 {o['ttft_p50_ms']:.2f} ms p99 "
            f"{o['ttft_p99_ms']:.2f} ms, ITL p99 {o['itl_p99_ms']:.2f} ms, "
            f"{o['steps']} steps, measured compute {o['compute_s']:.3f} s, "
            f"logits_finite={o['logits_finite']}")
    log(f"[6/8] ({smi}) {tag} fleet: actions {out.get('actions')}, "
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
    log(f"[6/8] ({smi}) det_timing runs identical: {identical}; flash "
        f"launches over the dense runs {flash}, paged launches {paged}")
    for name, ok in checks.items():
        log(f"[6/8] check {name}: {ok}")
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
    log(f"[7/8] ({smi}) (a) failure domains, stablelm_3b full width bf16, "
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
    log(f"[7/8] ({smi}) (a) faults {faults['log']}, watchdog_fired "
        f"{faults['watchdog_fired']}, actuator {faults.get('actuator')}")
    for m in migs:
        log(f"[7/8] ({smi}) (a) migration t={m['t']:.3f} s {m['reason']} "
            f"r{m['from']}->r{m['to']}: {m['warm']} warm / {m['cold']} "
            f"cold, {m['pages']} pages ({m['attached_pages']} attached, "
            f"{m['copied_pages']} copied), {m['bytes']} bytes, modelled "
            f"transfer {m['transfer_s'] * 1e3:.3f} ms, verify failures "
            f"{m['verify_failures']}")
    log(f"[7/8] (a) Chrome trace: {len(trace['traceEvents'])} events in "
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
        log(f"[7/8] check {name}: {ok}")
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
    log(f"[7/8] (b) migration parity, stablelm_3b full width x 2 layers, "
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


# ------------------------------------------------------------------ phase 8
# full-width models trained on one card: bf16, remat, one synthetic batch
# of 2 x 4096 tokens (train_4k's length) memorised for 6 steps.
# StableLM-3B and RWKV-6 1.6B whole; Jamba at its published widths cut in
# depth to the first two layers of its period (Mamba + dense FFN, Mamba +
# MoE): its 51.6 B parameters do not fit one card.  RWKV-6 at lr 1e-4: its
# channel-mix runs on the residual stream without a norm (as the
# reference's, src/repro/models/model.py:216), so from random weights two
# Adam steps at 1e-3 (three at 3e-4) grow the stream past bf16's range,
# on the plain versions as on the kernels
TRAIN = dict(steps=6, batch=2, seq=4096, warmup=2, seed=0)
TRAIN_RUNS = (("stablelm_3b", None, 1e-3), ("rwkv6_1_6b", None, 1e-4),
              ("jamba_v0_1_52b", 2, 1e-3))
# the kernels a layer's mixer launches in a training step: its forward
# twice (remat reruns it in the backward) and its backward once
MIXER_KERNELS = {"attn": ("flash_attention", "flash_attention_bwd"),
                 "rwkv6": ("rwkv6_scan", "rwkv6_scan_bwd"),
                 "mamba": ("selective_scan", "selective_scan_bwd")}
PEAK_LIMIT_GIB = 75.0
# examples/train_small.py's twin on the card (launch.train's reduced branch)
TRAIN_SMALL = ["--arch", "jamba_v0_1_52b", "--steps", "200", "--batch", "8",
               "--seq", "64", "--lr", "1e-3", "--device", "cuda",
               "--expect-loss-drop"]


def leaf_paths(tree, prefix=()) -> list:
    """"/"-joined paths of a nested dict's leaves, in ``plan_leaves``
    order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], prefix + (k,))]
    return ["/".join(prefix)]


def expected_train_launches(cfg, steps: int) -> dict:
    """Every kernel's launches in ``steps`` remat training steps of
    ``cfg``: per layer of a mixer, its forward kernel twice a step and its
    backward kernel once; 0 for every other kernel."""
    want = {name: 0 for name in kernel_modules()}
    for layer in cfg.layer_specs():
        fwd, bwd = MIXER_KERNELS[layer.mixer]
        want[fwd] += 2 * steps
        want[bwd] += steps
    return want


def train_full(torch, smi: str, arch: str, period_layers, lr) -> dict:
    """One full-width training run through ``launch.train``: the loss
    falls, every leaf gets a finite nonzero gradient, the peak stays under
    75 GiB and every kernel launches exactly as the layers predict."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import train_full_width, with_period_layers
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    if period_layers is not None:
        cfg = with_period_layers(cfg, period_layers)
    zero_counts()
    t0 = time.perf_counter()
    res = train_full_width(arch, **TRAIN, lr=lr, device="cuda",
                           profile=True, period_layers=period_layers,
                           log=lambda m: log(f"[8/8] {m.strip()}"))
    wall = time.perf_counter() - t0
    counts = read_counts()
    steps = TRAIN["steps"]
    res.update(counts=counts, wall_s=wall, nvidia_smi=smi)
    peak = res["peak_mem_bytes"] / 2**30
    launched = {k: v for k, v in counts.items() if v}
    log(f"[8/8] train {res['arch']} full width ({res['layers']} layers"
        f"{'; ' + res['cut'] if res['cut'] else ''}; "
        f"{res['params'] / 1e9:.3f} B params, bf16, remat, batch "
        f"{TRAIN['batch']} x seq {TRAIN['seq']}, {steps} steps on one "
        f"batch, lr {lr:g}; {smi}): step ms "
        f"{[round(x, 1) for x in res['step_ms']]} "
        f"(the last under the profiler; of them AdamW "
        f"{[round(x, 1) for x in res['optimizer_ms']]}), "
        f"{res['tokens_per_s']:.0f} tokens/s "
        f"(steps 2-{steps - 1}), peak "
        f"{peak:.2f} GiB, grad norm "
        f"{[round(x, 4) for x in res['grad_norms']]}, losses "
        f"{[round(x, 4) for x in res['losses']]}, launches {launched}, "
        f"wall {wall:.1f} s")
    prof = res["profile"]
    log(f"[8/8] the last step under torch.profiler: device busy "
        f"{prof['device_busy_ms']:.1f} ms in {prof['kernels']} kernels, "
        f"idle share of an unprofiled step "
        f"{prof['idle_share_unprofiled']:.3f}; by family (ms, share of "
        f"busy): " + ", ".join(
            f"{k} {v:.1f} ({prof['by_family_share_of_busy'][k]:.3f})"
            for k, v in prof["by_family_ms"].items()))
    if res["bad_grad_leaves"]:
        raise AssertionError(f"leaves without a finite nonzero gradient: "
                             f"{res['bad_grad_leaves']}")
    if not res["losses"][-1] < res["losses"][0]:
        raise AssertionError(f"the loss did not fall: {res['losses']}")
    if peak >= PEAK_LIMIT_GIB:
        raise AssertionError(f"peak {peak:.2f} GiB over {PEAK_LIMIT_GIB}")
    want = expected_train_launches(cfg, steps)
    if counts != want:
        raise AssertionError(f"launches {counts}, expected {want}")
    return res


def train_lockstep(torch, arch: str) -> dict:
    """Reduced ``arch`` in float32 (TF32 off) trained 3 steps on the
    kernels, each step's loss and every leaf's gradient held to the plain
    versions' on the same weights and batch (loss 1e-5 relative, each
    leaf 1e-4 of its own max |grad|).  The two paths are compared in
    lockstep, on the kernel run's weights at every step: Adam's
    g / (|g| + eps) turns a rounding difference in a near-zero gradient
    into a full-size update, so two separate runs drift apart by more
    than the kernels differ."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.model import Model, train_loss
    from repro_torch.models.params import map_plan, plan_leaves
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import SyntheticTokenPipeline
    from repro_torch.training.trainer import (batch_to_torch, grads_of,
                                              trainable)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reduced(get_config(arch)).replace(dtype="float32")
    params = trainable(map_plan(lambda t: t.float(), Model(
        cfg, seed=8, device="cuda").params), "cuda")
    pipe = SyntheticTokenPipeline(cfg.vocab_size, 2, 96, seed=8)
    batch = batch_to_torch(next(pipe), "cuda")
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    state = opt.init_state(params)
    paths = leaf_paths(params)
    losses, loss_err, grad_err, worst = [], 0.0, 0.0, None
    counts = {}
    for _ in range(3):
        step = {}
        for impl in ("ref", "auto"):
            zero_counts()
            loss = train_loss(params, cfg, batch, remat=True, impl=impl)
            step[impl] = (float(loss.detach()), grads_of(loss, params))
            torch.cuda.synchronize()
            counts[impl] = read_counts()
        (kl, kg), (rl, rg) = step["auto"], step["ref"]
        losses.append((kl, rl))
        loss_err = max(loss_err, abs(kl - rl) / abs(rl))
        # each leaf's gradient against its own max |value|
        for path, a, b in zip(paths, plan_leaves(kg), plan_leaves(rg)):
            diff, top = float((a - b).abs().max()), float(b.abs().max())
            rel = diff / top if top else (0.0 if diff == 0 else math.inf)
            if not rel <= grad_err:
                grad_err, worst = rel, path
        params, state, _ = opt.apply_updates(ocfg, params, kg, state)
        del step, kg, rg
    ok = loss_err <= 1e-5 and grad_err <= 1e-4
    kc, rc = counts["auto"], counts["ref"]
    want = expected_train_launches(cfg, 1)
    launched = {k: v for k, v in kc.items() if v}
    log(f"[8/8] train {cfg.name} float32 on the card, 3 steps on the "
        f"kernels, each step's loss and gradients against the plain "
        f"versions' on the same weights: losses (kernel, plain) "
        f"{[(round(a, 6), round(b, 6)) for a, b in losses]}, max rel diff "
        f"{loss_err:.2e} (tol 1e-5); every leaf's gradient max diff / "
        f"its max|grad| {grad_err:.2e} (tol 1e-4; at {worst}); launches a "
        f"step {launched} (plain path: {sum(rc.values())})")
    if not ok:
        raise AssertionError(f"reduced float32 training of {arch}: kernels "
                             f"and plain versions disagree")
    # a step launches each layer's kernels (forward once, remat again,
    # backward once); the plain path none
    if kc != want:
        raise AssertionError(f"kernel run launches {kc}, expected {want}")
    if any(rc.values()):
        raise AssertionError(f"the plain run launched kernels: {rc}")
    if losses[-1][0] >= losses[0][0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    return {"losses": losses, "loss_rel_err": loss_err,
            "grad_rel_err": grad_err, "grad_worst_leaf": worst,
            "counts_kernel": kc, "counts_plain": rc, "ok": ok}


def training(torch, smi: str) -> dict:
    """(a) full-width StableLM-3B, (c) full-width RWKV-6 1.6B and (d) the
    Jamba cut trained through ``launch.train``; (b) and (e) reduced
    float32 StableLM, RWKV-6 and Jamba trained on the kernels and on the
    plain versions from the same weights and batch; (f)
    ``examples/train_small.py``'s twin on the card."""
    from repro_torch.launch.train import main as train_main
    out = {"full_width": {}, "reduced_f32": {}}
    for arch, period_layers, lr in TRAIN_RUNS:
        out["full_width"][arch] = train_full(torch, smi, arch, period_layers,
                                             lr)
    gc.collect()
    torch.cuda.empty_cache()
    for arch in ("stablelm_3b", "rwkv6_1_6b", "jamba_v0_1_52b"):
        out["reduced_f32"][arch] = train_lockstep(torch, arch)
    zero_counts()
    t0 = time.perf_counter()
    res = train_main(TRAIN_SMALL)
    counts = read_counts()
    out["train_small"] = {"losses": res.losses, "counts": counts,
                          "wall_s": time.perf_counter() - t0}
    log(f"[8/8] examples/train_small.py's twin (launch.train "
        f"{' '.join(TRAIN_SMALL)}): loss {res.losses[0]:.4f} -> "
        f"{res.losses[-1]:.4f} in {len(res.losses)} steps, "
        f"{out['train_small']['wall_s']:.1f} s, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if not (counts["selective_scan"] and counts["selective_scan_bwd"]):
        raise AssertionError(f"the twin did not run the scan kernels: "
                             f"{counts}")
    return out


# ------------------------------------------------------------------ phase 9
# the launch layer's steps (launch/steps.py::build_step) on a live
# DeviceMesh of this one card: world size 1 over NCCL, so nothing is
# gathered or summed and the steps must give the direct calls' bits
SHARDED = dict(arch="stablelm_3b", train_steps=2, prompt=1024, decodes=4,
               cap=1088)
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# benchmarks/hillclimb.py's three pairs and StableLM-3B's train_4k: the
# dry run under make_policy(..., seq_parallel=True) beside the default
SEQ_PARALLEL_PAIRS = (("stablelm_3b", "train_4k"),
                      ("deepseek_v2_236b", "train_4k"),
                      ("mixtral_8x7b", "prefill_32k"),
                      ("jamba_v0_1_52b", "train_4k"))


def dry_runs() -> dict:
    """The plan-level dry run of every config x input shape x production
    mesh: one line a config with its analytic per-device estimates."""
    from repro_torch.configs.base import ARCH_IDS
    from repro_torch.launch.dryrun import dryrun
    out = {}
    t0 = time.perf_counter()
    for arch in tuple(ARCH_IDS) + ("olmo2_7b",):
        cells = []
        for shape in DRYRUN_SHAPES:
            for multi_pod in (False, True):
                res = dryrun(arch, shape, multi_pod=multi_pod, verbose=False)
                key = f"{shape}/{512 if multi_pod else 256}"
                if res is None:
                    cells.append(f"{key} skipped")
                    continue
                gib = res["analytic_memory"]["total"] / 2**30
                comm = sum(res["collective_bytes_per_device"].values())
                out[f"{arch}/{key}"] = res
                cells.append(f"{key} {gib:.2f} (collectives "
                             f"{comm / 2**30:.3f})")
        log(f"[9/9] dry run {arch} (analytic per-device GiB for the H100, "
            f"from the plans, not measured, and in brackets the GiB a "
            f"device passes to collectives in one step, by "
            f"launch/collectives.py's ring rules; shape/chips): "
            + ", ".join(cells))
    log(f"[9/9] dry run: {len(out)} steps built on meta tensors and checked "
        f"in {time.perf_counter() - t0:.1f} s")
    from repro_torch.configs.base import INPUT_SHAPES, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shardings import make_policy
    for arch, shape in SEQ_PARALLEL_PAIRS:
        policy = make_policy(get_config(arch), INPUT_SHAPES[shape],
                             make_production_mesh(), seq_parallel=True)
        sp = dryrun(arch, shape, verbose=False, policy_override=policy)
        out[f"{arch}/{shape}/256/seq_parallel"] = sp
        cells = []
        for tag, res in (("default", out[f"{arch}/{shape}/256"]),
                         ("seq_parallel", sp)):
            comm = res["collective_bytes_per_device"]
            cells.append(
                f"{tag}: memory {res['analytic_memory']['total'] / 2**30:.2f}"
                f", all-gather {comm['all_gather'] / 2**30:.3f}, "
                f"reduce-scatter {comm['reduce_scatter'] / 2**30:.3f}, "
                f"all-reduce {comm['all_reduce'] / 2**30:.3f}, total "
                f"{sum(comm.values()) / 2**30:.3f}")
        log(f"[9/9] dry run {arch} {shape} on 256 chips (analytic GiB a "
            f"device, not measured): " + "; ".join(cells))
    return out


def sharded_steps(torch, smi: str, phase8_losses) -> dict:
    """(1) the dry run; (2) an NCCL process group of one rank and its 1 x 1
    mesh; (3) full-width StableLM-3B trained through ``build_step``'s
    train step for 2 steps on phase 8 (a)'s seed, weights and batch: its
    losses must be phase 8 (a)'s first two, bit for bit; (4) a prefill and
    4 decode steps through ``build_step`` at batch 2, prompt 1024, on the
    same weights: the tokens must be the direct calls'; (e) the train
    steps under ``seq_parallel``; (f) both engines under the policy; (h)
    the dense engine under the 1 x 1 x 1 pod mesh's policy; (i), (j)
    Granite-3-8B paged under the policy, its lanes migrated, and paged
    attention at its per-rank shapes; (k) the train step on the pod mesh
    (phase 8 (a)'s losses) and a batch-1 ``long_500k`` serve step of
    StarCoder2-7B (``decode_step``'s logits); (5) teardown."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import make_device_mesh, make_local_mesh
    from repro_torch.models import partition
    t0 = time.perf_counter()
    out = {"dryrun": dry_runs()}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(SHARDED["arch"])
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            mesh = make_local_mesh("cuda")
            log(f"[9/9] process group nccl, world 1; mesh "
                f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
            collectives.reset_tally()
            partition.reset_gathered()
            out["train"], params, tokens = _sharded_train(
                torch, smi, cfg, mesh, phase8_losses)
            out["decode"] = _sharded_decode(torch, cfg, mesh, params, tokens)
            del params, tokens
            gc.collect()
            torch.cuda.empty_cache()
            out["seq_parallel"] = _sharded_train(
                torch, smi, cfg, mesh, out["train"]["losses"],
                seq_parallel=True)[0]
            gc.collect()
            torch.cuda.empty_cache()
            pod_mesh = make_device_mesh((1, 1, 1), ("pod", "data", "model"),
                                        "cuda")
            out["engines"] = _sharded_engines(torch, smi, cfg, mesh, pod_mesh)
            gc.collect()
            torch.cuda.empty_cache()
            out["granite"] = _granite_paged(torch, smi, mesh)
            gc.collect()
            torch.cuda.empty_cache()
            out["pod_train"] = _sharded_train(
                torch, smi, cfg, pod_mesh, phase8_losses,
                label="(k) on the 1 x 1 x 1 (pod, data, model) mesh: ")[0]
            gc.collect()
            torch.cuda.empty_cache()
            out["long_decode"] = _long_decode(torch, smi, mesh)
            out["collective_bytes"] = collectives.read_tally()
            out["gathered"] = partition.read_gathered()
        finally:
            dist.destroy_process_group()
    log(f"[9/9] build_step's collective tally over the train, prefill and "
        f"serve steps, the seq_parallel train steps, the engines under the "
        f"policy, the lanes migrated and the pod-mesh and batch-1 steps at "
        f"world size 1: {out['collective_bytes']} bytes; "
        f"peak memory {out['train']['peak_gib']:.2f} GiB ({smi}); gathered "
        f"parameters alive at once: peak {out['gathered']['peak']} bytes, "
        f"largest gather {out['gathered']['largest']} bytes (a 1 x 1 mesh "
        f"stores every leaf whole, so nothing is gathered)")
    if any(out["collective_bytes"].values()):
        raise AssertionError(f"world size 1 passed "
                             f"{out['collective_bytes']} bytes to "
                             f"collectives: every group there has one rank")
    gc.collect()
    torch.cuda.empty_cache()
    out["per_rank"] = per_rank_kernels(torch, smi)
    out["wall_s"] = time.perf_counter() - t0
    log(f"[9/9] phase 9 took {out['wall_s']:.1f} s")
    return out


def _sharded_train(torch, smi, cfg, mesh, phase8_losses,
                   seq_parallel: bool = False, label: str = "") -> tuple:
    """(result, the trained weights, the batch's tokens).  With
    ``seq_parallel`` the step follows ``make_policy(..., seq_parallel=
    True)`` (``build_step``'s override), and ``phase8_losses`` are (a)'s
    build_step losses; ``label`` leads the log line."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.shardings import make_policy, shard_tree
    from repro_torch.launch.specs import batch_plan
    from repro_torch.launch.steps import build_step
    from repro_torch.models.model import Model, model_plan
    from repro_torch.models.params import pspecs_from_plan
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import SyntheticTokenPipeline
    from repro_torch.training.trainer import batch_to_torch
    shape = InputShape("train_2x4096", TRAIN["seq"], TRAIN["batch"], "train")
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=TRAIN["warmup"],
                           total_steps=TRAIN["steps"])
    override = (make_policy(cfg, shape, mesh, seq_parallel=True)
                if seq_parallel else None)
    step, *_ = build_step(cfg, shape, mesh, ocfg=ocfg,
                          policy_override=override)
    # phase 8 (a)'s batch and weights (launch/train.py::train_full_width)
    pipe = SyntheticTokenPipeline(cfg.vocab_size, TRAIN["batch"],
                                  TRAIN["seq"], seed=TRAIN["seed"])
    data = batch_to_torch(next(pipe), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(TRAIN["seed"])
    params = Model(cfg, generator=gen, device="cuda").params
    local = shard_tree(params, pspecs_from_plan(model_plan(cfg), mesh), mesh)
    rows = shard_tree(data, pspecs_from_plan(batch_plan(cfg, shape, mesh),
                                             mesh), mesh)
    state = opt.init_state(local)
    zero_counts()
    losses, step_ms = [], []
    for _ in range(SHARDED["train_steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        local, state, aux = step(local, state, rows)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(aux["loss"]))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = phase8_losses[:SHARDED["train_steps"]]
    layers = len(cfg.layer_specs())
    n = SHARDED["train_steps"]
    what = ("(e) under seq_parallel, against (a)'s" if seq_parallel
            else "against phase 8 (a)'s")
    log(f"[9/9] {label}build_step train {cfg.name} full width (bf16, remat, "
        f"batch {TRAIN['batch']} x seq {TRAIN['seq']}, {n} steps, phase 8 (a)'s "
        f"seed, weights and batch; {smi}): step ms "
        f"{[round(x, 1) for x in step_ms]}, peak {peak:.2f} GiB, losses "
        f"{losses} {what} {want} "
        f"(differences {[a - b for a, b in zip(losses, want)]}), launches "
        f"flash_attention {counts['flash_attention']}, flash_attention_bwd "
        f"{counts['flash_attention_bwd']}")
    if losses != want:
        raise AssertionError(f"build_step's losses {losses} are not {want} "
                             f"({what}): at world size 1 nothing is "
                             f"gathered or summed, so the step must be the "
                             f"direct step's arithmetic")
    if (counts["flash_attention"], counts["flash_attention_bwd"]) != (
            2 * n * layers, n * layers):
        raise AssertionError(f"launches {counts}, expected flash "
                             f"{2 * n * layers} and its backward {n * layers}")
    del state, aux
    return ({"losses": losses, "phase8_losses": want, "step_ms": step_ms,
             "peak_gib": peak, "counts": counts, "nvidia_smi": smi},
            local, data["tokens"])


def _sharded_decode(torch, cfg, mesh, params, tokens) -> dict:
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.steps import build_step
    from repro_torch.models.model import decode_step, prefill
    b, cap = tokens.shape[0], SHARDED["cap"]
    prompt = tokens[:, :SHARDED["prompt"]].contiguous()
    pre, *_ = build_step(cfg, InputShape("prefill", cap, b, "prefill"), mesh)
    serve, *_ = build_step(cfg, InputShape("decode", cap, b, "decode"), mesh)

    def positions(i):
        return torch.full((b,), SHARDED["prompt"] + i, dtype=torch.int32,
                          device="cuda")

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = pre(params, {"tokens": prompt})
    steps = [logits.argmax(-1).to(torch.int32)]
    for i in range(SHARDED["decodes"]):
        logits, cache = serve(params, cache, steps[-1], positions(i))
        steps.append(logits.argmax(-1).to(torch.int32))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    del cache
    logits, cache = prefill(params, cfg, prompt, seq_cap=cap)
    direct = [logits.argmax(-1).to(torch.int32)]
    for i in range(SHARDED["decodes"]):
        logits = decode_step(params, cfg, cache, direct[-1], positions(i))
        direct.append(logits.argmax(-1).to(torch.int32))
    same = all(torch.equal(a, c) for a, c in zip(steps, direct))
    toks = [t.tolist() for t in steps]
    log(f"[9/9] build_step prefill (batch {b}, prompt {SHARDED['prompt']}, "
        f"cache {cap}) + {SHARDED['decodes']} serve steps on the trained "
        f"weights: tokens {toks}, the direct prefill/decode_step calls' "
        f"{[t.tolist() for t in direct]}: identical {same}; "
        f"{wall_ms:.1f} ms, launches flash_attention "
        f"{counts['flash_attention']}")
    if not same:
        raise AssertionError("build_step's prefill/serve tokens are not the "
                             "direct calls'")
    if counts["flash_attention"] != len(cfg.layer_specs()):
        raise AssertionError(f"prefill launched flash "
                             f"{counts['flash_attention']} times")
    return {"tokens": toks, "identical": same, "wall_ms": wall_ms,
            "counts": counts}


# (f): the engines under a policy on the 1 x 1 mesh, beside the unsharded
# engines on the same weights and prompts
ENGINE_PROMPTS = dict(lens=(300, 64, 1000, 17), max_new=16, slots=4,
                      seq_cap=2048)


def engine_requests(cfg, lens=None):
    """ENGINE_PROMPTS' requests, their prompts drawn from seed 5."""
    import numpy as np
    from repro_torch.serving.request import Request
    e = ENGINE_PROMPTS
    rng = np.random.default_rng(5)
    return [Request(req_id=i, tenant="T1", prompt_len=n,
                    max_new_tokens=e["max_new"], arrival=0.0,
                    prompt_tokens=rng.integers(0, cfg.vocab_size, n))
            for i, n in enumerate(lens or e["lens"])]


def serve_engine(torch, eng, reqs, kname, passes, layers, what) -> dict:
    """Serve ``reqs`` on ``eng`` to the end: tokens, steps, passes, the
    launches of ``kname`` (which must be passes x layers) and the
    host-clock wall of the run."""
    for r in reqs:
        if not eng.submit(r):
            raise AssertionError(f"{what} refused {r}")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while eng.has_work():
        eng.finalize_step(eng.step(), float(steps))
        steps += 1
    torch.cuda.synchronize()
    run = {"tokens": [list(r.output_tokens) for r in reqs], "steps": steps,
           "passes": getattr(eng, passes), "launches": read_counts()[kname],
           "wall_ms": (time.perf_counter() - t0) * 1e3}
    want = run["passes"] * layers
    if run["launches"] == 0 or run["launches"] != want:
        raise AssertionError(f"{what} launched {kname} {run['launches']} "
                             f"times, expected {want}")
    return run


def _sharded_engines(torch, smi, cfg, mesh, pod_mesh) -> dict:
    """Full-width StableLM-3B (bf16, random weights from seed 0) served
    dense and paged by ``ServingEngine`` with and without ``policy=
    make_policy(<decode shape>), mesh=mesh``, in turns (unsharded,
    policy, policy, unsharded), and (h) dense under the decode policy of
    the 1 x 1 x 1 ``pod_mesh`` (the slots' owner and the logits' gather
    over the batch axes, at extent 1; its tally must be 0 bytes): every
    run must give the first run's tokens, and launch the kernel of its
    path (flash in each dense prefill, paged attention in each fused
    step) once a pass and layer.  The walls are host-clock times of the
    whole run."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import collectives
    from repro_torch.launch.shardings import make_policy
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine
    e = ENGINE_PROMPTS
    params = Model(cfg, seed=0, device="cuda").params
    shape = InputShape("serve", e["seq_cap"], e["slots"], "decode")
    meshes = {"policy": mesh, "pod": pod_mesh}
    layers = len(cfg.layer_specs())
    out = {}
    for backend, kname, passes, tags in (
            ("dense", "flash_attention", "prefill_passes",
             ("unsharded", "policy", "policy", "unsharded", "pod")),
            ("paged", "paged_attention_mixed", "forward_passes",
             ("unsharded", "policy", "policy", "unsharded"))):
        runs = []
        for tag in tags:
            kw = {}
            if tag in meshes:
                kw = dict(policy=make_policy(cfg, shape, meshes[tag]),
                          mesh=meshes[tag])
            eng = ServingEngine(cfg, params, max_slots=e["slots"],
                                seq_cap=e["seq_cap"], backend=backend,
                                device="cuda", **kw)
            before = sum(collectives.read_tally().values())
            run = serve_engine(torch, eng, engine_requests(cfg), kname,
                               passes, layers, f"{backend} engine ({tag})")
            run.update(tag=tag, tally=sum(collectives.read_tally().values())
                       - before)
            runs.append(run)
            del eng
            if run["tokens"] != runs[0]["tokens"]:
                raise AssertionError(f"{backend} engine ({tag}) gave "
                                     f"{run['tokens']}, the first run "
                                     f"{runs[0]['tokens']}")
        walls = {tag: [round(r["wall_ms"], 1) for r in runs
                       if r["tag"] == tag] for tag in ("unsharded", "policy")}
        log(f"[9/9] (f) {cfg.name} {backend} full width (bf16, prompts "
            f"{list(e['lens'])}, {e['max_new']} new tokens each), in turns "
            f"unsharded / under policy= on the 1 x 1 mesh: "
            f"{runs[1]['steps']} steps, walls ms {walls} ({smi}); every "
            f"run the first run's tokens; {kname} launches "
            f"{runs[1]['launches']} a run ({runs[1]['passes']} passes x "
            f"{layers} layers); first request's tokens "
            f"{runs[1]['tokens'][0]}")
        out[backend] = runs
    pod = out["dense"][-1]
    log(f"[9/9] (h) {cfg.name} dense full width under the decode policy of "
        f"the 1 x 1 x 1 (pod, data, model) mesh: the unsharded run's "
        f"tokens, {pod['steps']} steps, {pod['wall_ms']:.1f} ms ({smi}), "
        f"flash launches {pod['launches']}, collective tally {pod['tally']} "
        f"bytes")
    if pod["tally"]:
        raise AssertionError(f"the pod mesh's engine passed {pod['tally']} "
                             f"bytes to collectives at extent 1")
    del params
    return out


# (i), (j): Granite-3-8B paged under the policy, its lanes migrated, and
# paged attention at the per-rank shapes of a `model` axis of 4 and 16
# (32 query heads over 8 KV heads: 8 over 2, 2 over 1; hd 128)
GRANITE = dict(arch="granite_3_8b", migrate_at=6, heads=32, kv=8, hd=128,
               model_axes=(1, 4, 16), pool_axes=(1, 4, 8, 16))


def _granite_paged(torch, smi, mesh) -> dict:
    """(i) full-width Granite-3-8B (bf16, seed 0) served paged unsharded
    and under the policy on the 1 x 1 mesh: the same tokens, paged
    attention once a pass and layer; then paged attention at the per-rank
    shapes of GRANITE's model axes, each against its plain version
    (2e-2) and timed by CUDA graph beside the whole shape.  (j) the
    policy engine's lanes exported after ``migrate_at`` steps and
    imported into an unsharded engine: the unmigrated run's tokens."""
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_mixed_ref)
    from repro_torch.launch.shardings import make_policy
    from repro_torch.models.model import Model
    from repro_torch.models.params import torch_dtype
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.migrate import PageImporter
    from repro_torch.serving.paged_runtime import held_kv_heads
    e, g = ENGINE_PROMPTS, GRANITE
    cfg = get_config(g["arch"])
    layers = len(cfg.layer_specs())
    params = Model(cfg, seed=0, device="cuda").params
    weights_gib = weight_bytes(cfg) / 2**30
    policy = make_policy(cfg, InputShape("serve", e["seq_cap"], e["slots"],
                                         "decode"), mesh)

    def engine(**kw):
        return ServingEngine(cfg, params, max_slots=e["slots"],
                             seq_cap=e["seq_cap"], backend="paged",
                             device="cuda", **kw)

    runs = {}
    for tag, kw in (("unsharded", {}),
                    ("policy", dict(policy=policy, mesh=mesh))):
        runs[tag] = serve_engine(torch, engine(**kw), engine_requests(cfg),
                                 "paged_attention_mixed", "forward_passes",
                                 layers, f"granite paged ({tag})")
    if runs["policy"]["tokens"] != runs["unsharded"]["tokens"]:
        raise AssertionError(f"granite paged under the policy gave "
                             f"{runs['policy']['tokens']}, unsharded "
                             f"{runs['unsharded']['tokens']}")
    # the bytes a rank's pools hold (the runtime's plan: every layer's K
    # and V pages of its held KV heads, the trash page included)
    eng = engine()
    pages, page = eng.runtime.pool_pages + 1, eng.runtime.page
    del eng
    itemsize = torch_dtype(cfg.dtype).itemsize
    pool_bytes = {m: layers * 2 * pages * page * len(held_kv_heads(
        cfg, m, 0)) * cfg.attn.head_dim * itemsize for m in g["pool_axes"]}
    log(f"[9/9] (i) {cfg.name}'s page pools a rank holds at this engine's "
        f"{pages} pages of {page} tokens (the plan's bytes, not measured): "
        + ", ".join(f"model {m}: {b} bytes ({b / 2**30:.4f} GiB, "
                    f"{b // (pages * page)} a token)"
                    for m, b in pool_bytes.items()))
    log(f"[9/9] (i) {cfg.name} paged full width ({weights_gib:.2f} GiB of "
        f"bf16 weights; prompts {list(e['lens'])}, {e['max_new']} new "
        f"tokens each) unsharded and under the policy on the 1 x 1 mesh: the "
        f"same tokens, {runs['policy']['steps']} steps, paged launches "
        f"{runs['policy']['launches']} ({runs['policy']['passes']} passes x "
        f"{layers} layers), walls ms {runs['unsharded']['wall_ms']:.1f} / "
        f"{runs['policy']['wall_ms']:.1f} ({smi}); first request's tokens "
        f"{runs['policy']['tokens'][0]}")

    # (j): lanes exported from the policy runtime, imported unsharded
    src, dst = engine(policy=policy, mesh=mesh), engine()
    reqs = engine_requests(cfg)
    for r in reqs:
        if not src.submit(r):
            raise AssertionError(f"request {r.req_id} refused")
    for i in range(g["migrate_at"]):
        src.finalize_step(src.step(), float(i))
    mans = src.drain_requests(ship_state=True)
    importer = PageImporter(dst.runtime)
    for man in mans:
        if not importer.import_lane(man) and not dst.submit(man.req):
            raise AssertionError(f"request {man.req.req_id} refused")
    steps = g["migrate_at"]
    while dst.has_work():
        dst.finalize_step(dst.step(), float(steps))
        steps += 1
    tokens = [list(r.output_tokens) for r in reqs]
    warm = sum(m.warm for m in mans)
    migrated = {"warm": warm, "lanes": len(mans),
                "pages": sum(len(m.pages) for m in mans),
                "bytes": sum(m.total_bytes for m in mans),
                "verify_failures": importer.verify_failures,
                "identical": tokens == runs["unsharded"]["tokens"]}
    del src, dst
    log(f"[9/9] (j) {cfg.name} paged lanes exported from the policy runtime "
        f"after {g['migrate_at']} steps and imported unsharded: {warm} of "
        f"{len(mans)} lanes warm, {migrated['pages']} pages "
        f"({migrated['bytes']} bytes), verify failures "
        f"{importer.verify_failures}, the unmigrated run's tokens "
        f"{migrated['identical']}")
    if not migrated["identical"] or importer.verify_failures or warm < 1:
        raise AssertionError(f"the migrated Granite lanes: {migrated}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # paged attention on a rank's heads of Granite-3-8B
    kernels = []
    for m in g["model_axes"]:
        heads, kv = g["heads"] // m, len(held_kv_heads(cfg, m, 0))
        x = main_path_step(torch, heads=heads, kv=kv, hd=g["hd"],
                           layout="lane")
        args = (x["q"].to(torch.bfloat16), x["k"].to(torch.bfloat16),
                x["v"].to(torch.bfloat16), x["bt"], x["qpos"])
        got = pa_kernel.paged_attention_mixed(*args)
        torch.cuda.synchronize()
        ref = paged_attention_mixed_ref(*args)
        err = float((got.float() - ref.float()).abs().max())
        ok = bool(torch.allclose(got.float(), ref.float(), rtol=2e-2,
                                 atol=2e-2))
        case = {"model": m, "H": heads, "KV": kv, "hd": g["hd"],
                "L": args[0].shape[0], "Q": args[0].shape[1], "ok": ok,
                "max_abs_err": err,
                "ms": kernel_ms(torch, lambda: pa_kernel.paged_attention_mixed(
                    *args))[0],
                "plain_ms": cuda_ms(torch, lambda: paged_attention_mixed_ref(
                    *args), iters=5), "nvidia_smi": smi}
        kernels.append(case)
        del x, args, got, ref
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"paged attention at {case} disagrees with "
                                 f"its plain version: {err}")
    log(f"[9/9] (i) paged_attention_mixed at {cfg.name}'s per-rank shapes "
        f"(one fused step's lane-major call, bf16, hd {g['hd']}; ms by CUDA "
        f"graph, {smi}): " + "; ".join(
            f"model {c['model']}: {c['H']} over {c['KV']} heads "
            f"{c['ms']:.4f} ms (plain {c['plain_ms']:.4f}, error "
            f"{c['max_abs_err']:.3g})" for c in kernels))
    return {"runs": runs, "migrated": migrated, "kernels": kernels,
            "weights_gib": weights_gib, "pool_bytes": pool_bytes}


# (k): a batch-1 decode step of long_500k for full-width StarCoder2-7B, its
# 4096-token window as the cache, at this position
LONG = dict(arch="starcoder2_7b", shape="long_500k", position=500_000,
            seed=3)


def _long_decode(torch, smi, mesh) -> dict:
    """``build_step``'s serve step of ``long_500k`` (batch 1) for
    full-width StarCoder2-7B (bf16, seed 0) against ``decode_step`` on
    the same cache and position: the logits bit for bit.  The cache is
    the window's ring (``positions % window``) filled with random K/V
    and the positions of the window's tokens before ``position``."""
    from repro_torch.configs.base import INPUT_SHAPES, get_config
    from repro_torch.launch.shardings import shard_tree
    from repro_torch.launch.specs import decode_arg_plans
    from repro_torch.launch.steps import build_step
    from repro_torch.models.model import Model, decode_step, model_plan
    from repro_torch.models.params import (map_plan, plan_leaves,
                                           pspecs_from_plan)
    cfg = get_config(LONG["arch"])
    shape = INPUT_SHAPES[LONG["shape"]]
    params = Model(cfg, seed=0, device="cuda").params
    cplan = decode_arg_plans(cfg, shape, mesh)[0]
    gen = torch.Generator(device="cuda").manual_seed(LONG["seed"])
    pos0 = LONG["position"]

    def leaf(p):
        if p.dtype == "int32":            # the ring's positions
            cap = p.shape[-1]
            slots = torch.arange(cap, device="cuda")
            held = pos0 - 1 - (pos0 - 1 - slots) % cap
            return held.to(torch.int32).expand(p.shape).contiguous()
        return torch.randn(p.shape, generator=gen, device="cuda").to(
            getattr(torch, p.dtype))
    cache = map_plan(leaf, cplan)
    cache_gib = sum(t.numel() * t.element_size()
                    for t in plan_leaves(cache)) / 2**30
    local = shard_tree(map_plan(torch.clone, cache),
                       pspecs_from_plan(cplan, mesh), mesh)
    p_local = shard_tree(params, pspecs_from_plan(model_plan(cfg), mesh),
                         mesh)
    serve, *_ = build_step(cfg, shape, mesh)
    token = torch.tensor([17], dtype=torch.int32, device="cuda")
    pos = torch.tensor([pos0], dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, _ = serve(p_local, local, token, pos)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    want = decode_step(params, cfg, cache, token, pos)
    same = bool(torch.equal(got, want))
    diff = float((got - want).abs().max())
    log(f"[9/9] (k) build_step serve of {shape.name} (batch 1) for {cfg.name} "
        f"full width at position {pos0} (cache {cache_gib:.3f} GiB: the "
        f"{cplan['period']['sub0']['self']['k'].shape[2]}-token window): "
        f"logits {tuple(got.shape)} equal decode_step's bit for bit {same} "
        f"(max difference {diff}), finite {bool(torch.isfinite(got).all())}"
        f", {step_ms:.1f} ms ({smi})")
    if not same:
        raise AssertionError(f"the batch-1 serve step's logits differ from "
                             f"decode_step's by {diff}")
    del params, p_local, cache, local
    return {"identical": same, "max_diff": diff, "cache_gib": cache_gib,
            "step_ms": step_ms}


# a 4-way `model` axis: the sharded path's kernel shapes on one rank, at
# train_4k's sequence
PER_RANK = dict(model=4, seq=4096)


def per_rank_kernels(torch, smi: str) -> list:
    """Each kernel a sharded step launches, at the per-rank shape a 4-way
    ``model`` axis gives it, against its plain version with phase 3's
    tolerances and timed beside it (CUDA events; the kernel's from a
    graph's replays, the plain version's eager): flash's forward and
    backward (bf16, 2e-2), the WKV's (f32; y and state 1e-4, gradients
    2e-3 of their max |value|), the selective scan's forward in its
    checkpoint mode (bf16 x: y 1e-2, state 1e-4, checkpoints 2e-3 of the
    plain h's max) and its backward with those checkpoints (2e-2)."""
    import numpy as np
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import kernel_bwd as fab_kernel
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6_scan import kernel_bwd as wkvb_kernel
    from repro_torch.kernels.rwkv6_scan.ref import (rwkv6_scan_bwd_ref,
                                                    rwkv6_scan_ref)
    from repro_torch.kernels.selective_scan import kernel as scan_kernel
    from repro_torch.kernels.selective_scan import kernel_bwd as scanb_kernel
    from repro_torch.kernels.selective_scan.ref import (
        selective_scan_bwd_ref, selective_scan_ref)
    from repro_torch.launch.profile_scan_bwd import inputs as scan_args
    m, seq = PER_RANK["model"], PER_RANK["seq"]
    results = []

    def done(name, shape, ok, errs, kernel_ms, plain_ms):
        results.append({"case": name, "shape": shape, "ok": ok,
                        "errs": errs, "ms": kernel_ms,
                        "plain_ms": plain_ms, "nvidia_smi": smi})
        log(f"[9/9] per-rank kernel {name} {shape} (model axis {m}): errors "
            f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} }; kernel "
            f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms ({smi})")
        if not ok:
            raise AssertionError(f"{name} at the per-rank shape disagrees "
                                 f"with its plain version: {errs}")

    # flash forward and backward: StableLM-3B's 32 heads of 80, and
    # DeepSeek-V2's MLA 128 heads at hd 128 + 64 (V zero-padded), over m
    for name, b, s, h, hd in (("flash stablelm_3b", 2, seq, 32 // m, 80),
                              ("flash mla deepseek_v2", 1, seq, 128 // m,
                               192)):
        tol = 2e-2
        q, k, v = flash_inputs(torch, b, s, s, h, h, hd, torch.bfloat16,
                               seed=s + h)
        if "mla" in name:
            v[..., 128:] = 0
        do = flash_inputs(torch, b, s, s, h, h, hd, torch.bfloat16,
                          seed=s + 7)[0]
        o, lse = fa_kernel.flash_attention(q, k, v, causal=True,
                                           return_lse=True)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_ref(q, k, v, causal=True,
                                             return_lse=True)
        errs = {"o": float((o.float() - o_ref.float()).abs().max()),
                "lse": float((lse - lse_ref).abs().max())}
        ok = bool(torch.allclose(o.float(), o_ref.float(), rtol=tol,
                                 atol=tol)) and bool(torch.allclose(
                                     lse, lse_ref, rtol=tol, atol=tol))
        shape = {"B": b, "S": s, "T": s, "H": h, "KV": h, "hd": hd,
                 "dtype": "bfloat16"}
        done(name + " forward", shape, ok, errs,
             cuda_ms(torch, lambda: fa_kernel.flash_attention(
                 q, k, v, causal=True), iters=5, graph=True),
             cuda_ms(torch, lambda: flash_attention_ref(q, k, v, causal=True),
                     iters=1, warmup=1))
        args = (q, k, v, o, lse, do)
        grads = fab_kernel.flash_attention_bwd(*args, causal=True)
        torch.cuda.synchronize()
        refs = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do,
                                       causal=True)
        ok, errs, _ = hold_grads(torch, ("dq", "dk", "dv"), grads, refs, tol)
        del grads, refs, o_ref, lse_ref
        done(name + " backward", shape, ok, errs,
             cuda_ms(torch, lambda: fab_kernel.flash_attention_bwd(
                 *args, causal=True), iters=5, graph=True),
             cuda_ms(torch, lambda: flash_attention_bwd_ref(
                 *args, causal=True), iters=1, warmup=1))
        del q, k, v, o, lse, do, args
        torch.cuda.empty_cache()

    # the WKV forward and backward: RWKV-6 1.6B's 32 heads of 64, over m
    b, s, h, hd = 2, seq, 32 // m, 64
    shape = {"B": b, "S": s, "H": h, "hd": hd, "dtype": "float32"}
    args = wkv_inputs(torch, b, s, h, hd, torch.float32, seed=s + h)
    y, sf = wkv_kernel.rwkv6_scan(*args)
    torch.cuda.synchronize()
    yr, sr = rwkv6_scan_ref(*args)
    errs = {"y": float((y - yr).abs().max()),
            "state": float((sf - sr).abs().max())}
    ok = bool(torch.allclose(y, yr, rtol=1e-4, atol=1e-4)) and bool(
        torch.allclose(sf, sr, rtol=1e-4, atol=1e-4))
    done("rwkv6_scan forward", shape, ok, errs,
         cuda_ms(torch, lambda: wkv_kernel.rwkv6_scan(*args), iters=5,
                 graph=True),
         cuda_ms(torch, lambda: rwkv6_scan_ref(*args), iters=1, warmup=0))
    rng = np.random.default_rng(s + h + 1)
    dy = torch.from_numpy(rng.standard_normal((b, s, h, hd)).astype(
        np.float32)).to("cuda")
    bargs = (*args, dy, torch.zeros_like(args[5]))
    grads = wkvb_kernel.rwkv6_scan_bwd(*bargs)
    torch.cuda.synchronize()
    refs = rwkv6_scan_bwd_ref(*bargs)
    ok, errs, _ = hold_grads(torch, ("dr", "dk", "dv", "dw", "du", "ds0"),
                             grads, refs, 2e-3)
    del grads, refs
    done("rwkv6_scan backward", shape, ok, errs,
         cuda_ms(torch, lambda: wkvb_kernel.rwkv6_scan_bwd(*bargs), iters=5,
                 graph=True),
         cuda_ms(torch, lambda: rwkv6_scan_bwd_ref(*bargs), iters=1,
                 warmup=0))
    del args, bargs, y, sf, yr, sr, dy
    torch.cuda.empty_cache()

    # the selective scan: Jamba's d_inner 8192 over m, the forward in its
    # checkpoint mode (what a training step runs) and the backward given
    # its checkpoints
    b, s, d, n = 2, seq, 8192 // m, 16
    shape = {"B": b, "S": s, "D": d, "N": n, "x_dtype": "bfloat16"}
    args = scan_args(b, s, d, n, "bfloat16")
    fwd = args[:7]
    y, hf, ckpt = scan_kernel.scan(*fwd, ckpt=True)
    torch.cuda.synchronize()
    x, delta, a, bm, cm, dd, h = fwd
    yr, hr = selective_scan_ref(*fwd)
    want = torch.empty_like(ckpt)
    chunk = scan_kernel.CKPT_STEPS
    for i in range(ckpt.shape[1]):
        want[:, i] = h
        sl = slice(i * chunk, (i + 1) * chunk)
        _, h = selective_scan_ref(
            x[:, sl].contiguous(), delta[:, sl].contiguous(), a,
            bm[:, sl].contiguous(), cm[:, sl].contiguous(), dd, h)
    errs = {"y": float((y.float() - yr.float()).abs().max()),
            "state": float((hf - hr).abs().max()),
            "checkpoints": float((ckpt - want).abs().max())}
    ok = (bool(torch.allclose(y.float(), yr.float(), rtol=1e-2, atol=1e-2))
          and bool(torch.allclose(hf, hr, rtol=1e-4, atol=1e-4))
          and errs["checkpoints"] <= 2e-3 * float(want.abs().max()))
    done("selective_scan forward (checkpoint mode)", shape, ok, errs,
         cuda_ms(torch, lambda: scan_kernel.scan(*fwd, ckpt=True), iters=5,
                 graph=True),
         cuda_ms(torch, lambda: selective_scan_ref(*fwd), iters=1, warmup=0))
    grads = scanb_kernel.selective_scan_bwd(*args, ckpt=ckpt)
    torch.cuda.synchronize()
    refs = selective_scan_bwd_ref(*args)
    ok, errs, _ = hold_grads(
        torch, ("dx", "ddelta", "da", "db", "dc", "dd", "dh0"), grads, refs,
        2e-2)
    del grads, refs
    done("selective_scan backward (checkpoints given)", shape, ok, errs,
         cuda_ms(torch, lambda: scanb_kernel.selective_scan_bwd(
             *args, ckpt=ckpt), iters=5, graph=True),
         cuda_ms(torch, lambda: selective_scan_bwd_ref(*args), iters=1,
                 warmup=0))
    del args, fwd, y, hf, ckpt, yr, hr, want, x, delta, a, bm, cm, dd, h
    torch.cuda.empty_cache()

    # paged attention on a rank's heads of the served layouts (MHA, so
    # the rank holds as many KV heads): StableLM-3B's and OLMo 2's 32
    # heads over m, one fused step's lane-major call in bf16
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_mixed_ref)
    for name, heads, hd in (("paged_attention_mixed stablelm_3b", 32, 80),
                            ("paged_attention_mixed olmo2_7b", 32, 128)):
        h = heads // m
        x = main_path_step(torch, heads=h, kv=h, hd=hd, layout="lane")
        args = (x["q"].to(torch.bfloat16), x["k"].to(torch.bfloat16),
                x["v"].to(torch.bfloat16), x["bt"], x["qpos"])
        got = pa_kernel.paged_attention_mixed(*args)
        torch.cuda.synchronize()
        ref = paged_attention_mixed_ref(*args)
        err = float((got.float() - ref.float()).abs().max())
        ok = bool(torch.allclose(got.float(), ref.float(), rtol=2e-2,
                                 atol=2e-2))
        shape = {"L": args[0].shape[0], "Q": args[0].shape[1], "H": h,
                 "KV": h, "hd": hd, "dtype": "bfloat16"}
        done(name, shape, ok, {"o": err},
             kernel_ms(torch, lambda: pa_kernel.paged_attention_mixed(
                 *args))[0],
             cuda_ms(torch, lambda: paged_attention_mixed_ref(*args),
                     iters=5))
        del x, args, got, ref
        torch.cuda.empty_cache()
    return results


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
    report["kernels"]["flash_attention_bwd"] = check_flash_bwd(torch)
    report["kernels"]["rwkv6_scan_bwd"] = check_wkv_bwd(torch)
    report["kernels"]["selective_scan_bwd"] = check_scan_bwd(torch)
    report["kernels"]["rwkv6_scan"] = check_wkv(torch)
    report["kernels"]["selective_scan"] = check_scan(torch)
    report["serve"] = serve_full_width(torch)
    report["parity"] = engine_parity(torch)
    report["harness"] = harness(torch, report["device"]["nvidia_smi"])
    report["failures"] = failure_domains(torch, report["device"]["nvidia_smi"])
    report["training"] = training(torch, report["device"]["nvidia_smi"])
    report["sharded"] = sharded_steps(
        torch, report["device"]["nvidia_smi"],
        report["training"]["full_width"]["stablelm_3b"]["losses"])
    report["total_s"] = time.perf_counter() - t0
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # per kernel: its source, the TPU kernel it replaces, and the run
    # whose launches it reports (a serve of phase 4; a backward: phase 8's
    # full-width training of the model named); times from its first
    # (main-path) case of phase 3
    serve_launches = report["serve"]
    trained = report["training"]["full_width"]
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
        # the TPU path has no attention kernel with a backward: JAX
        # differentiates the jnp attention of gqa_prefill
        "flash_attention_bwd": (
            "src/repro_torch/kernels/flash_attention/csrc/"
            "flash_attention_bwd.cu",
            "jax.grad of src/repro/models/attention.py:196 (gqa_prefill)",
            "train stablelm_3b"),
        # nor with a recurrence kernel: JAX differentiates the lax.scan of
        # the time-mix and the associative scan of the Mamba layer
        "rwkv6_scan_bwd": (
            "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan_bwd.cu",
            "jax.grad of src/repro/models/rwkv.py:118",
            "train rwkv6_1_6b"),
        "selective_scan_bwd": (
            "src/repro_torch/kernels/selective_scan/csrc/"
            "selective_scan_bwd.cu",
            "jax.grad of src/repro/models/ssm.py:104",
            "train jamba_v0_1_52b"),
    }
    summary = {"kernels": []}
    for name, (source, replaces, run) in meta.items():
        cases = report["kernels"][name]
        main_case = cases[0]
        launches = (trained[run[6:]]["counts"][name]
                    if run.startswith("train ") else
                    serve_launches[run]["launches"][name])
        summary["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
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
