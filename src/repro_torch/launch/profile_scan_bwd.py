"""Where one selective-scan backward call's time goes on the card, kernel
by kernel, and what the backward kernel's loops issue.

    PYTHONPATH=src python -m repro_torch.launch.profile_scan_bwd \
        [--batch 2 --seq 4096 --dim 8192 --state 16 --dtype bfloat16] \
        [--calls 5] [--cases | --cases-only] [--variants] [--out FILE]

Runs ``kernel_bwd.selective_scan_bwd`` at Jamba's training shape (by
default) on inputs drawn from a seed as ``chip_smoke.py`` draws them,
``calls`` times under ``torch.profiler``, and prints each CUDA kernel's
mean device time per call beside the call's time by CUDA-graph replay.
It also times the backward with the forward's checkpoints given and the
forward with and without its checkpoint mode: the first plus the
difference of the other two is what a training step pays.  Then it
reads the library's SASS (``cuobjdump --dump-sass``) and, for each kernel
instance of the profiled state build and dtype, counts the instructions
of the function and of each loop (a backward branch and the code it
jumps back over) by opcode class.  With ``--cases`` it times every
scan-backward case of ``chip_smoke.py`` phase 3 (``CASES``) and the
forward's serving cases, one direct call each; ``--cases-only`` does
just that, with nothing the earlier wrappers lack, so that two trees can
be compared in turns (run the file by its path with
``PYTHONPATH=<other tree>/src``).  With ``--variants`` it builds the
design's alternatives and ablations (``VARIANTS``: text edits of the
source, each its own library) and times each beside the source as it
stands, in turns, with the checkpoints given; an ablation computes wrong
gradients and only says what a piece costs.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.launch.profile_wkv_bwd import graph_ms, kernel_split

# chip_smoke.py phase 3's scan-backward cases: name, B, S, D, N, x dtype,
# h0 and a cotangent on h_final, wide A (delta * A past the exponential's
# flush to 0).  The first is the training shape (phase 8's Jamba layer).
CASES = (
    ("jamba train B=2 S=4096 D=8192 N=16 x bf16", 2, 4096, 8192, 16,
     "bfloat16", False, False),
    ("x f32 S=1024", 1, 1024, 8192, 16, "float32", False, False),
    ("ragged S=1000 x f32", 1, 1000, 2048, 16, "float32", False, False),
    ("D=8200 off the channel tile S=70 x bf16", 1, 70, 8200, 16, "bfloat16",
     False, False),
    ("N=1 D=1000 S=45 x f32", 2, 45, 1000, 1, "float32", True, False),
    ("N=13 D=1001 S=50 x f32", 2, 50, 1001, 13, "float32", True, False),
    ("N=64 D=1024 S=40 x f32", 2, 40, 1024, 64, "float32", True, False),
    ("h0 and dh_final S=300 x f32", 2, 300, 1024, 16, "float32", True,
     False),
    ("delta * A past the exponential's flush to 0 x f32", 2, 96, 1024, 16,
     "float32", True, True),
    ("one step S=1 x f32", 2, 1, 1024, 16, "float32", True, False),
    ("S=7, one short chunk x bf16", 2, 7, 1024, 16, "bfloat16", True,
     False),
    ("S=33, a chunk and a step x f32", 2, 33, 1024, 64, "float32", True,
     False),
    ("N=16 S=1000 h0 and dh_final x f32", 2, 1000, 1024, 16, "float32",
     True, False),
    ("more blocks than fit at once B=8 S=256 D=8192 x bf16", 8, 256,
     8192, 16, "bfloat16", True, False),
)

# the forward's serving cases of phase 3: name, B, S, D, N (x bf16)
FORWARD_CASES = (("jamba prefill B=1 S=1024", 1, 1024, 8192, 16),
                 ("decode B=8 S=1", 8, 1, 8192, 16))


def inputs(b, s, d, n, x_dtype="bfloat16", seed=None, state=False,
           wide=False, device="cuda"):
    """(x, delta, a, b, c, d, h0, dy, dh_final) as ``chip_smoke.py``'s
    ``check_scan_bwd`` draws them: delta in (0, ~0.3), A negative, B/C/x
    of spread 0.5 (wide: A log-uniform in (-1000, -0.01) and delta in
    (0, 1)); h0 and dh_final zeros unless ``state``."""
    seed = s + n if seed is None else seed
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, s, d)) * 0.5,
              np.abs(rng.standard_normal((b, s, d))) * 0.1,
              -np.abs(rng.standard_normal((d, n))) - 0.1,
              rng.standard_normal((b, s, n)) * 0.5,
              rng.standard_normal((b, s, n)) * 0.5,
              rng.standard_normal((d,))]
    if wide:
        arrays[1] = rng.uniform(0, 1, (b, s, d))
        arrays[2] = -np.exp(rng.uniform(np.log(0.01), np.log(1000.0),
                                        (d, n)))
    rng = np.random.default_rng(seed + 1)
    h0 = rng.standard_normal((b, d, n)) * 0.1 if state else np.zeros(
        (b, d, n))
    dhf = rng.standard_normal((b, d, n)) * 0.1 if state else np.zeros(
        (b, d, n))
    dy = rng.standard_normal((b, s, d))
    dtype = getattr(torch, x_dtype)
    out = [torch.from_numpy(a.astype(np.float32)).to(device)
           for a in (*arrays, h0, dy, dhf)]
    out[0], out[7] = out[0].to(dtype), out[7].to(dtype)
    return out


def sass_report(so: Path, n: int, x_dtype: str) -> dict:
    """Per kernel instance of the state build ``n`` (16 or 64) and x
    dtype (and each kernel with no template argument), the function's and
    its loops' counts, and for the walk (the instance with shuffles) the
    opcodes of its largest loop but the function's own (the sub-chunk)."""
    import collections

    from repro_torch.launch.profile_wkv_bwd import (functions_report,
                                                    sass_functions)
    tag = "I13__nv_bfloat16" if x_dtype == "bfloat16" else "If"
    report = functions_report(so, lambda name: "ss_" in name and (
        "Li" not in name or (f"Li{n}E" in name and tag in name)))
    funcs = sass_functions(so)
    for name, rep in report.items():
        inner = [lp for lp in rep["loops"] if lp["SHFL"]][:-1]
        if inner:
            lo, hi = int(inner[-1]["from"], 16), int(inner[-1]["to"], 16)
            rep["sub_chunk_opcodes"] = dict(collections.Counter(
                op for addr, op, _ in funcs[name]
                if lo <= addr <= hi).most_common())
    return report


# name: (what it measures, edits of the source (old, new)); each old
# text occurs in the source exactly once
VARIANTS = {
    "sum_every_sub_chunk": (
        "the block's dB / dC summed after every 8-step sub-chunk, not after "
        "two (half the shares buffer, twice the barriers)",
        (("kSumSubs = sizeof(T) == 2 ? 2 : 1;", "kSumSubs = 1;"),)),
    "tiles_1x4": (
        "a thread 1 channel x 4 states (the first design's tile), summed "
        "every sub-chunk (two sub-chunks of its 8 shares a step do not "
        "fit)",
        (("kTileCh = 2;", "kTileCh = 1;"),
         ("kSumSubs = sizeof(T) == 2 ? 2 : 1;", "kSumSubs = 1;"))),
    "dx_every_2_steps": (
        "gb / gd shares meet every 2 steps, not 4 (one per lane, its pair "
        "partner's by a shuffle)",
        (("kXSteps = 4;", "kXSteps = 2;"),)),
    "no_block_sum": (
        "ablation: no sum of the block's dB / dC shares (the compiler then "
        "drops their products and stores too)",
        (("e < G::kSumSubs * kSub * kLanes * kRow;", "e < 0;"),)),
}


def bind(lib) -> None:
    """The C interface of ``kernel_bwd.build`` on a variant's library."""
    import ctypes
    lib.selective_scan_bwd.argtypes = [ctypes.c_void_p] * 18 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.selective_scan_bwd.restype = ctypes.c_int
    lib.selective_scan_bwd_occupancy.argtypes = [ctypes.c_int] * 2 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.selective_scan_bwd_occupancy.restype = ctypes.c_int


def blocks_per_sm(lib, n: int, x_dtype: torch.dtype) -> int:
    """How many blocks of a variant's walk an SM holds."""
    import ctypes
    from repro_torch.kernels.selective_scan.kernel import _DTYPES
    blocks = ctypes.c_int(0)
    if lib.selective_scan_bwd_occupancy(n, _DTYPES[x_dtype],
                                        ctypes.byref(blocks)) != 0:
        raise RuntimeError(f"occupancy query failed for d_state {n}")
    return blocks.value


def call_library(lib, xs, ckpt):
    """One backward call through a variant's library with the forward's
    checkpoints given (``kernel_bwd``'s call without its checks)."""
    from repro_torch.kernels.selective_scan import kernel_bwd
    from repro_torch.kernels.selective_scan.kernel import _DTYPES
    x, delta, a, b, c, d, h0, dy, dhf = xs
    bsz, s, dim = x.shape
    n = a.shape[1]
    dx, ddelta = torch.empty_like(x), torch.empty_like(delta)
    da, dd = torch.empty_like(a), torch.empty_like(d)
    dbc, dh0 = torch.empty((2, bsz, s, n), device=x.device), \
        torch.empty_like(h0)
    scratch = [torch.empty(shape, device=x.device) for shape in
               kernel_bwd.scratch_shapes(bsz, s, dim, n).values()]
    rc = lib.selective_scan_bwd(*(t.data_ptr() for t in (
        x, delta, a, b, c, d, dy, dhf, ckpt, *scratch, dx, ddelta, da, dbc,
        dd, dh0)), bsz, s, dim, n, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"variant launch failed (cudaError {rc})")
    return dx, ddelta, da, dbc[0], dbc[1], dd, dh0


def time_variants(xs) -> dict:
    """{name: {"ms": [ms, ms], "blocks_per_sm": b, "ptxas": [...]}}: the
    source as it stands ("source") and each variant,
    with the forward's checkpoints given, by graph replay in turns
    (forward order, then reverse), with the walk's occupancy and ptxas's
    report of each build."""
    from repro_torch.kernels.selective_scan import kernel, kernel_bwd
    from repro_torch.launch.profile_wkv_bwd import (build_source_variants,
                                                    time_in_turns)
    n, x_dtype = xs[2].shape[1], xs[0].dtype
    _, _, ckpt = kernel.scan(*xs[:7], ckpt=True)
    built = build_source_variants(kernel_bwd.SOURCE, "selective_scan_bwd",
                                  VARIANTS)
    for b in built.values():
        bind(b.lib)
    fns = {"source": lambda: kernel_bwd.selective_scan_bwd(*xs, ckpt=ckpt)}
    for name, b in built.items():
        fns[name] = (lambda lib=b.lib: call_library(lib, xs, ckpt))
    ms = time_in_turns(fns)
    out = {}
    for name in fns:
        lib = built[name] if name in built else kernel_bwd.build()
        out[name] = {"ms": ms[name],
                     "blocks_per_sm": blocks_per_sm(lib.lib, n, x_dtype),
                     "ptxas": [
                         ln.strip() for ln in lib.log.splitlines()
                         if "ss_bwd_kernel" in ln or "registers" in ln
                         or "spill" in ln]}
    return out


def time_cases() -> dict:
    """{case: ms} of one direct backward call for each of ``CASES`` and
    one forward call for each of ``FORWARD_CASES``, by graph replay."""
    from repro_torch.kernels.selective_scan import kernel, kernel_bwd
    out = {}
    for name, b, s, d, n, dt, state, wide in CASES:
        xs = inputs(b, s, d, n, dt, state=state, wide=wide)
        out[f"selective_scan_bwd {name}"] = graph_ms(
            lambda: kernel_bwd.selective_scan_bwd(*xs))
        del xs
    for name, b, s, d, n in FORWARD_CASES:
        xs = inputs(b, s, d, n, "bfloat16", state=True)[:7]
        out[f"selective_scan {name}"] = graph_ms(
            lambda: kernel.selective_scan(*xs))
        del xs
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=8192)
    ap.add_argument("--state", type=int, default=16)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--cases", action="store_true",
                    help="also time CASES and FORWARD_CASES")
    ap.add_argument("--cases-only", action="store_true",
                    help="only time CASES and FORWARD_CASES")
    ap.add_argument("--variants", action="store_true",
                    help="also time VARIANTS beside the source")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_scan_bwd needs a CUDA device")
    from repro_torch.kernels.selective_scan import kernel, kernel_bwd

    b, s, d, n = args.batch, args.seq, args.dim, args.state
    xs = inputs(b, s, d, n, args.dtype)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    shape = f"B={b} S={s} D={d} N={n} x {args.dtype}"
    report = {"card": smi, "source": str(kernel_bwd.SOURCE),
              "shape": {"B": b, "S": s, "D": d, "N": n,
                        "x_dtype": args.dtype}}
    if args.cases_only:
        report["cases_ms"] = time_cases()
        for name, ms in report["cases_ms"].items():
            print(f"case {name}: {ms:.4f} ms")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(report, indent=1))
        return report

    def call():
        return kernel_bwd.selective_scan_bwd(*xs)

    report["split_ms"] = kernel_split(call, args.calls)
    report["graph_ms"] = graph_ms(call)
    print(f"selective_scan_bwd {shape}: {report['graph_ms']:.4f} ms a "
          f"direct call (CUDA graph)")
    for name, kms in report["split_ms"].items():
        print(f"  {kms:.4f} ms  {name}")
    fwd = xs[:7]
    _, _, ckpt = kernel.selective_scan(*fwd, ckpt=True)
    given = graph_ms(lambda: kernel_bwd.selective_scan_bwd(
        *xs, ckpt=ckpt))
    plain = graph_ms(lambda: kernel.selective_scan(*fwd))
    with_ckpt = graph_ms(lambda: kernel.selective_scan(*fwd, ckpt=True))
    report["training"] = {
        "bwd_ckpt_given_ms": given, "fwd_ms": plain,
        "fwd_ckpt_ms": with_ckpt,
        "bwd_plus_ckpt_extra_ms": given + with_ckpt - plain}
    print(f"  with the checkpoints given {given:.4f} ms; the forward "
          f"{plain:.4f} ms, in checkpoint mode {with_ckpt:.4f} ms; a "
          f"training step pays {given + with_ckpt - plain:.4f} ms")
    del ckpt
    report["sass"] = sass_report(kernel_bwd.build().path,
                                 16 if n <= 16 else 64, args.dtype)
    for name, rep in report["sass"].items():
        print(f"SASS {name}: function {rep['function']}")
        for lp in rep["loops"]:
            print(f"  loop {lp['from']}..{lp['to']}: {lp}")
    if args.cases:
        report["cases_ms"] = time_cases()
        for name, ms in report["cases_ms"].items():
            print(f"case {name}: {ms:.4f} ms")
    if args.variants:
        report["variants_ms"] = time_variants(xs)
        for name, got in report["variants_ms"].items():
            what = VARIANTS[name][0] if name in VARIANTS else "as it stands"
            print(f"variant {name}: " + " ".join(
                f"{t:.4f}" for t in got["ms"]) + f" ms, {got['blocks_per_sm']}"
                f" blocks an SM ({what})")
            for ln in got["ptxas"]:
                print(f"  ptxas: {ln}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
