"""Where one WKV backward call's time goes on the card, kernel by kernel,
and what the backward kernel's loops issue.

    PYTHONPATH=src python -m repro_torch.launch.profile_wkv_bwd \
        [--batch 2 --seq 4096 --heads 32 --head-dim 64] [--calls 5] \
        [--variants] [--out profile_wkv_bwd.json]

Runs ``kernel_bwd.rwkv6_scan_bwd`` at RWKV-6 1.6B's training shape (by
default) on inputs drawn from a seed, ``calls`` times under
``torch.profiler``, and prints each CUDA kernel's mean device time per
call beside the call's time by CUDA-graph replay.  Then it reads the
library's SASS (``cuobjdump --dump-sass``) and, for each kernel instance
at the profiled head width, counts the instructions of the function and
of each loop (a backward branch and the code it jumps back over) by
opcode class, so a loop's count over the steps it covers is the issue
cost of one step.  With ``--variants`` it also builds the design's
alternatives and ablations (``VARIANTS``: text edits of the source, each
its own library) and times each beside the source as it stands, in
turns; an ablation computes wrong gradients and only says what a piece
costs.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

# opcode classes the count reports; anything else is "other"
CLASSES = (("FFMA", ("FFMA",)), ("FMUL", ("FMUL",)), ("FADD", ("FADD",)),
           ("FSEL", ("FSEL",)), ("LDS", ("LDS",)), ("STS", ("STS",)),
           ("SHFL", ("SHFL",)),
           ("LD/ST cluster", ("LD.", "ST.", "LD ", "ST ", "ATOMS")),
           ("BAR", ("BAR", "UCGABAR", "CGAERRBAR", "SYNCS")),
           ("LDGSTS", ("LDGSTS",)), ("LDG", ("LDG",)), ("STG", ("STG",)),
           ("MOV", ("MOV", "IMAD.MOV")), ("MUFU", ("MUFU",)),
           ("integer", ("IMAD", "IADD3", "LEA", "ISETP", "LOP3", "SHF",
                        "SEL", "PRMT")))


def opcode_class(op: str) -> str:
    for name, prefixes in CLASSES:
        if any(op == p.strip() or op.startswith(p) for p in prefixes):
            return name
    return "other"


_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")


def _dump_sass(so: Path) -> str:
    """``cuobjdump --dump-sass`` of a built library (the toolkit's, beside
    nvcc)."""
    from repro_torch.kernels.build import nvcc_path
    cuobjdump = Path(nvcc_path()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "--dump-sass", str(so)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def sass_functions(so: Path) -> dict:
    """{mangled name: [(address, opcode, operands)]} of a library's SASS."""
    funcs, cur = {}, None
    for ln in _dump_sass(so).splitlines():
        if "Function :" in ln:
            cur = ln.split("Function :")[1].strip()
            funcs[cur] = []
            continue
        m = _LINE.search(ln)
        if cur is not None and m:
            funcs[cur].append((int(m.group(1), 16), m.group(2),
                               m.group(3).strip()))
    return funcs


def histogram(instrs) -> dict:
    counts = collections.Counter(opcode_class(op) for _, op, _ in instrs)
    out = {name: counts.get(name, 0) for name, _ in CLASSES}
    out["other"] = counts.get("other", 0)
    out["total"] = len(instrs)
    return out


def loops(instrs) -> list:
    """Each backward branch's loop: its address range and opcode counts,
    innermost (shortest) first."""
    out = []
    for addr, op, rest in instrs:
        if not op.startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)", rest)
        if not m or int(m.group(1), 16) >= addr:
            continue
        lo = int(m.group(1), 16)
        body = [i for i in instrs if lo <= i[0] <= addr]
        out.append({"from": hex(lo), "to": hex(addr), **histogram(body)})
    return sorted(out, key=lambda d: d["total"])


def functions_report(so: Path, keep) -> dict:
    """The function's and its loops' counts of each function of a
    library whose mangled name ``keep(name)`` accepts."""
    return {name: {"function": histogram(instrs), "loops": loops(instrs)}
            for name, instrs in sass_functions(so).items() if keep(name)}


def sass_report(so: Path, hd: int) -> dict:
    """Per kernel instance at head width ``hd`` (template argument ``hd``,
    or no template argument), the function's and its loops' counts."""
    return functions_report(so, lambda name: "wkv" in name and (
        "ILi" not in name or f"ILi{hd}E" in name))


# name: (what it measures, edits of the source (old, new)); each old
# text occurs in the source exactly once
VARIANTS = {
    "rows16": (
        "blocks of 16 rows at hd 64 too (clusters of 4)",
        (("kRows = kHd == 64 ? 32 : 16;", "kRows = 16;"),)),
    "exchange_per_sub_chunk": (
        "dv shares exchanged every sub-chunk (8 steps), not every chunk",
        (("kXSteps = kHd <= 64 ? kChunk : kSub;", "kXSteps = kSub;"),)),
    "forward_unrolled_by_4": (
        "the checkpoint pass's 32-step chunk unrolled by 4, not whole",
        (("#pragma unroll\n    for (int c = 0; c < kChunk; ++c) advance",
          "#pragma unroll 4\n    for (int c = 0; c < kChunk; ++c) advance"),)),
    "relaxed_arrive": (
        "ablation: the exchange barrier's arrive without its release "
        "(unordered)",
        (("        clu::arrive();\n",
          '        asm volatile("barrier.cluster.arrive.relaxed;\\n" ::: '
          '"memory");\n'),)),
    "no_starts_rerun": (
        "ablation: no rerun from the checkpoint to the sub-chunk starts",
        (("      if (sc + 1 < G::kSubs) {", "      if (false) {"),)),
    "forward_only": (
        "ablation: the checkpoint pass alone",
        (("  // ---- the chunks backward\n",
          "  clu::sync();\n  return;\n  // ---- the chunks backward\n"),)),
}


def build_source_variants(source: Path, lib: str, variants: dict) -> dict:
    """{name: BuiltLibrary} of each of ``variants`` ({name: (what, edits)})
    applied to ``source``, built in parallel as libraries named
    ``{lib}_{name}``; the caller binds their C interface."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.build import build_dir, load_library
    text = source.read_text()
    paths = {}
    for name, (_, edits) in variants.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not in the "
                                   f"source exactly once")
            src = src.replace(old, new)
        path = build_dir() / f"{lib}_{name}{source.suffix}"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        paths[name] = path
    with ThreadPoolExecutor(len(paths)) as pool:
        return dict(zip(paths, pool.map(
            lambda kv: load_library(f"{lib}_{kv[0]}", [kv[1]]),
            paths.items())))


def build_variants() -> dict:
    """{name: BuiltLibrary} of each variant, built in parallel, with the
    C interface of ``kernel_bwd.build``."""
    import ctypes

    from repro_torch.kernels.rwkv6_scan import kernel_bwd
    built = build_source_variants(kernel_bwd.SOURCE, "rwkv6_scan_bwd",
                                  VARIANTS)
    for b in built.values():
        b.lib.rwkv6_scan_bwd.argtypes = [ctypes.c_void_p] * 16 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        b.lib.rwkv6_scan_bwd.restype = ctypes.c_int
        b.lib.rwkv6_scan_bwd_max_clusters.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        b.lib.rwkv6_scan_bwd_max_clusters.restype = ctypes.c_int
    return built


def max_clusters(lib, hd: int) -> int:
    """Clusters of a library's head-width kernel the card holds at once."""
    import ctypes
    out = ctypes.c_int(0)
    if lib.rwkv6_scan_bwd_max_clusters(hd, ctypes.byref(out)) != 0:
        raise RuntimeError(f"occupancy query failed for head_dim {hd}")
    return out.value


def call_library(lib, xs):
    """One backward call through a variant's library (``kernel_bwd``'s
    call without its checks)."""
    from repro_torch.kernels.rwkv6_scan import kernel_bwd
    r, k, v, w, u, s0, dy, dsf = xs
    b, s, h, hd = r.shape
    grads = [torch.empty_like(r) for _ in range(4)]
    du, ds0 = torch.zeros_like(u), torch.empty_like(s0)
    scratch = [torch.empty(shape, device=r.device) for shape in
               kernel_bwd.scratch_shapes(b, s, h, hd).values()]
    rc = lib.rwkv6_scan_bwd(*(t.data_ptr() for t in (
        r, k, v, w, u, s0, dy, dsf, *scratch, *grads, du, ds0)), b, s, h, hd,
        torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"variant launch failed (cudaError {rc})")
    return (*grads, du, ds0)


def time_variants(xs, call) -> dict:
    """{name: {"ms": [ms, ms], "clusters": n}}: the source as it stands
    ("source") and each variant, by graph replay, in turns (forward order,
    then reverse), and how many of its clusters fit at once at the inputs'
    head width."""
    from repro_torch.kernels.rwkv6_scan import kernel_bwd
    hd = xs[0].shape[-1]
    built = build_variants()
    fns = {"source": call, **{
        name: (lambda lib=b.lib: call_library(lib, xs))
        for name, b in built.items()}}
    ms = time_in_turns(fns)
    return {name: {"ms": ms[name], "clusters": (
        max_clusters(built[name].lib, hd) if name in built else
        kernel_bwd.max_clusters(hd))} for name in fns}


def time_in_turns(fns: dict) -> dict:
    """{name: [ms, ms]}: each of ``fns`` by graph replay, in turns
    (forward order, then reverse)."""
    out = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            out[name].append(graph_ms(fns[name]))
    return out


def inputs(b, s, h, hd, seed=0, device="cuda"):
    """r/k/v/w/u/s0 as chip_smoke draws them, dy and ds_final."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, hd)) * 0.5 for _ in range(3))
    w = 0.45 + 0.5 / (1 + np.exp(-rng.standard_normal((b, s, h, hd))))
    u = rng.standard_normal((h, hd)) * 0.5
    s0 = rng.standard_normal((b, h, hd, hd)) * 0.1
    dy = rng.standard_normal((b, s, h, hd))
    dsf = rng.standard_normal((b, h, hd, hd)) * 0.1
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (r, k, v, w, u, s0, dy, dsf)]


def kernel_split(fn, calls: int = 5) -> dict:
    """{CUDA kernel name: mean device ms per call} of ``fn()`` over
    ``calls`` calls under ``torch.profiler`` (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    return {name: ms / calls for name, ms in
            sorted(total.items(), key=lambda kv: -kv[1])}


def graph_ms(fn, iters: int = 5, reps: int = 5) -> float:
    """Mean device ms of ``fn()`` over replays of a CUDA graph of
    ``iters`` calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--variants", action="store_true",
                    help="also time VARIANTS beside the source")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_wkv_bwd needs a CUDA device")
    from repro_torch.kernels.rwkv6_scan import kernel_bwd

    xs = inputs(args.batch, args.seq, args.heads, args.head_dim)

    def call():
        return kernel_bwd.rwkv6_scan_bwd(*xs)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    split = kernel_split(call, args.calls)
    ms = graph_ms(call)
    sass = sass_report(kernel_bwd.build().path, args.head_dim)
    report = {"card": smi, "source": str(kernel_bwd.SOURCE),
              "shape": {"B": args.batch, "S": args.seq, "H": args.heads,
                        "hd": args.head_dim},
              "graph_ms": ms, "split_ms": split, "sass": sass}
    print(smi)
    print(f"rwkv6_scan_bwd B={args.batch} S={args.seq} H={args.heads} "
          f"hd={args.head_dim}: {ms:.4f} ms a call (CUDA graph)")
    for name, kms in split.items():
        print(f"  {kms:.4f} ms  {name}")
    for name, rep in sass.items():
        print(f"SASS {name}: function {rep['function']}")
        for lp in rep["loops"]:
            print(f"  loop {lp['from']}..{lp['to']}: {lp}")
    if args.variants:
        report["variants_ms"] = time_variants(xs, call)
        for name, got in report["variants_ms"].items():
            what = VARIANTS[name][0] if name in VARIANTS else "as it stands"
            print(f"variant {name}: " + " ".join(
                f"{t:.4f}" for t in got["ms"]) + f" ms, {got['clusters']} "
                f"clusters at once ({what})")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
