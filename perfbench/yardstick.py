"""The yardstick: published peaks, the operations and bytes a step's work
needs, and the device-trace arithmetic.  Counts are taken from the
configuration's published widths (a model's by its kind's ``flops``) and
the rows a step really ran, so they read the same work whatever
implements it.

``busy_union`` and ``family`` are copies of the port's
``launch/profile_serve.py`` functions, kept here so the yardstick cannot
move with the program.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit; a
# card the table lacks gets no share of a peak
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}


def lane_rows(positions: np.ndarray, row_of: Sequence[Tuple[int, int]]):
    """Per lane of a step: (rows, context sum, largest position), where a
    row at position p attends p + 1 keys."""
    out = []
    for r0, n in row_of:
        pos = positions[r0:r0 + n].astype(np.int64)
        out.append((n, int((pos + 1).sum()), int(pos.max())))
    return out


def step_flops(kind, m: Dict, positions: np.ndarray,
               row_of: Sequence[Tuple[int, int]], logit_rows: int) -> int:
    """Model operations of one step's real rows, counted by the model's
    kind (``references/<kind>.py``)."""
    lanes = lane_rows(positions, row_of)
    return kind.flops(m, sum(n for n, _, _ in lanes),
                      sum(c for _, c, _ in lanes), logit_rows)


def paged_attention_call(m: Dict, positions: np.ndarray,
                         row_of: Sequence[Tuple[int, int]],
                         block_tables: np.ndarray, page_size: int,
                         kv_bytes: int = 2, q_bytes: int = 2
                         ) -> Tuple[int, int]:
    """(operations, bytes) of one layer's paged-attention call: each
    distinct K/V page the lanes read counted once (a page two lanes share
    is read once), plus q in and the context out for the real rows."""
    pages = []
    rows = ctx = 0
    for lane, (n, c, top) in enumerate(lane_rows(positions, row_of)):
        rows += n
        ctx += c
        pages.append(block_tables[lane, :top // page_size + 1])
    distinct = np.unique(np.concatenate(pages)).size if pages else 0
    page_bytes = (2 * page_size * m["num_key_value_heads"] * m["head_dim"]
                  * kv_bytes)
    flops = 4 * m["num_attention_heads"] * m["head_dim"] * ctx
    io = 2 * rows * m["num_attention_heads"] * m["head_dim"] * q_bytes
    return flops, distinct * page_bytes + io


def roofline_s(flops: float, nbytes: float, pk: Dict[str, float]) -> float:
    """The least time the card allows: the larger of the compute and the
    memory bound."""
    return max(flops / pk["bf16_flops"], nbytes / pk["hbm_bytes_s"])


_FAMILIES = (("paged_attention", ("paged_attention",)),
             ("flash_attention_bwd", ("flash_bwd", "bwd_dot")),
             ("flash_attention", ("flash_attention",)),
             ("rwkv6_scan_bwd", ("wkv_bwd_", "wkv_sum_parts")),
             ("selective_scan_bwd", ("ss_bwd_", "ss_sum_parts")),
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


def busy_union(intervals: Iterable[Tuple[float, float]]) -> float:
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


def idle_gaps(intervals: Iterable[Tuple[float, float]]):
    """The gaps between the merged busy intervals, as (start, end)."""
    gaps, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps


def mfu_pct(kind, m: Dict, steps, peak_: Dict[str, float]) -> float:
    """Model operations of the steps' real rows over their wall time at
    the card's peak, in percent."""
    flops = sum(step_flops(kind, m, s.positions, s.row_of, len(s.lanes))
                for s in steps)
    wall = sum(s.end - s.start for s in steps)
    return 100.0 * flops / (wall * peak_["bf16_flops"])


def carries_prefill(step) -> bool:
    """Whether a step packs a prefill chunk (a lane of more than one row)."""
    return any(n > 1 for _, n in step.row_of)


def idle_pct(step_busy_s: Sequence[float], traced, steps) -> float:
    """Share of an unprofiled step with no kernel running, in percent: the
    traced steps' busy time over what the same steps take unprofiled, each
    counted at the window's mean wall time of unprofiled steps of its kind
    (with or without a prefill chunk; the profiler adds host time, not
    device time)."""
    walls: Dict[bool, list] = {True: [], False: []}
    for s in steps:
        walls[carries_prefill(s)].append(s.end - s.start)
    mean = {k: sum(v) / len(v) for k, v in walls.items() if v}
    pairs = [(b, mean[carries_prefill(s)]) for b, s in zip(step_busy_s, traced)
             if carries_prefill(s) in mean]
    if not pairs:
        return None
    return 100.0 * (1.0 - sum(b for b, _ in pairs) / sum(w for _, w in pairs))
