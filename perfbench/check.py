"""Whether what the timed path produced is right, by the plain reference.

Once the window has closed and the program's state is freed, a sample of
the finished requests, drawn from the seed, is taken: the one with the
most tokens, the one that read the most shared-prefix pages (if any
did), and others until ``SERVED_TOKENS`` served tokens are in it.  The
reference runs once over each sampled prompt with its served tokens and
gives two readings, each held to the cell's limit
(``perfbench/limits/<cell>.json``):

* ``served_gap``: the widest gap by which a served token's logit lies
  below the reference's best at its position;
* ``logit_err``: the largest difference between a logit the program
  computed in the window and the reference's, over ``COLUMNS`` columns of
  the vocabulary drawn from the seed, at every row the program produced
  for a sampled request: each decode step and the last row of each
  prefill chunk.

With ``control`` the same readings are taken of the reference computed in
float8 put in the program's place (``control_served_gap``: the gap of the
token the float8 reference puts first; ``control_logit_err``), and the
harness holds them to the same limits (``control_correct``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

COLUMNS = 128             # vocabulary columns of each logit row kept
CAPTURE_ROWS = 1 << 18    # logit rows kept in a run, at most
SERVED_TOKENS = 300       # served tokens the sample reaches, at least
TOKEN_BUDGET = 40_000     # sequence tokens the reference runs, at most


def sample(reqs: Dict, hits: Dict[int, int], seed: int) -> List:
    """The sampled finished requests."""
    done = sorted((r for r in reqs.values() if r.finished is not None
                   and r.req.output_tokens), key=lambda r: r.src.rid)
    if not done:
        return []
    size = {r.src.rid: r.src.tokens.size + len(r.req.output_tokens)
            for r in done}
    picked = [max(done, key=lambda r: size[r.src.rid])]
    shared = [r for r in done if hits.get(r.src.rid, 0) > 0]
    if shared:
        best = max(shared, key=lambda r: hits[r.src.rid])
        if best is not picked[0]:
            picked.append(best)
    rng = np.random.default_rng(seed)
    for i in rng.permutation(len(done)):
        served = sum(len(r.req.output_tokens) for r in picked)
        if served >= SERVED_TOKENS:
            break
        r = done[i]
        if r in picked:
            continue
        if sum(size[p.src.rid] for p in picked) + size[r.src.rid] \
                > TOKEN_BUDGET:
            continue
        picked.append(r)
    return picked


def run(reqs: Dict, hits: Dict[int, int], captured, meta, cols, tree,
        m: Dict, ref, seed: int, dev, control: bool = False
        ) -> Dict[str, float]:
    """The readings; ``ref`` is the model's ``references/<kind>.py``."""
    picked = sample(reqs, hits, seed ^ 0xC4EC)
    rows_of: Dict[int, List[int]] = {}
    for i, (rid, _) in enumerate(meta):
        rows_of.setdefault(rid, []).append(i)
    out = {"served_gap": float("nan"), "logit_err": float("nan"),
           "compared_requests": len(picked), "compared_tokens": 0,
           "compared_rows": 0}
    gaps, errs, cgaps, cerrs = [], [], [], []
    for r in picked:
        prompt = np.asarray(r.src.tokens, np.int64)
        served = np.asarray(r.req.output_tokens, np.int64)
        p, o = prompt.size, served.size
        seq = torch.from_numpy(np.concatenate([prompt, served])[:p + o - 1])
        rows = rows_of.get(r.src.rid, [])
        cap_pos = [meta[i][1] for i in rows]
        want = sorted(set(range(p - 1, p + o - 1)) | set(cap_pos))
        at = {pos: j for j, pos in enumerate(want)}
        want_t = torch.tensor(want, device=dev)
        logits = ref.logits(tree, m, seq.to(dev), want_t).cpu()
        srv = torch.tensor([at[p - 1 + j] for j in range(o)])
        best = logits[srv].max(dim=1).values
        gaps.append(float((best - logits[srv, torch.from_numpy(served)])
                          .max()))
        cap = torch.tensor([at[x] for x in cap_pos], dtype=torch.long)
        if rows:
            errs.append(float((captured[rows] - logits[cap][:, cols])
                              .abs().max()))
        out["compared_tokens"] += o
        out["compared_rows"] += len(rows)
        if control:
            low = ref.logits(tree, m, seq.to(dev), want_t, lowp="fp8").cpu()
            first = low[srv].argmax(dim=1)
            cgaps.append(float((best - logits[srv, first]).max()))
            if rows:
                cerrs.append(float((low[cap][:, cols] - logits[cap][:, cols])
                                   .abs().max()))
        del logits
    if gaps:
        out["served_gap"] = max(gaps)
    if errs:
        out["logit_err"] = max(errs)
    if control:
        out["control_served_gap"] = max(cgaps) if cgaps else float("nan")
        out["control_logit_err"] = max(cerrs) if cerrs else float("nan")
    return out
