"""Parameter *plans*: single source of truth for shapes, dtypes and init of
every parameter (the PyTorch twin of ``repro/models/params.py``).

A plan is a nested dict whose leaves are :class:`P`.  ``init_from_plan``
turns it into concrete tensors with the same scale rules as the JAX
package; the numbers differ because a ``torch.Generator`` is not a
``jax.random`` key (parity tests bridge the JAX params instead, see
``models/bridge.py``).  The sharding specs and helpers are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class P:
    shape: Tuple[int, ...]
    dtype: str = "bfloat16"
    init: str = "normal"          # normal | zeros | ones | small | identity_decay
    fan_in: Optional[int] = None  # override for scaled-normal init


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def map_plan(fn, plan):
    """Apply ``fn`` to every leaf of a nested dict, keeping its keys."""
    if isinstance(plan, dict):
        return {k: map_plan(fn, v) for k, v in plan.items()}
    return fn(plan)


def plan_leaves(plan):
    """Leaves in the order ``jax.tree.flatten`` gives them (sorted keys)."""
    if isinstance(plan, dict):
        return [leaf for k in sorted(plan) for leaf in plan_leaves(plan[k])]
    return [plan]


_DRAW_SLICE = 1 << 26        # elements of one f32 draw (256 MB)


def _init_leaf(gen: torch.Generator, p: P, device) -> torch.Tensor:
    dtype = torch_dtype(p.dtype)
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "identity_decay":
        d_state = p.shape[-1]
        a = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32,
                                   device=device))
        return a.expand(p.shape).to(dtype).contiguous()
    fan_in = p.fan_in if p.fan_in is not None else (p.shape[0] if p.shape else 1)
    scale = 0.02 if p.init == "small" else 1.0 / np.sqrt(max(fan_in, 1))
    out = torch.empty(p.shape, dtype=dtype, device=device)
    flat = out.view(-1)
    # a large leaf is drawn in slices of the flattened leaf, so the f32
    # draw beside the weights already placed stays at most _DRAW_SLICE
    # elements (a stacked full-width MoE ``wi`` would otherwise need a
    # temporary twice its own bf16 size)
    for lo in range(0, flat.numel(), _DRAW_SLICE):
        n = min(_DRAW_SLICE, flat.numel() - lo)
        x = torch.randn(n, generator=gen, dtype=torch.float32, device=device)
        flat[lo: lo + n] = x.mul_(scale)
    return out


def init_from_plan(plan, generator: torch.Generator, device="cuda"):
    """Concrete tensors for ``plan``, drawn leaf by leaf from ``generator``
    (which must live on ``device``)."""
    dev = resolve_device(device)
    return map_plan(lambda p: _init_leaf(generator, p, dev), plan)


def count_params(plan) -> int:
    return int(sum(np.prod(p.shape) for p in plan_leaves(plan)))
