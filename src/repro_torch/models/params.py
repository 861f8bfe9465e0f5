"""Parameter *plans*: single source of truth for shapes, dtypes, init and
sharding of every parameter (the PyTorch twin of
``repro/models/params.py``).

A plan is a nested dict whose leaves are :class:`P`.  ``init_from_plan``
turns it into concrete tensors with the same scale rules as the JAX
package; the numbers differ because a ``torch.Generator`` is not a
``jax.random`` key (parity tests bridge the JAX params instead, see
``models/bridge.py``).  ``specs_from_plan`` gives ``device="meta"``
stand-ins (shape and dtype, no memory) for the dry run.

Sharding rules live on the leaf (``pspec``: one entry a dimension, an
axis name, a tuple of axis names or None), with an optional fallback
``alt`` taken when ``pspec`` does not divide the leaf on the mesh (e.g.
Mixtral's 8 experts on a 16-way ``model`` axis fall back to
tensor-parallel-within-expert).  ``resolve_pspec`` returns the entries
as a plain tuple: torch has no ``PartitionSpec``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_view


@dataclass(frozen=True)
class P:
    shape: Tuple[int, ...]
    dtype: str = "bfloat16"
    init: str = "normal"          # normal | zeros | ones | small | identity_decay
    fan_in: Optional[int] = None  # override for scaled-normal init
    pspec: Tuple = ()             # entries: axis name, tuple of names, None
    alt: Optional[Tuple] = None   # fallback spec when pspec does not fit


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    shape = mesh_view(mesh).shape
    if isinstance(entry, (tuple, list)):
        return int(np.prod([shape[a] for a in entry]))
    return shape[entry]


def _spec_fits(mesh, shape, pspec) -> bool:
    """True if every sharded dim divides evenly by its mesh extent."""
    for dim, entry in zip(shape, pspec):
        ext = _axis_size(mesh, entry)
        if ext > 1 and (dim < ext or dim % ext != 0):
            return False
    return True


def resolve_pspec(mesh, leaf: P) -> Tuple:
    """The leaf's spec on ``mesh``, one entry a dimension: ``alt`` when
    ``pspec`` does not fit, entries past the rank cut, axes the mesh lacks
    dropped, and a dimension its mesh extent does not divide replicated
    (e.g. StarCoder2's 36 heads or Granite's 49155 vocab on 16)."""
    mesh = mesh_view(mesh)
    spec = leaf.pspec
    if leaf.alt is not None and not _spec_fits(mesh, leaf.shape, leaf.pspec):
        spec = leaf.alt
    names = set(mesh.axis_names)

    def keep(e, dim):
        if e is None:
            return None
        if isinstance(e, (tuple, list)):
            e = tuple(a for a in e if a in names) or None
        elif e not in names:
            e = None
        if e is None:
            return None
        ext = _axis_size(mesh, e)
        if ext > 1 and (dim < ext or dim % ext != 0):
            return None
        return e

    return tuple(keep(e, d) for e, d in zip(spec[: len(leaf.shape)],
                                            leaf.shape))


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


def specs_from_plan(plan):
    """``device="meta"`` tensors of each leaf's shape and dtype."""
    return map_plan(lambda p: torch.empty(p.shape, dtype=torch_dtype(p.dtype),
                                          device="meta"), plan)


def pspecs_from_plan(plan, mesh):
    return map_plan(lambda p: resolve_pspec(mesh, p), plan)


def count_params(plan) -> int:
    return int(sum(np.prod(p.shape) for p in plan_leaves(plan)))


def param_bytes(plan) -> int:
    return int(sum(np.prod(p.shape) * torch_dtype(p.dtype).itemsize
                   for p in plan_leaves(plan)))
