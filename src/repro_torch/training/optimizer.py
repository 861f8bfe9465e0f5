"""AdamW, the PyTorch twin of ``repro/training/optimizer.py`` (not
``torch.optim.AdamW``, whose schedule, clip and decay mask differ): a
linear warmup into a cosine decay to ``min_lr_frac`` of the peak, a
global-norm clip of the gradients, bias-corrected f32 moments with eps
outside the square root, weight decay on leaves of two or more dimensions
only, and the parameter cast back to its dtype.

Unlike the JAX function, ``apply_updates`` updates the parameters and the
moments IN PLACE, leaf by leaf and in slices of at most ``_SLICE``
elements of each leaf, so that its f32 temporaries stay small beside the
largest leaf (a full-width StableLM-3B stacks ``w_in`` as 1.13 B elements:
4.5 GB for each f32 copy of it).  The elementwise arithmetic is the
reference's, in its order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.models.params import P, map_plan, plan_leaves

_SLICE = 1 << 26        # elements of one slice of a leaf (256 MB in f32)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def lr_at(cfg: AdamWConfig, step) -> float:
    step = float(step)
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps) /
                   max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_state(params) -> AdamWState:
    return AdamWState(
        step=0,
        mu=map_plan(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params),
        nu=map_plan(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params))


def state_plan(param_plan) -> AdamWState:
    """Plan-of-P for the optimizer state: each moment sharded as its
    parameter."""
    def f32(p: P) -> P:
        return P(p.shape, dtype="float32", init="zeros", pspec=p.pspec,
                 alt=p.alt)
    return AdamWState(step=P((), dtype="int32", init="zeros", pspec=()),
                      mu=map_plan(f32, param_plan),
                      nu=map_plan(f32, param_plan))


def _slices(t: torch.Tensor):
    """Slices of the flattened leaf: views of it when it is contiguous
    (parameters and moments, which are updated through them)."""
    return t.reshape(-1).split(_SLICE)


def sum_squares(leaf: torch.Tensor) -> torch.Tensor:
    """The sum of the squares of a leaf's elements, in f32 (0-d)."""
    return sum(torch.sum(torch.square(c.float())) for c in _slices(leaf))


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor)."""
    total = None
    for leaf in plan_leaves(tree):
        sq = sum_squares(leaf)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState, *,
                  gnorm=None):
    """Updates ``params`` and ``state``'s moments in place.  Returns
    (params, new state, diagnostics).  ``gnorm``: the gradients' global
    norm when ``grads`` are shards of them (``launch/steps.py``), else
    it is taken from ``grads``."""
    if gnorm is None:
        gnorm = _global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    leaves = zip(plan_leaves(params), plan_leaves(grads),
                 plan_leaves(state.mu), plan_leaves(state.nu))
    for p, g, m, v in leaves:
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("parameters and moments must be contiguous")
        decay = p.dim() >= 2           # matrices only (norms/biases exempt)
        for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m),
                                  _slices(v)):
            gf = gs.float() * clip
            ms.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
            vs.mul_(cfg.b2).add_(torch.square(gf), alpha=1 - cfg.b2)
            den = torch.div(vs, b2c, out=gf).sqrt_().add_(cfg.eps)
            delta = torch.div(ms, b1c).div_(den)
            pf = den.copy_(ps)                        # p in f32
            if decay:
                delta.add_(pf, alpha=cfg.weight_decay)
            ps.copy_(pf.sub_(delta, alpha=lr))
    return params, AdamWState(step, state.mu, state.nu), {
        "grad_norm": gnorm, "lr": lr}
