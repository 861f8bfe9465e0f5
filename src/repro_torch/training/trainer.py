"""Training step assembly and a small training loop, the PyTorch twin of
``repro/training/trainer.py``.

The step runs eagerly (there is no ``jax.jit``) and updates the
parameters and the optimizer state in place.  It takes no sharding
policy: this is the single-process step (``launch/steps.py`` builds the
sharded one on a ``DeviceMesh``).  ``train`` adds an
explicit ``device`` (default ``"cuda"``), an optional ``params=`` to start
from given weights (e.g. bridged from the JAX package; they are copied,
never updated in place) and draws its initial weights from a
``torch.Generator`` seeded with ``seed``.  The serving ``Model``'s
parameters stay frozen; the trainer turns gradients on for its own tree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, train_loss
from repro_torch.models.params import map_plan, plan_leaves
from repro_torch.training import optimizer as opt


def _unflatten(like, leaves):
    """A nested dict shaped as ``like`` holding ``leaves`` in
    ``plan_leaves`` order (sorted keys)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(like)


def grads_of(loss, params):
    """d loss / d params as a tree shaped as ``params`` (zeros for a leaf
    the loss does not reach, as JAX gives)."""
    leaves = plan_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return _unflatten(params, grads)


def make_train_step(cfg: ModelConfig, ocfg: opt.AdamWConfig,
                    remat: bool = True,
                    on_grads: Optional[Callable] = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, state, aux);
    ``batch`` a dict of tensors on the parameters' device.  ``on_grads``,
    if given, is called with ``(params, grads)`` between the backward and
    the optimizer (``launch/train.py`` times the two parts with it)."""

    def step(params, opt_state, batch):
        loss = train_loss(params, cfg, batch, remat=remat)
        grads = grads_of(loss, params)
        if on_grads is not None:
            on_grads(params, grads)
        params2, opt_state2, diag = opt.apply_updates(ocfg, params, grads,
                                                      opt_state)
        return params2, opt_state2, {"loss": loss.detach(), **diag}

    return step


def trainable(params, device="cuda", copy: bool = True):
    """The tree on ``device`` as leaves that require a gradient: copies of
    the given tensors (``copy``), or new leaves sharing their storage."""
    dev = resolve_device(device)

    def leaf(t):
        t = t.detach().to(dev)
        return (t.clone() if copy else t).requires_grad_(True)
    return map_plan(leaf, params)


def batch_to_torch(batch, device) -> dict:
    """The pipeline's numpy batch as tensors on ``device`` (token ids as
    int64)."""
    out = {}
    for key, val in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(val))
        if t.dtype in (torch.int32, torch.int64):
            t = t.long()
        out[key] = t.to(device)
    return out


@dataclass
class TrainResult:
    losses: list
    final_params: Any
    final_state: Any


def train(cfg: ModelConfig, data_iter, steps: int,
          ocfg: Optional[opt.AdamWConfig] = None, seed: int = 0,
          remat: bool = False, log_every: int = 10, log_fn=None, *,
          device="cuda", params=None) -> TrainResult:
    """The loop tests, examples and ``launch/train.py`` run: ``steps``
    steps over the numpy batches of ``data_iter``."""
    ocfg = ocfg or opt.AdamWConfig(warmup_steps=10, total_steps=steps)
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = trainable(Model(cfg, generator=gen, device=dev).params, dev,
                           copy=False)
    else:
        params = trainable(params, dev)
    state = opt.init_state(params)
    step_fn = make_train_step(cfg, ocfg, remat)
    losses = []
    for i in range(steps):
        batch = batch_to_torch(next(data_iter), dev)
        params, state, aux = step_fn(params, state, batch)
        losses.append(float(aux["loss"]))
        if log_fn and (i % log_every == 0 or i == steps - 1):
            log_fn(i, losses[-1], float(aux["grad_norm"]))
    return TrainResult(losses=losses, final_params=params, final_state=state)
