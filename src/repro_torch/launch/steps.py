"""Step-function assembly for the dry run and the launchers (the PyTorch
twin of ``repro/launch/steps.py``).

``build_step(cfg, shape, mesh)`` returns (fn, args, in_placements,
out_placements, donate):
  * train shapes   -> train_step(params, opt_state, batch)
  * prefill shapes -> prefill_step(params, batch)
  * decode shapes  -> serve_step(params, cache, token, positions)
``args`` are ``device="meta"`` tensors of the global shapes (never
allocated) and the placements are DTensor placements of each leaf's
resolved spec.

On a live ``DeviceMesh`` the functions run.  Every parameter, Adam moment
and decode-cache leaf is stored as this rank's shard of its resolved spec
(``shardings.local_shard``; ``shard_tree`` cuts a whole tree), and the
batch's rows as ``batch_plan`` says.  ``train_step`` gathers the
parameters whole at the start of the step (FSDP's "gathered at use"),
runs ``train_loss`` on this rank's rows (MoE routing over every rank's
rows, as the reference routes over the whole batch), sums the gradients
over the batch axes and divides by their ranks (each rank's loss is the
mean over its rows), cuts them to this rank's shards, takes the clip's
global norm over the shards with every element counted once, and applies
AdamW to the shards in place.  ``prefill_step`` and ``serve_step`` gather
the parameters, run on this rank's rows with each cache leaf gathered
over every axis but the batch's, and cut the cache back to its stored
shard.  The collectives run between the model's pieces, never inside a
kernel.  The model still holds the whole parameters at once and every
rank of ``model`` computes the same rows.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import batch_axes, is_live, mesh_view
from repro_torch.launch.shardings import (axis_group, zip_map, axes_of,
                                          gather_tree, local_shard, reshard,
                                          spec_tree_placements)
from repro_torch.launch.specs import batch_plan, decode_arg_plans
from repro_torch.models.model import (decode_step, model_plan, prefill,
                                      train_loss)
from repro_torch.models.params import (map_plan, plan_leaves, pspecs_from_plan,
                                       specs_from_plan)
from repro_torch.training import optimizer as opt
from repro_torch.training.trainer import _unflatten, grads_of


def _require_live(mesh) -> None:
    if not is_live(mesh):
        raise TypeError("a step runs on a live DeviceMesh "
                        "(launch/mesh.py::make_local_mesh); a MeshShape "
                        "plans only")


def batch_groups(mesh) -> tuple:
    """Process groups of the batch axes of more than one rank, major
    first."""
    shape = mesh_view(mesh).shape
    return tuple(axis_group(mesh, a) for a in batch_axes(mesh)
                 if shape[a] > 1)


def _batch_ranks(mesh) -> int:
    shape = mesh_view(mesh).shape
    return int(np.prod([shape[a] for a in batch_axes(mesh)]))


def _all_reduce(t: torch.Tensor, groups) -> torch.Tensor:
    import torch.distributed as dist
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


def _replicas(spec, mesh) -> int:
    """Ranks that hold the same shard under ``spec``."""
    shape = mesh_view(mesh).shape
    ext = int(np.prod([shape[a] for e in spec for a in axes_of(e)]))
    return int(np.prod(list(shape.values()))) // ext


def sharded_norm(grads, specs, mesh) -> torch.Tensor:
    """The global norm of a gradient tree held as shards: each shard's sum
    of squares over the ranks that hold it, summed over every rank, so an
    element counts once.  On one rank, ``optimizer._global_norm``'s bits."""
    total = None
    for g, spec in zip(plan_leaves(grads), plan_leaves(specs)):
        sq = opt.sum_squares(g)
        rep = _replicas(spec, mesh)
        if rep > 1:
            sq = sq / rep
        total = sq if total is None else total + sq
    names = mesh_view(mesh).axis_names
    _all_reduce(total, [axis_group(mesh, a) for a in names
                        if mesh_view(mesh).shape[a] > 1])
    return torch.sqrt(total)


def _step_spec(spec, batch_entry):
    """A stored cache spec as the step uses it: sharded over the batch's
    axes only."""
    return tuple(e if batch_entry is not None and e == batch_entry else None
                 for e in spec)


def build_step(cfg: ModelConfig, shape: InputShape, mesh, *,
               policy_override=None, remat: bool = True,
               ocfg: Optional[opt.AdamWConfig] = None,
               on_grads: Optional[Callable] = None):
    """``on_grads``, if given, is called by the train step with ``(params,
    grads)``, this rank's shards, between the gradients' reduction and the
    optimizer (as ``trainer.make_train_step``'s)."""
    # the reference's policy constrains activations inside its jitted
    # step; the port's eager functions take none (``policy_override`` is
    # kept for the reference's signature), and the caches' specs come
    # from ``decode_arg_plans``'s policy, as the reference's do
    del policy_override
    pplan = model_plan(cfg)
    p_specs = pspecs_from_plan(pplan, mesh)
    p_args = specs_from_plan(pplan)
    p_place = spec_tree_placements(p_specs, mesh)

    def gathered(params):
        with torch.no_grad():
            return gather_tree(params, p_specs, mesh)

    if shape.mode == "train":
        ocfg = ocfg or opt.AdamWConfig()
        splan = opt.state_plan(pplan)
        s_args = opt.AdamWState(*(specs_from_plan(p) for p in splan))
        s_place = opt.AdamWState(*(
            spec_tree_placements(pspecs_from_plan(p, mesh), mesh)
            for p in splan))
        bplan = batch_plan(cfg, shape, mesh)
        b_specs = pspecs_from_plan(bplan, mesh)

        def train_step(params, opt_state, batch):
            _require_live(mesh)
            groups, n = batch_groups(mesh), _batch_ranks(mesh)
            full = map_plan(lambda t: t.detach().requires_grad_(True),
                            gathered(params))
            loss = train_loss(full, cfg, batch, remat=remat,
                              batch_groups=groups)
            grads = plan_leaves(grads_of(loss, full))
            del full
            with torch.no_grad():
                specs = plan_leaves(p_specs)
                for i, spec in enumerate(specs):
                    g = _all_reduce(grads[i], groups)
                    if n > 1:
                        g = g.div_(n)
                    grads[i] = local_shard(g, spec, mesh)
                grads = _unflatten(params, grads)
                if on_grads is not None:
                    on_grads(params, grads)
                gnorm = sharded_norm(grads, p_specs, mesh)
                params2, opt2, diag = opt.apply_updates(
                    ocfg, params, grads, opt_state, gnorm=gnorm)
                loss = _all_reduce(loss.detach(), groups)
                if n > 1:
                    loss = loss / n
            return params2, opt2, {"loss": loss, **diag}

        args = (p_args, s_args, specs_from_plan(bplan))
        in_pl = (p_place, s_place, spec_tree_placements(b_specs, mesh))
        out_pl = (p_place, s_place, None)
        return train_step, args, in_pl, out_pl, (0, 1)

    cplan, tplan, qplan = decode_arg_plans(cfg, shape, mesh)
    c_specs = pspecs_from_plan(cplan, mesh)
    c_place = spec_tree_placements(c_specs, mesh)
    tok_spec = pspecs_from_plan(tplan, mesh)
    entry = tok_spec[0] if tok_spec else None
    # (stored spec, the step's spec) of every cache leaf
    c_pairs = map_plan(lambda s: (s, _step_spec(s, entry)), c_specs)

    def cut_cache(cache):
        return zip_map(lambda t, s: reshard(t, s[1], s[0], mesh), cache,
                        c_pairs)

    if shape.mode == "prefill":
        bplan = batch_plan(cfg, shape, mesh)

        def prefill_step(params, batch):
            _require_live(mesh)
            logits, cache = prefill(
                gathered(params), cfg, batch["tokens"],
                embeds=batch.get("embeds"), frames=batch.get("frames"),
                seq_cap=shape.seq_len, batch_groups=batch_groups(mesh))
            with torch.no_grad():
                return logits, cut_cache(cache)

        args = (p_args, specs_from_plan(bplan))
        in_pl = (p_place, spec_tree_placements(
            pspecs_from_plan(bplan, mesh), mesh))
        return prefill_step, args, in_pl, (None, c_place), ()

    def serve_step(params, cache, token, positions):
        _require_live(mesh)
        with torch.no_grad():
            step_cache = zip_map(
                lambda t, s: reshard(t, s[0], s[1], mesh), cache, c_pairs)
            logits = decode_step(gathered(params), cfg, step_cache, token,
                                 positions, batch_groups=batch_groups(mesh))
            return logits, cut_cache(step_cache)

    args = (p_args, specs_from_plan(cplan), specs_from_plan(tplan),
            specs_from_plan(qplan))
    in_pl = (p_place, c_place,
             spec_tree_placements(pspecs_from_plan(tplan, mesh), mesh),
             spec_tree_placements(pspecs_from_plan(qplan, mesh), mesh))
    return serve_step, args, in_pl, (None, c_place), (1,)
