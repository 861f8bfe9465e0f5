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

The step follows ``policy_override`` where one is given, as the
reference's does: the port follows ``make_policy(cfg, shape, mesh,
seq_parallel=b)`` for either ``b`` and refuses any other policy.  Under
``seq_parallel`` (train and prefill) the residual stream is split along
the sequence over ``model`` (Megatron's sequence parallelism,
``models/partition.py``); the weights applied to a rank's rows of it
have their gradients summed over ``model`` where they are used
(``Part.shared``).

On a live ``DeviceMesh`` the functions run.  Every parameter, Adam moment
and decode-cache leaf is stored as this rank's shard of its resolved spec
(``shardings.local_shard``; ``shard_tree`` cuts a whole tree), and the
batch's rows as ``batch_plan`` says.  The model functions take a
partition context (``models/partition.py::Part``: the mesh's groups, the
step's ``ShardPolicy``, the resolved specs) and divide the work as the
reference's policy does: each layer's parameters are gathered over the
batch axes where the layer walk reaches it (a prefix layer or a period
repeat at a time; under remat the backward's recompute gathers the
repeat again) and the gather's backward reduce-scatters each gradient to
this rank's shard; dims split over ``model`` are computed locally
(attention heads, FFN columns, Mamba channels, RWKV-6 heads, vocabulary
blocks, MoE expert blocks) and their partial sums meet in collectives
(``launch/collectives.py``, which tallies the bytes).

``train_step`` runs ``train_loss`` on this rank's rows (MoE routing over
every rank's rows, as the reference routes over the whole batch), sums
over the batch axes the gradients of the leaves their spec does not
shard there, divides every gradient by the batch ranks (each rank's loss
is the mean over its rows), takes the clip's global norm over the shards
with every element counted once, and applies AdamW to the shards in
place.  ``prefill_step`` runs ``prefill`` on this rank's rows and cuts
each cache leaf it made whole along a split dim (the sequence) to the
stored shard; ``serve_step`` runs ``decode_step`` on the stored shards of
the cache, in place, and gathers none of them.  The collectives run
between the model's pieces, never inside a kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import collectives as coll
from repro_torch.launch.mesh import batch_axes, is_live, mesh_view
from repro_torch.launch.shardings import (axis_group, axes_of, make_policy,
                                          spec_tree_placements, zip_map)
from repro_torch.launch.specs import batch_plan, decode_arg_plans
from repro_torch.models.model import (decode_step, model_plan, prefill,
                                      train_loss)
from repro_torch.models.params import (map_plan, plan_leaves, pspecs_from_plan,
                                       specs_from_plan)
from repro_torch.models.partition import make_part
from repro_torch.training import optimizer as opt
from repro_torch.training.trainer import _unflatten, grads_of


def _require_live(mesh) -> None:
    if not is_live(mesh):
        raise TypeError("a step runs on a live DeviceMesh "
                        "(launch/mesh.py::make_local_mesh); a MeshShape "
                        "plans only")


def _batch_ranks(mesh) -> int:
    shape = mesh_view(mesh).shape
    return int(np.prod([shape[a] for a in batch_axes(mesh)]))


def row_axes(plan_spec) -> tuple:
    """The batch axes a batch leaf's resolved spec splits its rows over."""
    return axes_of(plan_spec[0]) if plan_spec else ()


def unsharded_batch_axes(spec, mesh) -> tuple:
    """The batch axes (of more than one rank) a parameter's resolved spec
    does not shard it over: its gradient is summed over them."""
    shape = mesh_view(mesh).shape
    named = {a for e in spec for a in axes_of(e)}
    return tuple(a for a in batch_axes(mesh)
                 if shape[a] > 1 and a not in named)


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
    coll.all_reduce(total, [axis_group(mesh, a) for a in names
                            if mesh_view(mesh).shape[a] > 1])
    return torch.sqrt(total)


def cut_to_stored(t: torch.Tensor, leaf, spec, part) -> torch.Tensor:
    """A cache leaf the prefill made whole along a dim its stored spec
    splits (the sequence; the batch's rows and split heads or channels
    come out local), cut to this rank's stored shard."""
    out = t
    for dim, (full, entry) in enumerate(zip(leaf.shape, spec)):
        index, n = part.block(entry)
        if n == 1 or out.shape[dim] == full // n:
            continue
        if out.shape[dim] != full:
            raise ValueError(f"cache dim {dim} is {out.shape[dim]}: neither "
                             f"{full} nor its shard {full // n}")
        out = out.narrow(dim, index * (full // n), full // n)
    return out if out is t else out.contiguous()


def followed_policy(cfg: ModelConfig, shape: InputShape, mesh,
                    policy_override=None):
    """The policy a step follows: ``policy_override`` or, without one,
    ``make_policy``'s.  An override must be ``make_policy``'s with or
    without ``seq_parallel``; any other is refused (``ValueError``)
    naming the field that differs."""
    if policy_override is None:
        return make_policy(cfg, shape, mesh)
    want = make_policy(cfg, shape, mesh, seq_parallel=bool(
        policy_override.act and len(policy_override.act) > 1
        and policy_override.act[1] == "model"))
    for f in dataclasses.fields(want):
        if getattr(policy_override, f.name) != getattr(want, f.name):
            raise ValueError(
                f"policy_override.{f.name} = "
                f"{getattr(policy_override, f.name)!r}: the port follows "
                f"make_policy's policy with or without seq_parallel, "
                f"whose {f.name} is {getattr(want, f.name)!r} "
                f"(ROADMAP C1)")
    return policy_override


def build_step(cfg: ModelConfig, shape: InputShape, mesh, *,
               policy_override=None, remat: bool = True,
               ocfg: Optional[opt.AdamWConfig] = None,
               on_grads: Optional[Callable] = None):
    """``on_grads``, if given, is called by the train step with ``(params,
    grads)``, this rank's shards, between the gradients' reduction and the
    optimizer (as ``trainer.make_train_step``'s).  The model functions
    follow ``followed_policy``'s policy; the caches' specs come from
    ``decode_arg_plans``, as the reference's do."""
    policy = followed_policy(cfg, shape, mesh, policy_override)
    pplan = model_plan(cfg)
    p_specs = pspecs_from_plan(pplan, mesh)
    p_args = specs_from_plan(pplan)
    p_place = spec_tree_placements(p_specs, mesh)

    def part_for(rows_spec, cache_specs=None):
        return make_part(mesh, policy, p_specs, rows=row_axes(rows_spec),
                         cache_specs=cache_specs)

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
            part = part_for(b_specs["tokens"])
            groups, n = part.row_groups, _batch_ranks(mesh)
            local = map_plan(lambda t: t.detach().requires_grad_(True),
                             params)
            loss = train_loss(local, cfg, batch, remat=remat, part=part)
            grads = plan_leaves(grads_of(loss, local))
            del local
            with torch.no_grad():
                specs = plan_leaves(p_specs)
                for i, spec in enumerate(specs):
                    g = coll.all_reduce(grads[i], part.groups_of(
                        unsharded_batch_axes(spec, mesh)))
                    if n > 1:
                        g = g.div_(n)
                    grads[i] = g
                grads = _unflatten(params, grads)
                if on_grads is not None:
                    on_grads(params, grads)
                gnorm = sharded_norm(grads, p_specs, mesh)
                params2, opt2, diag = opt.apply_updates(
                    ocfg, params, grads, opt_state, gnorm=gnorm)
                loss = coll.all_reduce(loss.detach(), groups)
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
    # (plan leaf, stored spec) of every cache leaf
    c_leaves = zip_map(lambda p, s: (p, s), cplan, c_specs)

    if shape.mode == "prefill":
        bplan = batch_plan(cfg, shape, mesh)
        tokens_spec = pspecs_from_plan(bplan, mesh)["tokens"]

        def prefill_step(params, batch):
            _require_live(mesh)
            part = part_for(tokens_spec)
            logits, cache = prefill(
                params, cfg, batch["tokens"],
                embeds=batch.get("embeds"), frames=batch.get("frames"),
                seq_cap=shape.seq_len, part=part)
            with torch.no_grad():
                return logits, zip_map(
                    lambda t, ps: cut_to_stored(t, ps[0], ps[1], part), cache,
                    c_leaves)

        args = (p_args, specs_from_plan(bplan))
        in_pl = (p_place, spec_tree_placements(
            pspecs_from_plan(bplan, mesh), mesh))
        return prefill_step, args, in_pl, (None, c_place), ()

    def serve_step(params, cache, token, positions):
        _require_live(mesh)
        with torch.no_grad():
            logits = decode_step(params, cfg, cache, token, positions,
                                 part=part_for(tok_spec, c_specs))
            return logits, cache

    args = (p_args, specs_from_plan(cplan), specs_from_plan(tplan),
            specs_from_plan(qplan))
    in_pl = (p_place, c_place,
             spec_tree_placements(pspecs_from_plan(tplan, mesh), mesh),
             spec_tree_placements(pspecs_from_plan(qplan, mesh), mesh))
    return serve_step, args, in_pl, (None, c_place), (1,)
