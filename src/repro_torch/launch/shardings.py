"""Sharding policy resolution per (architecture x input shape x mesh), and
the layout of a resolved spec on a live mesh (the PyTorch twin of
``repro/launch/shardings.py``).

Parameters: tensor-parallel over ``model`` (heads / FFN columns /
experts), FSDP over ``data`` (weights gathered at use), replicated over
``pod``.  Activations: batch over ("pod","data") when the batch permits;
decode KV caches shard KV-heads over ``model`` when divisible, otherwise
the cache *sequence* dimension takes the ``model`` axis (split-K decode);
long_500k (batch=1) shards sequence over ("data","model").

On a live ``DeviceMesh`` a tensor stored under a resolved spec holds the
slice JAX's layout gives its rank: a dimension whose entry names several
axes (``("pod","data")``) is split major axis first, so the rank at
coordinates (p, d) holds block ``p * |data| + d``.  ``local_shard`` cuts
that block; ``gather`` rebuilds the whole tensor from the blocks with one
``all_gather`` an axis (minor axis first, so the blocks nest in order).
``placements`` gives the same layout as DTensor placements.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import mesh_view
from repro_torch.models.common import ShardPolicy
from repro_torch.models.params import map_plan


def _bd(mesh) -> Tuple:
    mesh = mesh_view(mesh)
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def make_policy(cfg: ModelConfig, shape: InputShape, mesh,
                seq_parallel: bool = False) -> ShardPolicy:
    """seq_parallel: Megatron-style sequence parallelism — the residual
    stream (and hence the remat-saved activation stack) is sharded over
    ``model`` along the sequence dimension."""
    mesh = mesh_view(mesh)
    bd = _bd(mesh)
    model_size = mesh.shape.get("model", 1)
    kv = cfg.attn.num_kv_heads
    kv_divisible = kv % model_size == 0 and kv >= model_size
    n_experts = cfg.moe.num_experts if cfg.moe is not None else 0
    # experts must divide the model axis for expert-parallel dispatch;
    # otherwise the buffer stays expert-replicated (TP-within-expert)
    e_divisible = n_experts >= model_size and n_experts % model_size == 0
    moe_buf = ("model", bd, None) if e_divisible else (None, bd, None)
    act_seq = "model" if seq_parallel else None

    if shape.mode in ("train", "prefill"):
        return ShardPolicy(
            act=(bd, act_seq, None),
            heads=(bd, None, "model", None),
            kv_cache=((bd, None, "model", None) if kv_divisible
                      else (bd, "model", None, None)),
            mla_cache=(bd, "model", None),
            state=(bd, "model", None),
            moe_buf=moe_buf,
            logits=(bd, None, "model"),
        )

    if shape.global_batch == 1:
        # long-context decode: batch unshardable — sequence-shard the cache
        seq_axes = tuple(a for a in ("data", "model") if a in mesh.axis_names)
        return ShardPolicy(
            act=None,
            heads=(None, None, "model", None),
            kv_cache=(None, seq_axes, None, None) if not kv_divisible
            else (None, "data", "model", None),
            mla_cache=(None, seq_axes, None),
            state=(None, "model", None),
            moe_buf=("model", None, None),
            logits=(None, None, "model"),
        )

    # batched decode
    return ShardPolicy(
        act=(bd, None, None),
        heads=(bd, None, "model", None),
        kv_cache=((bd, None, "model", None) if kv_divisible
                  else (bd, "model", None, None)),
        mla_cache=(bd, "model", None),
        state=(bd, "model", None),
        moe_buf=moe_buf,
        logits=(bd, None, "model"),
    )


# ---------------------------------------------------------------------------
# A resolved spec's layout on a mesh
# ---------------------------------------------------------------------------

def axes_of(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes, major first."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def placements(spec, mesh) -> list:
    """DTensor placements of a resolved spec: on each mesh dim,
    ``Shard(d)`` when tensor dim ``d``'s entry names it, else
    ``Replicate()``.  DTensor splits a dim sharded over several mesh dims
    in mesh order, so an entry must list its axes in that order."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh_view(mesh).axis_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = axes_of(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for axis in axes:
            out[names.index(axis)] = Shard(dim)
    return out


def _coordinate(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def axis_group(mesh, axis):
    """The process group along ``axis``; its group ranks must be the
    coordinates along it (as ``init_device_mesh`` lays them out)."""
    import torch.distributed as dist
    group = mesh.get_group(axis)
    if dist.get_rank(group) != _coordinate(mesh)[axis]:
        raise ValueError(f"group ranks along {axis!r} are not its "
                         f"coordinates")
    return group


def local_shard(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under the resolved ``spec`` (a
    contiguous copy; ``full`` itself on a dim-less spec or one rank)."""
    shape = mesh_view(mesh).shape
    coord = _coordinate(mesh)
    out = full
    for dim, entry in enumerate(spec):
        index, ext = 0, 1
        for axis in axes_of(entry):
            index = index * shape[axis] + coord[axis]
            ext *= shape[axis]
        if ext > 1:
            block = full.shape[dim] // ext
            out = out.narrow(dim, index * block, block)
    return out if out is full else out.contiguous()


def gather(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's shard under ``spec``: one
    all-gather an axis of each sharded dim (``collectives.all_gather``,
    minor axis first, so the blocks nest in order)."""
    from repro_torch.launch import collectives
    out = local
    for dim, entry in enumerate(spec):
        groups = tuple(axis_group(mesh, a) for a in axes_of(entry))
        out = collectives.all_gather(out, groups, dim)
    return out


def shard_tree(tree, specs, mesh):
    """Each leaf's local shard under its spec (``specs`` a tree of
    resolved specs shaped as ``tree``)."""
    return zip_map(lambda t, s: local_shard(t, s, mesh), tree, specs)


def gather_tree(tree, specs, mesh):
    return zip_map(lambda t, s: gather(t, s, mesh), tree, specs)


def zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a nested dict and a tree shaped as it."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def spec_tree_placements(specs, mesh):
    """``placements`` of every spec of a tree of resolved specs."""
    return map_plan(lambda s: placements(s, mesh), specs)
