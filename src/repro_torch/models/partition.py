"""The partition context of a sharded step: what a model function needs to
divide its work as the step's ``ShardPolicy`` and the parameters'
resolved specs say (the port's counterpart of the reference's ``shard()``
constraints, which GSPMD turns into the same division).

A :class:`Part` holds the live mesh's process groups, this rank's
coordinates, the groups over which the batch's rows are split, the policy
and the resolved specs of the parameters and of the decode cache.  Every
model function takes it as one keyword, ``part=None``: ``None`` is the
single-process path, unchanged.

The rules the model functions follow:

* a parameter's dims sharded over the batch axes are gathered where the
  layer walk reaches the layer (``gather_params``), one layer or period
  repeat at a time, and dropped after; the gather's backward
  reduce-scatters the gradient to this rank's shard.  Its dims sharded
  over ``model`` stay local;
* a dim sharded over ``model`` is computed locally: a replicated
  activation enters the split compute through ``copy_to`` (``f``) and the
  partial sums of a row-parallel product meet in ``reduce_from`` (``g``);
* a dim that resolved to replicated is computed whole.

Under Megatron's sequence parallelism (the policy's ``act`` names a live
``model`` axis on the sequence, in train and prefill: ``seq``) the
residual stream is ``[B, S/m, d]`` on each ``model`` rank and only its
boundaries change: a block takes its input through ``enter`` (f, or
here an all-gather along S whose backward reduce-scatters) and gives its
output through ``leave`` (g, or here a reduce-scatter along S whose
backward all-gathers).  A block that every ``model`` rank computes alike
(its dims not split) enters by an all-gather whose backward keeps this
rank's rows and leaves by taking this rank's rows.  Every weight applied
to this rank's rows of the stream (the norms, MLA's latent projections,
an embedding whose vocabulary is whole) is taken through ``shared``, so
that its gradient, each rank's rows' share, is summed over ``model``.

Whether a leaf is split over ``model`` is read from its local shape
against the config's, so an extent of 1 is the whole path.

The bytes of gathered parameters alive at once are tallied
(``read_gathered``): each gathered tensor adds its bytes when it is made
and takes them off when it is freed.
"""
from __future__ import annotations

import dataclasses
import weakref
from dataclasses import dataclass
from typing import Any, Dict, Tuple

from repro_torch.launch import collectives as coll
from repro_torch.models.common import ShardPolicy

BATCH_AXES = ("pod", "data")

_GATHERED = {"live": 0, "peak": 0, "largest": 0, "made": 0}


def reset_gathered() -> None:
    _GATHERED.update(live=0, peak=0, largest=0, made=0)


def read_gathered() -> Dict[str, int]:
    """``peak``: the most gathered parameter bytes alive at once since the
    last reset; ``largest``: the largest one ``gather_params`` call made
    (a layer, a period repeat, the embedding); ``live``: alive now;
    ``made``: every gather's bytes summed."""
    return dict(_GATHERED)


def _drop(nbytes: int) -> None:
    _GATHERED["live"] -= nbytes


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


@dataclass(frozen=True, eq=False)
class Part:
    sizes: Dict[str, int]              # axis -> ranks
    coord: Dict[str, int]              # axis -> this rank's coordinate
    groups: Dict[str, Any]             # axis -> process group
    rows: Tuple[str, ...]              # batch axes (of > 1 rank) the rows
    #                                    are split over
    policy: ShardPolicy
    specs: Any                         # the parameters' resolved specs
    cache_specs: Any = None            # the decode cache's, when serving
    seq: bool = False                  # the residual stream split along S
    #                                    over `model` (sequence parallelism)

    # ---- axes and groups
    def live(self, entry) -> Tuple[str, ...]:
        """The axes of a spec entry with more than one rank."""
        return tuple(a for a in _axes(entry) if self.sizes.get(a, 1) > 1)

    def groups_of(self, axes) -> tuple:
        return tuple(self.groups[a] for a in axes
                     if self.sizes.get(a, 1) > 1)

    def block(self, entry) -> Tuple[int, int]:
        """(this rank's block index, the block count) along a dim whose
        spec entry is ``entry`` (major axis first)."""
        index, n = 0, 1
        for a in self.live(entry):
            index = index * self.sizes[a] + self.coord[a]
            n *= self.sizes[a]
        return index, n

    @property
    def ranks(self) -> int:
        n = 1
        for size in self.sizes.values():
            n *= size
        return n

    @property
    def m(self) -> int:
        return self.sizes.get("model", 1)

    @property
    def mi(self) -> int:
        return self.coord.get("model", 0)

    @property
    def tp(self) -> tuple:
        """The ``model`` group, when it has more than one rank."""
        return self.groups_of(("model",))

    @property
    def row_groups(self) -> tuple:
        return self.groups_of(self.rows)

    # ---- Megatron's f and g over `model`
    def f(self, x):
        return coll.copy_to(x, self.tp)

    def g(self, x):
        return coll.reduce_from(x, self.tp)

    # ---- the residual stream's boundaries
    def enter(self, x, split: bool = True):
        """The residual stream ``x`` [B, S, ...] into a block.  ``split``:
        the block's dims are split over ``model`` (f; under ``seq`` the
        all-gather along S, backward reduce-scatter); else every rank
        computes it alike (``x``; under ``seq`` the all-gather along S,
        backward this rank's rows)."""
        if not self.seq:
            return self.f(x) if split else x
        return coll.gather(x, self.tp, 1, backward="reduce_scatter"
                           if split else "split")

    def leave(self, x, split: bool = True):
        """A block's output [B, S, ...] back to the residual stream:
        ``split`` (partial sums): g, under ``seq`` the reduce-scatter
        along S; else (alike on every rank) ``x``, under ``seq`` this
        rank's rows."""
        if not self.seq:
            return self.g(x) if split else x
        if split:
            return coll.scatter_sum(x, self.tp, 1)
        return coll.split_to(x, self.tp, 1)

    def alike(self, xe, x):
        """The input of compute that every ``model`` rank does alike
        inside a split block and meets the split compute through ``f``
        (K/V heads that do not divide ``model``, the MoE routing): ``x``;
        under ``seq`` the entered ``xe`` with only this rank's rows of its
        cotangent kept, so that the entry's reduce-scatter counts each
        row once."""
        return coll.keep_own(xe, self.tp, 1) if self.seq else x

    def shared(self, w):
        """A weight every ``model`` rank holds whole, applied to this
        rank's rows of a split stream: identity, its gradient summed over
        ``model`` (f on the weight)."""
        return coll.copy_to(w, self.tp) if self.seq else w

    def seq_rows(self, t):
        """This rank's rows of ``t`` along S (dim 1), no gradient
        (positions, tokens)."""
        return coll.own_block(t, self.tp, 1) if self.seq else t

    def check_seq(self, n: int, what: str) -> None:
        if self.seq and n % self.m:
            raise ValueError(
                f"sequence parallelism splits the {what} over `model`: "
                f"{n} positions do not divide {self.m} ranks (ROADMAP C1)")

    def whole_seq(self) -> "Part":
        """This partition with the sequence whole (decode, or a tensor
        already gathered along S)."""
        return dataclasses.replace(self, seq=False) if self.seq else self

    def alike_rows(self) -> "Part":
        """This partition for rows that every batch rank computes alike (an
        engine's one-request prefill, which the batch axes cannot split):
        no row groups, and the MoE capacity slots not split over them."""
        buf = self.policy.moe_buf
        if buf is not None and len(buf) > 1:
            buf = (buf[0], None) + tuple(buf[2:])
        return dataclasses.replace(
            self, rows=(), policy=dataclasses.replace(self.policy,
                                                      moe_buf=buf))

    def model_slice(self, x, dim: int):
        """This rank's block of a whole tensor along ``dim`` (backward:
        the blocks' cotangents gathered)."""
        return coll.split_to(x, self.tp, dim)

    def gather_model(self, x, dim: int):
        """The ``model`` ranks' blocks of a tensor every rank then uses
        alike (backward: this rank's block of the cotangent)."""
        return coll.gather(x, self.tp, dim, backward="split")

    def gather_rows(self, x):
        """Every row rank's rows [T, ...], in global order (backward:
        the cotangent summed over the ranks, this rank's rows)."""
        return coll.gather(x, self.row_groups, 0)

    # ---- parameters gathered at use
    def gather_leaf(self, t, spec):
        """``t`` (this rank's shard under ``spec``) gathered over the
        batch axes its spec names; its ``model`` dims stay local."""
        out = t
        for dim, entry in enumerate(spec):
            axes = self.live(entry)
            if not axes:
                continue
            if any(a not in BATCH_AXES for a in axes):
                if all(a not in BATCH_AXES for a in axes):
                    continue
                raise ValueError(f"spec entry {entry} mixes the batch axes "
                                 f"and model")
            out = coll.gather(out, self.groups_of(axes), dim)
        if out is not t:
            n = out.numel() * out.element_size()
            _GATHERED["made"] += n
            _GATHERED["live"] += n
            _GATHERED["peak"] = max(_GATHERED["peak"], _GATHERED["live"])
            weakref.finalize(out, _drop, n)
        return out

    def gather_params(self, tree, specs, stacked: bool = False):
        """``gather_leaf`` over a tree (a layer, a period repeat, the
        embedding); ``stacked``: ``tree`` is one repeat of a stacked
        period, whose specs lead with the stack's (never sharded) axis."""
        before = _GATHERED["made"]
        out = _map2(lambda t, s: self.gather_leaf(
            t, s[1:] if stacked else s), tree, specs)
        _GATHERED["largest"] = max(_GATHERED["largest"],
                                   _GATHERED["made"] - before)
        return out


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def make_part(mesh, policy: ShardPolicy, specs, rows=None,
              cache_specs=None) -> Part:
    """The context of a live ``DeviceMesh``; ``rows``: the batch axes the
    step's rows are split over (default: every batch axis)."""
    from repro_torch.launch.shardings import axis_group
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, (int(s) for s in mesh.shape)))
    coord = dict(zip(names, mesh.get_coordinate()))
    groups = {a: axis_group(mesh, a) for a in names}
    if rows is None:
        rows = tuple(a for a in BATCH_AXES if a in names)
    rows = tuple(a for a in rows if sizes[a] > 1)
    act = policy.act or ()
    seq = (len(act) > 1 and "model" in _axes(act[1])
           and sizes.get("model", 1) > 1)
    return Part(sizes=sizes, coord=coord, groups=groups, rows=rows,
                policy=policy, specs=specs, cache_specs=cache_specs, seq=seq)
