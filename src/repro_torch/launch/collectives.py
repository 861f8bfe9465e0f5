"""Every collective of the sharded steps: the port's one door to
``torch.distributed``'s communication calls.

A collective runs over ``groups``, a tuple of process groups, major first
(a spec entry ``("pod", "data")`` is the pod group, then the data group).
Over several groups a gather runs minor group first, so the blocks nest
in the mixed-radix order of the ranks' coordinates (``rank_index``), and
a reduce-scatter runs major group first, its inverse.  A group of one
rank is skipped: the input comes back untouched and nothing is tallied.

Each call adds to a per-rank tally by kind the bytes this rank passes, as
a ring implementation moves them (the dry run's analytic count,
``launch/dryrun.py::collective_bytes``, uses the same rules):

  all_gather of an n-byte input over g ranks      (g - 1) n
  reduce_scatter to an n-byte output over g ranks  (g - 1) n
  all_reduce of e elements of s bytes over g ranks 2 (g - 1) ceil(e / g) s

The autograd Functions give each use the backward its place needs:

  ``gather(x, groups, dim, backward=...)``  all-gather along ``dim``; the
      backward reduce-scatters the cotangent (``"reduce_scatter"``: the
      ranks computed different things with the gathered tensor, as a
      parameter gathered at use over the batch axes, or rows gathered for
      routing) or takes this rank's block of it (``"split"``: every rank
      computed the same thing with it, so each holds the whole cotangent);
  ``copy_to(x, groups)``    identity; backward all-reduce (Megatron's f,
      in front of a column-parallel product);
  ``reduce_from(x, groups)``  all-reduce; backward identity (Megatron's
      g, after a row-parallel product);
  ``split_to(x, groups, dim)``  this rank's block; backward all-gather;
  ``scatter_sum(x, groups, dim)``  reduce-scatter (every rank's partial
      sums of every block, this rank's block summed); backward
      all-gather (each block's cotangent to every rank).

``all_reduce`` (sum or max) and ``all_gather`` without autograd serve the
step's bookkeeping and the decode merges.

Nothing here touches ``torch.distributed`` when it is imported.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

KINDS = ("all_gather", "reduce_scatter", "all_reduce")
_TALLY: Dict[str, int] = {k: 0 for k in KINDS}


def reset_tally() -> None:
    for k in KINDS:
        _TALLY[k] = 0


def read_tally() -> Dict[str, int]:
    """Bytes this rank passed since the last ``reset_tally``, by kind."""
    return dict(_TALLY)


def size(group) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


def rank(group) -> int:
    import torch.distributed as dist
    return dist.get_rank(group)


def rank_index(groups: Sequence) -> int:
    """This rank's place among the ranks of ``groups`` (major first)."""
    index = 0
    for g in groups:
        index = index * size(g) + rank(g)
    return index


def extent(groups: Sequence) -> int:
    n = 1
    for g in groups:
        n *= size(g)
    return n


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def ring_all_reduce_bytes(numel: int, itemsize: int, n: int) -> int:
    return 2 * (n - 1) * (-(-numel // n)) * itemsize


# ---------------------------------------------------------------------------
# The calls (no autograd)
# ---------------------------------------------------------------------------

def all_gather(x: torch.Tensor, groups: Sequence, dim: int = 0):
    """Every rank's ``x`` concatenated along ``dim``, in rank order."""
    import torch.distributed as dist
    out = x
    for g in reversed(tuple(groups)):       # minor first: blocks nest
        n = size(g)
        if n == 1:
            continue
        out = out.contiguous()
        parts = [torch.empty_like(out) for _ in range(n)]
        dist.all_gather(parts, out, group=g)
        _TALLY["all_gather"] += (n - 1) * _nbytes(out)
        out = torch.cat(parts, dim=dim)
    return out


def reduce_scatter(x: torch.Tensor, groups: Sequence, dim: int = 0):
    """The sum of every rank's ``x``, this rank's block along ``dim``."""
    import torch.distributed as dist
    out = x
    for g in tuple(groups):                 # major first: undoes the gather
        n = size(g)
        if n == 1:
            continue
        chunks = [c.contiguous() for c in out.chunk(n, dim=dim)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=g)
        _TALLY["reduce_scatter"] += (n - 1) * _nbytes(out)
    return out


def all_reduce(x: torch.Tensor, groups: Sequence, op: str = "sum"):
    """In place over every group; ``op`` ``"sum"`` or ``"max"``."""
    import torch.distributed as dist
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for g in tuple(groups):
        n = size(g)
        if n == 1:
            continue
        dist.all_reduce(x, op=red, group=g)
        _TALLY["all_reduce"] += ring_all_reduce_bytes(x.numel(),
                                                      x.element_size(), n)
    return x


def own_block(x: torch.Tensor, groups: Sequence, dim: int):
    """This rank's block of ``x`` along ``dim`` (equal blocks)."""
    n = extent(groups)
    if n == 1:
        return x
    block = x.shape[dim] // n
    return x.narrow(dim, rank_index(groups) * block, block)


# ---------------------------------------------------------------------------
# With autograd
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, dim, backward):
        ctx.groups, ctx.dim, ctx.backward = groups, dim, backward
        return all_gather(x, groups, dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.backward == "split":
            return own_block(grad, ctx.groups, ctx.dim), None, None, None
        return reduce_scatter(grad, ctx.groups, ctx.dim), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.groups), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return all_reduce(x.clone(), groups)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, dim):
        ctx.groups, ctx.dim = groups, dim
        return own_block(x, groups, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.groups, ctx.dim), None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, dim):
        ctx.groups, ctx.dim = groups, dim
        return reduce_scatter(x, groups, dim)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.groups, ctx.dim), None, None


def _live(groups) -> tuple:
    return tuple(g for g in groups if size(g) > 1)


def gather(x, groups, dim: int = 0, backward: str = "reduce_scatter"):
    groups = _live(groups)
    if not groups:
        return x
    if backward not in ("reduce_scatter", "split"):
        raise ValueError(backward)
    return _Gather.apply(x, groups, dim, backward)


def copy_to(x, groups):
    groups = _live(groups)
    if not groups or not torch.is_grad_enabled():
        return x
    return _CopyTo.apply(x, groups)


def reduce_from(x, groups):
    groups = _live(groups)
    if not groups:
        return x
    return _ReduceFrom.apply(x, groups)


def split_to(x, groups, dim: int):
    groups = _live(groups)
    if not groups:
        return x
    return _SplitTo.apply(x, groups, dim)


def scatter_sum(x, groups, dim: int = 0):
    groups = _live(groups)
    if not groups:
        return x
    return _ScatterSum.apply(x, groups, dim)
