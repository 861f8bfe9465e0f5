"""Weights made from the seed on the device in the type they are served
in, in a few large draws, laid out as the configuration's kind lists its
leaves (``references/<kind>.py``'s ``layout``).  The same tensors are
handed to the program and, upcast, to the reference."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def make(leaves: List[Tuple[Tuple[str, ...], Tuple[int, ...], str, float]],
         seed: int, device) -> Dict:
    """The weight tree of ``leaves`` (path, shape, dtype, std) from
    ``seed``: one normal draw per dtype from a generator on ``device``,
    cut into leaves and scaled in place."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tree: Dict = {}
    for dt in sorted({leaf[2] for leaf in leaves}):
        mine = [leaf for leaf in leaves if leaf[2] == dt]
        total = sum(math.prod(shape) for _, shape, _, _ in mine)
        flat = torch.randn(total, generator=gen, dtype=getattr(torch, dt),
                           device=device)
        off = 0
        for path, shape, _, std in mine:
            n = math.prod(shape)
            leaf = flat[off:off + n].view(shape).mul_(std)
            off += n
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
    return tree
