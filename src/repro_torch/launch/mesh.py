"""Meshes: the production mesh's shape, and live ``DeviceMesh``es (the
PyTorch twin of ``repro/launch/mesh.py``).

A plan function needs only a mesh's axis names and sizes.  Torch cannot
make a 256-rank ``DeviceMesh`` in one process, so the production mesh is a
:class:`MeshShape`, names and sizes only, and ``mesh_view`` gives every
plan function the same ``.shape`` (a dict from axis name to size) and
``.axis_names`` for both kinds: a ``MeshShape`` (or any object with those
two attributes, as the tests' ``FakeMesh``), and a live ``DeviceMesh``,
whose ``shape`` is a tuple and whose names are ``mesh_dim_names``.

Nothing here touches ``torch.distributed`` state when it is imported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axes, major first, and their sizes: no devices."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{self.axis_names} and {self.sizes} differ in "
                             f"length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def is_live(mesh) -> bool:
    """True for a ``DeviceMesh`` (one that holds ranks and groups)."""
    return hasattr(mesh, "mesh_dim_names")


def mesh_view(mesh):
    """``mesh`` as something with a dict ``.shape`` and ``.axis_names``:
    a ``DeviceMesh`` becomes its :class:`MeshShape`, anything else is
    taken as it is."""
    if is_live(mesh):
        return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16 x 16 = 256 devices a pod; two pods = 512 devices."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
                     device: str = "cuda"):
    """A live mesh over the default process group's ranks (row-major:
    rank = the mixed-radix number of its coordinates), which must be
    started and hold ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(names))


def make_local_mesh(device: str = "cuda"):
    """Every rank of the started process group on ``data``, ``model`` of
    size 1 (one card: a 1 x 1 mesh)."""
    import torch.distributed as dist
    return make_device_mesh((dist.get_world_size(), 1), ("data", "model"),
                            device)


def batch_axes(mesh) -> tuple:
    """Mesh axes that carry the batch dimension."""
    return tuple(a for a in ("pod", "data")
                 if a in mesh_view(mesh).axis_names)
