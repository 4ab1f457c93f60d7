"""Device-free meshes (the port of ``repro/sharding/mesh.py``).

An ``AbstractMesh`` has the two things the spec functions read of a mesh,
``shape`` (axis name -> size, in axis order) and ``axis_names``, and no
devices or process group, so ``AxisRules.for_mesh`` and every spec function
cover the production (16, 16) and (2, 16, 16) meshes on any machine. A
``torch.distributed.device_mesh.DeviceMesh`` is read through the same two
helpers, ``axis_names`` and ``axis_sizes``.
"""
from __future__ import annotations

from typing import Sequence


class AbstractMesh:
    """A mesh's axis names and sizes, without devices."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        sizes = tuple(int(s) for s in axis_sizes)
        names = tuple(str(n) for n in axis_names)
        if len(sizes) != len(names):
            raise ValueError(f"axis_sizes/axis_names length mismatch: "
                             f"{sizes} vs {names}")
        self.axis_names = names
        self.shape = dict(zip(names, sizes))

    @property
    def size(self) -> int:
        out = 1
        for s in self.shape.values():
            out *= s
        return out

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def make_abstract_mesh(axis_sizes: Sequence[int],
                       axis_names: Sequence[str]) -> AbstractMesh:
    return AbstractMesh(axis_sizes, axis_names)


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, in axis order, of either kind of mesh."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
