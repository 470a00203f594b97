"""Device meshes (port of ``repro/launch/mesh.py``): functions, never
module-level state — the process group stays under the caller's control.

:func:`make_mesh` and :func:`make_production_mesh` build a
``torch.distributed`` ``DeviceMesh`` over the current process group, which
the caller starts (``torch.distributed.init_process_group`` with its own
address, world size and rank). :class:`AbstractMesh` describes a mesh by
its axis names and shape alone, with no process group, so the sharding
rules of the production meshes can be computed on one host, as the
reference computes them for its dry run.
"""
from __future__ import annotations

import math
from typing import NamedTuple

from repro_torch.device import resolve_device
from repro_torch.errors import ConfigError

__all__ = ["AbstractMesh", "mesh_axes", "make_mesh", "make_production_mesh",
           "production_mesh"]


class AbstractMesh(NamedTuple):
    """A mesh's shape and axis names, without devices or a process
    group."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` in the mesh's order, of an
    :class:`AbstractMesh` or a named ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.shape))
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ConfigError("the sharding rules need a mesh with named axes")
    return dict(zip(names, tuple(mesh.shape)))


def production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 ``("data", "model")`` = 256 devices per pod; 2 pods = 512
    with the leading ``"pod"`` axis."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the current
    process group, on the card unless ``device_type`` says otherwise
    (``"cpu"`` runs it on gloo). The group's world size must be the
    mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ConfigError(f"mesh shape {shape} and axes {axes} differ in "
                          f"length")
    dev = resolve_device(device_type)
    if not dist.is_initialized():
        raise ConfigError("a mesh needs a process group: call "
                          "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ConfigError(f"mesh {shape} holds {math.prod(shape)} devices, "
                          f"the process group {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """The production mesh (:func:`production_mesh`) over the current
    process group; :class:`ConfigError` unless its world size is 256 (512
    with ``multi_pod``). The mesh is never shrunk to fit."""
    want = production_mesh(multi_pod=multi_pod)
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != want.size:
        raise ConfigError(f"the production mesh {want.shape} needs a world "
                          f"of {want.size} ranks, got {world}")
    return make_mesh(want.shape, want.axis_names, device_type=device_type)
