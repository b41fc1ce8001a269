"""Mesh definitions on `torch.distributed`'s DeviceMesh (the JAX package's
`launch/mesh.py`, same axis names and shapes).

Single pod: 256 ranks as (data=16, model=16).  Multi-pod: 2 pods x 256
ranks as (pod=2, data=16, model=16); the "pod" dimension carries the DFL
node axis (`repro_torch.dist.sharding.NODE_AXIS`).  `OnePodMesh` is the
one-pod mesh of a process with no process group: its pod axis has size 1
and its all-gather is the identity, as on the JAX package's one-device
mesh.

Functions, not module constants: importing this module initializes no
process group.  `init_device_mesh` needs a world size equal to the mesh's
size; each function checks that first and raises a clear error.  The JAX
package's TPU v5e roofline constants (`HW`) are not copied: they belong to
its HLO analysis (ROADMAP A.11.4).
"""
from __future__ import annotations

import math
import os
from typing import Tuple

import torch.distributed as dist

from repro_torch.dist.sharding import NODE_AXIS


def pod_axis(mesh):
    """(pod count P, this rank's pod, the pod dimension's process group)
    of a mesh with a "pod" dimension (a `DeviceMesh`, or `OnePodMesh`
    without a process group)."""
    if mesh is None or NODE_AXIS not in tuple(mesh.mesh_dim_names or ()):
        raise ValueError(
            f"backend 'shard_map' needs a mesh with a {NODE_AXIS!r} axis; "
            f"pass mesh= or use backend='vmap'")
    dim = tuple(mesh.mesh_dim_names).index(NODE_AXIS)
    return (int(mesh.size(dim)), int(mesh.get_local_rank(NODE_AXIS)),
            mesh.get_group(NODE_AXIS))


class OnePodMesh:
    """The pod mesh of a single process without a process group: one pod,
    rank 0, no group (the pod backend's gather is then the identity)."""

    mesh_dim_names: Tuple[str, ...] = (NODE_AXIS,)
    shape: Tuple[int, ...] = (1,)
    ndim = 1

    def size(self, mesh_dim=None) -> int:
        del mesh_dim
        return 1

    def get_local_rank(self, mesh_dim=None) -> int:
        del mesh_dim
        return 0

    def get_group(self, mesh_dim=None):
        del mesh_dim
        return None

    def __repr__(self):
        return "OnePodMesh(pod=1)"


def _world_size() -> int:
    """The default process group's world size, or the launcher's
    WORLD_SIZE before one exists (1 when neither is set)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _mesh(device_type: str, shape, axes):
    from torch.distributed.device_mesh import init_device_mesh

    world = _world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"a {dict(zip(axes, shape))} mesh needs {math.prod(shape)} "
            f"ranks; the process group has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    `multi_pod`: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_host_mesh(*, data: int = 1, model: int = 1,
                   device_type: str = "cuda"):
    """A small (data, model) mesh over the process group's ranks (tests
    and examples): `data` capped at the world size, `model` at what is
    left, as the reference caps them at the local device count; the
    product must then be the world size."""
    n = _world_size()
    data = min(data, n)
    return _mesh(device_type, (data, max(1, min(model, n // data))),
                 ("data", "model"))
