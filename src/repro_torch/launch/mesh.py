"""Device meshes over ``torch.distributed``: the port's counterpart of the
JAX package's ``launch/mesh.py``.

One process per device (SPMD): a mesh names the ranks of the default
process group along its axes, the first ``prod(shape)`` ranks in
row-major order, as ``jax.make_mesh`` takes the first devices. The caller
starts the process group (``torch.distributed.init_process_group``, NCCL
on the card, gloo on the CPU) before asking for a mesh; a rank outside a
mesh has no coordinate on it (``mesh.get_coordinate()`` is None) and
takes no part in its collectives. Nothing here is done at import.

Axes:
  single-pod : (16, 16)       ('data', 'model')    = 256 ranks
  multi-pod  : (2, 16, 16)    ('pod', 'data', 'model') = 512 ranks

The sharding rules (``launch/sharding.py``) read only a mesh's axis
sizes, so they take a :class:`MeshShape` too: the production meshes'
specs are computed without 512 ranks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ["make_production_mesh", "make_test_mesh", "make_replica_mesh",
           "batch_axes", "MESH_AXES", "MESH_SHAPES", "MeshShape",
           "axis_sizes"]

MESH_AXES = {"single": ("data", "model"), "multi": ("pod", "data", "model")}
#: the production meshes' sizes, in :data:`MESH_AXES`' order
MESH_SHAPES = {"single": (16, 16), "multi": (2, 16, 16)}


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no ranks behind it: what the
    sharding rules read. ``shape`` maps each axis name to its size, in
    order, as a JAX mesh's ``shape`` does."""
    sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, a :class:`MeshShape` or
    anything whose ``shape`` is such a mapping (a JAX mesh)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _mesh(shape: tuple, axes: tuple, device_type: str):
    """A ``DeviceMesh`` over the first ``prod(shape)`` ranks of the default
    process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError("start the process group "
                           "(torch.distributed.init_process_group) before "
                           "asking for a mesh")
    if n > dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process "
                         f"group has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_replica_mesh(n_replicas: int | None = None, *,
                      axis: str = "replica", device_type: str = "cuda"):
    """1-D data-parallel mesh for ``CompiledModel`` replica fan-out (the
    serving tier): ``n_replicas`` ranks (default: every rank of the process
    group) along one ``axis``. PointNet++ models are small enough to
    replicate whole; only the request batch shards
    (``repro_torch.launch.sharding.shard_batch``)."""
    import torch.distributed as dist
    n = dist.get_world_size() if n_replicas is None else int(n_replicas)
    return _mesh((n,), (axis,), device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    name = "multi" if multi_pod else "single"
    return _mesh(MESH_SHAPES[name], MESH_AXES[name], device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), *,
                   device_type: str = "cuda"):
    """Small mesh for tests (``device_type="cpu"`` over gloo ranks)."""
    return _mesh(tuple(shape), tuple(axes), device_type)


def batch_axes(mesh) -> tuple:
    """The mesh axes a batch dimension shards over (pod+data when
    present)."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)
