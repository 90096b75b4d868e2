"""Device meshes and the data-parallel placement of the path axis, the
counterpart of ``dnnpde_tpu/parallel/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the group that :func:`~dnnpde_tpu_torch.parallel.distributed.init_distributed`
joined, one rank per mesh member, with the dim name "dp". On it the path
(batch) axis M is data-parallel:

- every rank draws the whole batch of increments (and X0) from the
  trainer's generator, as the JAX Trainer draws globally, and keeps its
  rows, so a sharded run sees the unsharded run's numbers;
- the loss is a sum over paths, so the loss and the gradients are summed
  over "dp" by one all-reduce per iteration;
- parameters and optimizer state are replicated and stay bitwise equal on
  every rank.

The mesh spans the whole group: a mesh smaller than the world is not
supported (the ranks outside it would have no part in the collectives) and
raises, as a mesh larger than the world does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dnnpde_tpu_torch.runtime import default_device

DP_AXIS = "dp"


def world_mesh(shape: tuple, names: tuple, devices=None) -> DeviceMesh:
    """A mesh of ``shape`` (dim names ``names``) over all ranks of the
    group, in rank order."""
    kind = default_device(devices).type
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the process group: call init_distributed() first")
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= int(s)
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} available")
    if n < world:
        raise ValueError(
            f"a mesh of {n} devices over a group of {world} ranks is not supported: "
            "the mesh spans the whole group")
    return DeviceMesh(kind, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_mesh(
    n_devices: Optional[int] = None,
    devices=None,
    axis_name: str = DP_AXIS,
) -> DeviceMesh:
    """1-D data-parallel mesh over ``n_devices`` ranks (default: all).

    ``devices`` is the device of the ranks' tensors: None for the cards
    (raises without CUDA), "cpu" for the CPU."""
    n = dist.get_world_size() if n_devices is None and dist.is_initialized() else n_devices
    return world_mesh((1 if n is None else int(n),), (axis_name,), devices)


def axis_size(mesh: Optional[DeviceMesh], axis_name: str = DP_AXIS) -> int:
    """The size of ``axis_name`` in ``mesh`` (1 when absent or no mesh)."""
    if mesh is None or axis_name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def batch_sharding(mesh: DeviceMesh, axis_name: str = DP_AXIS):
    """The placement of the leading (path/batch) axis over the mesh:
    ``Shard(0)``."""
    from torch.distributed.tensor import Shard  # imports sympy: ~1 s

    return Shard(0)


def replicated(mesh: DeviceMesh):
    """The placement of a replicated tensor: ``Replicate()``."""
    from torch.distributed.tensor import Replicate

    return Replicate()


def check_divisible(M: int, mesh: DeviceMesh, axis_name: str = DP_AXIS) -> None:
    n = axis_size(mesh, axis_name)
    if M % n != 0:
        raise ValueError(
            f"batch size M={M} must be divisible by mesh axis {axis_name!r} size {n}")
