"""Mesh and batch sharding for resize workloads over ``torch.distributed``
(the port of ``interpolate_antialiasing_tpu.parallel.sharding``).

  * **data parallel** — resize is elementwise per image, so batch sharding
    over the mesh is exact and collective-free: each rank resizes its own
    block of the batch;
  * **spatial parallel** — for images too large for one card, H is split
    across ranks with a halo exchange (see halo.py).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, which the caller starts (``init_process_group`` with an
explicit address, world size and rank; nothing here discovers a cluster).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "shard_batch", "data_parallel_resize"]


def make_mesh(shape: Sequence[int] | None = None, axis_names: Sequence[str] = ("data",),
              device_type: str = "cuda"):
    """A device mesh over the default process group's ranks; default: every
    rank on one ``data`` axis.  One rank per card (``"cuda"``) unless the
    caller asks for ``device_type="cpu"`` (gloo)."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (world,)
    need = math.prod(shape)
    if world < need:
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {need} devices, have {world}"
        )
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    return DeviceMesh(device_type, torch.arange(need).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def _axis_group(mesh, axis: str):
    """``(mesh dim, ranks on it, this rank's index, its process group)`` of
    the mesh axis named ``axis``."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    i = names.index(axis)
    return i, mesh.size(i), mesh.get_local_rank(i), mesh.get_group(i)


def _block(x: torch.Tensor, dim: int, n: int, d: int) -> torch.Tensor:
    """Rank ``d``'s block of ``dim`` split over ``n`` ranks: ``torch.chunk``'s
    ceil blocks (the last ones shorter or empty), the layout of a
    ``Shard(dim)`` DTensor and of the JAX package's ceil-padded blocks."""
    b = -(-x.shape[dim] // n)
    start = min(d * b, x.shape[dim])
    return x.narrow(dim, start, min(b, x.shape[dim] - start))


def _batch_block(x: torch.Tensor, mesh, axis: str):
    """``(this rank's block of the leading axis, placements)`` for ``x``
    held whole on every rank."""
    from torch.distributed.tensor import Replicate, Shard

    i, n, d, _ = _axis_group(mesh, axis)
    placements = [Replicate()] * mesh.ndim
    placements[i] = Shard(0)
    return _block(x, 0, n, d), tuple(placements)


def _as_dtensor(local: torch.Tensor, mesh, placements, shape):
    from torch.distributed.tensor import DTensor

    stride = tuple(math.prod(shape[k + 1:]) for k in range(len(shape)))
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def shard_batch(x: torch.Tensor, mesh, axis: str = "data"):
    """``x`` (held whole on every rank) as a DTensor with its leading
    (batch) dim sharded ``Shard(0)`` over ``axis``; each rank keeps its own
    block, nothing is sent."""
    local, placements = _batch_block(x, mesh, axis)
    return _as_dtensor(local, mesh, placements, tuple(x.shape))


def data_parallel_resize(x, size, mesh=None, axis: str = "data", **kw):
    """Batch-sharded resize: each rank resizes its block of the batch with
    the port's ``resize`` (any of its keyword arguments) and the result is a
    ``Shard(0)`` DTensor.  No collective runs.  ``x`` is a DTensor sharded
    ``Shard(0)`` over ``axis`` (as :func:`shard_batch` makes it) or a tensor
    held whole on every rank."""
    from torch.distributed.tensor import DTensor, Shard

    from ..ops.resize import resize

    mesh = mesh or make_mesh()
    if isinstance(x, DTensor):
        i = _axis_group(mesh, axis)[0]
        if x.placements[i] != Shard(0):
            raise ValueError(f"x must be sharded Shard(0) over mesh axis {axis!r}, "
                             f"got {x.placements[i]}")
        local, placements = x.to_local(), tuple(x.placements)
    else:
        local, placements = _batch_block(x, mesh, axis)
    y = resize(local, size, **kw)
    return _as_dtensor(y, mesh, placements, (x.shape[0], *y.shape[1:]))
