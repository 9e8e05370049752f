"""Mesh construction.

Counterpart of ``repro.launch.mesh``.  A :class:`Mesh` is axis names and a
NumPy object array of ``torch.device``s in the mesh's shape, which
``distributed.sharding`` reads as the JAX package reads a
``jax.sharding.Mesh``.

A mesh built while a ``torch.distributed`` process group is up spans the
group's ranks, one device each, and carries the
``torch.distributed.device_mesh.DeviceMesh`` over them (its dim names are
the axis names): ``Mesh.group(axis)`` is the process group of one axis.
Start the ranks with ``torchrun`` and join them with
:func:`init_distributed`.  Without a group a mesh is this process's
devices and joins nothing.

:func:`sub_mesh` cuts a run of one axis out of a mesh (a tenant's column
slice, ``distributed.tenancy``): where a process group backs the parent,
the sub-mesh carries a ``DeviceMesh`` over exactly the slice's ranks, so
every collective issued on it runs over groups of those ranks alone.  A
rank outside the slice sees the sub-mesh but holds no place in it:
``coordinate`` and ``local_device`` raise there.

A mesh on ``device="meta"`` holds placeholder devices, as many as its
shape asks for: the port's counterpart of the JAX package's
``--xla_force_host_platform_device_count=512``, on which the dry run
(``launch.dryrun``) runs the production meshes on any host.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray  # object array of torch.device, one axis per name
    axis_names: tuple[str, ...]
    device_mesh: object = None  # the DeviceMesh over a process group's ranks

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def coordinate(self) -> tuple[int, ...]:
        """This rank's place in the mesh (a process group backs it); raises
        on a rank the mesh does not hold."""
        coord = self.device_mesh.get_coordinate()
        if coord is None:
            raise ValueError(
                f"rank {dist.get_rank()} holds no place in this mesh "
                f"(ranks {self.device_mesh.mesh.flatten().tolist()})"
            )
        return tuple(coord)

    @property
    def local_device(self) -> torch.device:
        """This process's device: its rank's place in the mesh, or the
        first device where no process group backs the mesh."""
        if self.device_mesh is None:
            return self.devices.flat[0]
        return self.devices[self.coordinate()]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None where
        no process group backs the mesh)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)


def _devices(device, n: int) -> list[torch.device]:
    """The first ``n`` devices of ``device``'s type; raises if there are
    fewer (the CPU counts as one; the meta device is as many as asked)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return [dev] * n
    if dev.type == "cuda":
        have = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        have = [dev]
    if len(have) < n:
        raise RuntimeError(
            f"a mesh of {n} devices needs {n} {dev.type} devices, found {len(have)}"
        )
    return have[:n]


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device) -> Mesh:
    grid = np.empty(shape, dtype=object)
    for i, d in enumerate(_devices(device, int(np.prod(shape)))):
        grid.flat[i] = d
    return Mesh(grid, axes)


def init_distributed(device="cuda") -> torch.device:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL
    with one card a rank (``cuda:LOCAL_RANK``), or gloo on the CPU.
    Returns this rank's device.  Raises where CUDA is asked for and there
    is none, where the variables are missing, or where the group cannot
    be joined; a rank never goes on alone."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"no process group runs on {dev.type}")
    if not dist.is_initialized():
        need = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
        missing = [k for k in need if k not in os.environ]
        if missing:
            raise RuntimeError(f"init_distributed: {missing} not set (use torchrun)")
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
        )
    return dev


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], *, device="cuda"):
    """A mesh of ``shape`` (``jax.make_mesh``): over the process group's
    ranks, rank ``r`` at flat place ``r``, where a group is up (its size
    must be the mesh's); else over this process's devices."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    dev = resolve_device(device)
    if not dist.is_initialized() or dev.type == "meta":
        return _mesh(shape, axis_names, dev)
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh over a group of {world} ranks")
    grid = np.empty(shape, dtype=object)
    per_host = torch.cuda.device_count() if dev.type == "cuda" else 0
    for r in range(world):  # a host's ranks take its cards in order
        grid.flat[r] = torch.device("cuda", r % per_host) if per_host else dev
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=axis_names)
    return Mesh(grid, axis_names, dm)


def sub_mesh(mesh: Mesh, axis: str, start: int, stop: int) -> Mesh:
    """The part of ``mesh`` at places ``start:stop`` along ``axis``, with
    the same axis names.  Where a process group backs ``mesh``, its
    DeviceMesh is built over the slice's ranks: every rank of the process
    group must call this, in the same order (each group is created
    collectively); free it with :func:`free_mesh`."""
    cut = [slice(None)] * mesh.devices.ndim
    cut[mesh.axis_names.index(axis)] = slice(start, stop)
    devices = mesh.devices[tuple(cut)]
    if mesh.device_mesh is None:
        return Mesh(devices, mesh.axis_names)
    from torch.distributed.device_mesh import DeviceMesh

    ranks = mesh.device_mesh.mesh[tuple(cut)]
    dm = DeviceMesh(mesh.device_mesh.device_type, ranks, mesh_dim_names=mesh.axis_names)
    return Mesh(devices, mesh.axis_names, dm)


def free_mesh(mesh: Mesh) -> None:
    """Destroy the process groups :func:`sub_mesh` created for ``mesh``
    (on this rank: a rank outside the slice holds none); the whole group
    stays.  Call it on every rank, in the same order."""
    if mesh.device_mesh is None or mesh.device_mesh.get_coordinate() is None:
        return
    world = dist.group.WORLD
    for axis in mesh.axis_names:
        group = mesh.device_mesh.get_group(axis)
        if group is not world:
            dist.destroy_process_group(group)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """16×16 (256 cards) or 2×16×16 multi-pod (512 cards); raises when
    there are fewer (``device="meta"``: placeholders, never short).

    Axes: ("data", "model") — FSDP/DP over "data", TP over "model";
    multi-pod adds a leading pure-DP "pod" axis.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(model: int = 1, data: int | None = None, *, device="cuda") -> Mesh:
    """A (data, model) mesh over the ranks of the process group when one
    is up (``torchrun``, ``init_distributed``), else this process's one
    device: several cards are driven by a rank each."""
    dev = resolve_device(device)
    n = dist.get_world_size() if dist.is_initialized() and dev.type != "meta" else 1
    if data is None:
        data = n // model
    return make_mesh((data, model), ("data", "model"), device=device)
