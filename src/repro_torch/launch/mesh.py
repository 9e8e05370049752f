"""Mesh construction.

Counterpart of ``repro.launch.mesh``.  A :class:`Mesh` is a description —
axis names and a NumPy object array of ``torch.device``s in the mesh's
shape — that ``distributed.sharding`` reads as the JAX package reads a
``jax.sharding.Mesh``.  Building one allocates nothing and joins no
process group.

A mesh on ``device="meta"`` holds placeholder devices, as many as its
shape asks for: the port's counterpart of the JAX package's
``--xla_force_host_platform_device_count=512``, on which the dry run
(``launch.dryrun``) traces the production meshes on any host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray  # object array of torch.device, one axis per name
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return self.devices.size


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


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """16×16 (256 cards) or 2×16×16 multi-pod (512 cards); raises when
    there are fewer (``device="meta"``: placeholders, never short).

    Axes: ("data", "model") — FSDP/DP over "data", TP over "model";
    multi-pod adds a leading pure-DP "pod" axis.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(model: int = 1, data: int | None = None, *, device="cuda") -> Mesh:
    """A (data, model) mesh over the devices that exist: every card, or the
    CPU as one device."""
    n = torch.cuda.device_count() if resolve_device(device).type == "cuda" else 1
    if data is None:
        data = n // model
    return _mesh((data, model), ("data", "model"), device)
