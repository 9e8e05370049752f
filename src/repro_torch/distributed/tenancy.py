"""Device-level multi-tenancy — Algorithm 1 applied to a grid of cards.

Counterpart of ``TenantMeshManager`` in ``repro.distributed.tenancy``.  One
resource pool (the columns of a device grid ≙ the systolic array's PE
columns) is *vertically partitioned* into contiguous per-tenant slices,
sized by a pluggable policy from load and merged when tenants drain.  The
JAX version partitions a ``jax.sharding.Mesh``; here the grid is a NumPy
object array of ``torch.device``s shaped (rows, columns), and a tenant's
sub-grid is the slice of its columns.  One card is a (1, 1) grid.

Fault tolerance: ``mark_unhealthy(col)`` removes a device column from
service; affected tenants are re-placed on the next rebalance.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.policy import TenantDemand, resolve_policy
from repro_torch.core.partition import ArrayShape, Partition, PartitionSet


def device_grid(device: str | torch.device, cols: int = 1) -> np.ndarray:
    """A (1, cols) grid whose every column is ``device`` — one card seen as
    ``cols`` columns (or, on the CPU, the test rig's stand-in grid)."""
    grid = np.empty((1, cols), dtype=object)
    for c in range(cols):
        grid[0, c] = torch.device(device)
    return grid


@dataclasses.dataclass
class Tenant:
    """One admitted model/service occupying a column slice of the grid."""

    name: str
    demand: float  # load estimate (≙ Opr of Algorithm 1)
    min_cols: int = 1  # e.g. memory floor: params must fit
    tier: int = 0  # SLA class (0 = top)
    partition: Partition | None = None


class TenantMeshManager:
    """Dynamic vertical partitioning of a device grid among tenants.

    ``devices`` is a 2-D object array of ``torch.device`` (rows, columns);
    ``policy`` (a registry name or instance, default ``"equal"``) decides
    target widths and grant order at every :meth:`rebalance`; the
    free-slice carving, unhealthy-column fencing and merge-on-free
    mechanics are policy-independent.
    """

    def __init__(self, devices: np.ndarray, policy="equal"):
        if devices.ndim != 2:
            raise ValueError(f"devices must be (rows, cols), got {devices.shape}")
        self.devices = devices
        rows, n_cols = devices.shape
        self._pset = PartitionSet(ArrayShape(rows=max(rows, 1), cols=n_cols))
        self._tenants: dict[str, Tenant] = {}
        self._unhealthy: set[int] = set()
        self.policy = policy  # resolved lazily (str | PartitionPolicy)

    # -- queries -----------------------------------------------------------
    @property
    def n_cols(self) -> int:
        return self._pset.array.cols

    def tenant(self, name: str) -> Tenant:
        return self._tenants[name]

    def tenants(self) -> list[Tenant]:
        return list(self._tenants.values())

    def utilization(self) -> float:
        return self._pset.utilization

    def submesh(self, name: str) -> np.ndarray:
        """The devices of a tenant's column slice (its sub-accelerator)."""
        t = self._tenants[name]
        if t.partition is None:
            raise ValueError(f"tenant {name!r} holds no partition")
        return self.devices[:, t.partition.col_start : t.partition.col_end]

    # -- admission / release ------------------------------------------------
    def admit(
        self, name: str, demand: float, min_cols: int = 1, tier: int = 0
    ) -> Tenant:
        """Queue a tenant; slices are handed out by :meth:`rebalance`."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already admitted")
        if min_cols > self.n_cols:
            raise ValueError(f"min_cols {min_cols} exceeds grid width {self.n_cols}")
        t = Tenant(name=name, demand=demand, min_cols=min_cols, tier=tier)
        self._tenants[name] = t
        return t

    def release(self, name: str) -> None:
        """Tenant drains: free its slice and merge (Fig. 5 merge-on-free)."""
        t = self._tenants.pop(name)
        if t.partition is not None:
            self._pset.free(name)
        self._pset.check()

    def mark_unhealthy(self, col: int) -> list[str]:
        """Remove a device column from service; returns evicted tenants."""
        if not (0 <= col < self.n_cols):
            raise ValueError(f"column {col} out of range")
        self._unhealthy.add(col)
        evicted = []
        for name, t in self._tenants.items():
            if t.partition and t.partition.col_start <= col < t.partition.col_end:
                self._pset.free(name)
                t.partition = None
                evicted.append(name)
        return evicted

    def mark_healthy(self, col: int) -> None:
        self._unhealthy.discard(col)

    # -- Algorithm 1, policy-generalised ------------------------------------
    def rebalance(self, policy=None) -> dict[str, Partition]:
        """(Re-)run the policy's Partition_Calculation + Task_Assignment.

        All slices are dropped and re-cut; unhealthy columns are fenced off
        as permanently-busy pseudo-tenants.  ``policy`` overrides the
        manager's default for this round.
        """
        pol = resolve_policy(policy if policy is not None else self.policy)

        # reset: drop every grant, rebuild the interval state from scratch
        for t in self._tenants.values():
            t.partition = None
        self._pset = PartitionSet(self._pset.array)
        for col in sorted(self._unhealthy):
            self._pset.allocate_exact(
                f"__dead{col}",
                Partition(rows=self._pset.array.rows, col_start=col, cols=1),
            )

        if not self._tenants:
            return {}
        avail = self.n_cols - len(self._unhealthy)
        demands = [
            TenantDemand(name=t.name, demand=t.demand, min_cols=t.min_cols, tier=t.tier)
            for t in self._tenants.values()
        ]
        widths = pol.widths(avail, demands) if avail >= 1 else {}

        out: dict[str, Partition] = {}
        for d in pol.order(demands):
            width = widths.get(d.name, 0)
            if width < 1:
                continue  # over-subscribed: tenant waits for a free round
            t = self._tenants[d.name]
            width = max(width, t.min_cols)
            # policy order: grant from the largest free slice, clamped to
            # what is actually free
            free = self._pset.largest_free()
            if free is None:
                continue
            width = min(width, free.cols)
            if width < t.min_cols:
                continue
            got = self._pset.allocate_exact(
                t.name,
                Partition(rows=free.rows, col_start=free.col_start, cols=width),
            )
            t.partition = got
            out[t.name] = got
        self._pset.check()
        return out

    def grow_into_free(self) -> dict[str, Partition]:
        """Merge-accelerate (paper §3.3): expand tenants adjacent to free
        slices, heaviest first, without moving anyone."""
        grown: dict[str, Partition] = {}
        for t in sorted(self._tenants.values(), key=lambda t: t.demand, reverse=True):
            if t.partition is None:
                continue
            for f in self._pset.free_partitions:
                if self._unhealthy & set(range(f.col_start, f.col_end)):
                    continue
                if f.adjacent(t.partition):
                    self._pset.free(t.name)
                    merged = t.partition.merge(f)
                    # re-claim the merged span (consumes the free slice)
                    self._pset.allocate_exact(t.name, merged)
                    t.partition = merged
                    grown[t.name] = merged
                    break
        self._pset.check()
        return grown
