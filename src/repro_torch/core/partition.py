"""Algorithm 1's partition state (paper Fig. 5) — the port's own copy.

Counterpart of ``repro.core.partition``: the systolic array ``PE(x, y)`` is
split **vertically only** — every partition spans all rows and a contiguous
range of columns.  :func:`partition_calculation` is ``PE(x', y') = (PE_x,
⌊PE_y / n⌋)`` (Fig. 5 lines 15–19); :class:`PartitionSet` is the mutable
column-interval state with merge-on-free (§3.3).  The tenancy manager
drives it with device columns.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArrayShape:
    """Systolic-array geometry PE(x, y): x rows × y columns."""

    rows: int
    cols: int

    def __post_init__(self) -> None:
        if self.rows < 1 or self.cols < 1:
            raise ValueError(f"invalid array shape {self.rows}x{self.cols}")


@dataclasses.dataclass(frozen=True)
class Partition:
    """A vertical slice: all rows × columns [col_start, col_start+cols)."""

    rows: int
    col_start: int
    cols: int

    def __post_init__(self) -> None:
        if self.cols < 1 or self.col_start < 0 or self.rows < 1:
            raise ValueError(f"invalid partition {self!r}")

    @property
    def col_end(self) -> int:
        return self.col_start + self.cols

    @property
    def n_pes(self) -> int:
        return self.rows * self.cols

    def adjacent(self, other: "Partition") -> bool:
        return self.col_end == other.col_start or other.col_end == self.col_start

    def merge(self, other: "Partition") -> "Partition":
        if not self.adjacent(other):
            raise ValueError(f"cannot merge non-adjacent {self} and {other}")
        return Partition(
            rows=self.rows,
            col_start=min(self.col_start, other.col_start),
            cols=self.cols + other.cols,
        )

    def __str__(self) -> str:  # matches the paper's "128x16" notation
        return f"{self.rows}x{self.cols}@{self.col_start}"


def partition_calculation(array: ArrayShape, n_available: int) -> list[Partition]:
    """Fig. 5 lines 15–19: split into ``n_available`` equal vertical slices.

    ``PE_x' = PE_x`` (rows untouched); ``PE_y' = ⌊PE_y / n⌋``.  Any remainder
    columns are given to the *first* partition.
    """
    if n_available < 1:
        raise ValueError("n_available must be >= 1")
    n = min(n_available, array.cols)  # cannot have zero-width partitions
    base = array.cols // n
    rem = array.cols - base * n
    parts: list[Partition] = []
    col = 0
    for i in range(n):
        width = base + (rem if i == 0 else 0)
        parts.append(Partition(rows=array.rows, col_start=col, cols=width))
        col += width
    return parts


class PartitionSet:
    """Mutable free/busy column-interval state with merge-on-free (§3.3).

    Invariants (checked by :meth:`check`): free + busy intervals exactly tile
    [0, cols) with no overlap, and free intervals are maximal after any
    public mutation — merging is eager, as in the paper.
    """

    def __init__(self, array: ArrayShape):
        self.array = array
        self._free: list[Partition] = [
            Partition(rows=array.rows, col_start=0, cols=array.cols)
        ]
        self._busy: dict[str, Partition] = {}  # tenant -> partition

    # -- queries -----------------------------------------------------------
    @property
    def free_partitions(self) -> list[Partition]:
        return sorted(self._free, key=lambda p: p.col_start)

    @property
    def busy_partitions(self) -> dict[str, Partition]:
        return dict(self._busy)

    def largest_free(self) -> Optional[Partition]:
        return max(self._free, key=lambda p: p.n_pes, default=None)

    @property
    def utilization(self) -> float:
        busy = sum(p.n_pes for p in self._busy.values())
        return busy / (self.array.rows * self.array.cols)

    # -- mutations ----------------------------------------------------------
    def allocate(self, tenant: str, cols: int) -> Partition:
        """Carve ``cols`` columns for ``tenant`` from the smallest free slice
        that fits (best fit keeps big slices whole)."""
        if tenant in self._busy:
            raise ValueError(f"tenant {tenant!r} already holds {self._busy[tenant]}")
        slot = next(
            (p for p in sorted(self._free, key=lambda p: p.n_pes) if p.cols >= cols),
            None,
        )
        if slot is None:
            raise ValueError(
                f"no free slice with {cols} columns (free={self.free_partitions})"
            )
        self._free.remove(slot)
        got = Partition(rows=slot.rows, col_start=slot.col_start, cols=cols)
        if slot.cols > cols:
            rest = Partition(
                rows=slot.rows, col_start=slot.col_start + cols, cols=slot.cols - cols
            )
            self._free.append(rest)
        self._busy[tenant] = got
        return got

    def allocate_exact(self, tenant: str, part: Partition) -> Partition:
        """Claim an exact free slice."""
        if tenant in self._busy:
            raise ValueError(f"tenant {tenant!r} already holds a partition")
        for p in self._free:
            if p.col_start <= part.col_start and p.col_end >= part.col_end:
                self._free.remove(p)
                if p.col_start < part.col_start:
                    left = part.col_start - p.col_start
                    self._free.append(
                        Partition(rows=p.rows, col_start=p.col_start, cols=left)
                    )
                if p.col_end > part.col_end:
                    right = p.col_end - part.col_end
                    self._free.append(
                        Partition(rows=p.rows, col_start=part.col_end, cols=right)
                    )
                self._busy[tenant] = part
                return part
        raise ValueError(f"{part} is not inside any free slice")

    def free(self, tenant: str) -> Partition:
        """Release a tenant's partition and eagerly merge adjacent free slices."""
        part = self._busy.pop(tenant, None)
        if part is None:
            raise KeyError(f"tenant {tenant!r} holds no partition")
        self._free.append(part)
        self._merge_free()
        return part

    def _merge_free(self) -> None:
        self._free.sort(key=lambda p: p.col_start)
        merged: list[Partition] = []
        for p in self._free:
            if merged and merged[-1].col_end == p.col_start:
                merged[-1] = merged[-1].merge(p)
            else:
                merged.append(p)
        self._free = merged

    # -- invariant check ------------------------------------------------------
    def check(self) -> None:
        ivals = sorted(
            [(p.col_start, p.col_end, "free") for p in self._free]
            + [(p.col_start, p.col_end, t) for t, p in self._busy.items()]
        )
        cursor = 0
        for s, e, _tag in ivals:
            if s != cursor:
                raise AssertionError(f"gap/overlap at column {cursor}: {ivals}")
            cursor = e
        if cursor != self.array.cols:
            raise AssertionError(f"intervals end at {cursor} != {self.array.cols}")
        frees = sorted(self._free, key=lambda p: p.col_start)
        for a, b in itertools.pairwise(frees):
            if a.col_end == b.col_start:
                raise AssertionError(f"unmerged adjacent free slices {a},{b}")
