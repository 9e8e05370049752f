"""Partition policies — the part of ``repro.api.policy`` the tenancy manager
calls, in the port's own copy.

A policy turns tenant demands into column widths (:meth:`widths`) and a
grant order (:meth:`order`).  Ported: ``equal`` (the paper's ⌊Y/n⌋,
Algorithm 1 verbatim) and ``proportional`` (MoCA-style demand-weighted
widths).  The other registered policies of the JAX package are not ported
yet (ROADMAP.md, "Modules to port").
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Optional, Sequence

from repro_torch.core.dnng import LayerShape
from repro_torch.core.registry import Registry


@dataclasses.dataclass(frozen=True)
class TenantDemand:
    """Policy-facing view of one tenant competing for columns.

    ``demand`` is the Opr analogue (outstanding FLOPs for a serving
    tenant); ``width_demand`` is the number of columns the tenant can use
    (None = unbounded); ``min_cols`` is a reservation floor; ``tier`` is the
    SLA class — smaller is more important; ``layer`` is the concrete next
    layer behind the demand, when the caller has one.
    """

    name: str
    demand: float = 1.0
    width_demand: Optional[int] = None
    min_cols: int = 1
    tier: int = 0
    layer: Optional[LayerShape] = None


class PartitionPolicy(abc.ABC):
    """Base class of partition policies: the demand → width core."""

    name: str = ""

    def order(self, tenants: Sequence[TenantDemand]) -> list[TenantDemand]:
        """Tenants in grant-priority order (default: heaviest demand first,
        stable — ties keep arrival order, matching Task_Assignment's sort)."""
        return sorted(tenants, key=lambda t: -t.demand)

    @abc.abstractmethod
    def widths(
        self, total_cols: int, tenants: Sequence[TenantDemand]
    ) -> dict[str, int]:
        """Target column widths per tenant for ``total_cols`` available.

        Only tenants placed this round appear in the result; every returned
        width is >= 1 and the widths sum to <= ``total_cols``.
        """


_REGISTRY = Registry("policy")


def register_policy(name: str):
    """Class decorator: make a policy constructible by name."""
    return _REGISTRY.register(name)


def get_policy(name: str, **kwargs) -> PartitionPolicy:
    """Construct a ported policy by name; an unknown or unported name raises
    a ``ValueError`` listing the ported names."""
    return _REGISTRY.get(name, **kwargs)


def resolve_policy(policy: "str | PartitionPolicy") -> PartitionPolicy:
    """Accept a registry name or a policy instance."""
    if isinstance(policy, str):
        return get_policy(policy)
    widths = getattr(policy, "widths", None)
    if callable(widths) and callable(getattr(policy, "order", None)):
        return policy
    raise ValueError(f"not a PartitionPolicy: {policy!r}")


@register_policy("equal")
class EqualPolicy(PartitionPolicy):
    """Algorithm 1 verbatim (paper Fig. 5): ⌊Y/n⌋ equal vertical slices,
    heaviest demand first."""

    def widths(
        self, total_cols: int, tenants: Sequence[TenantDemand]
    ) -> dict[str, int]:
        if not tenants or total_cols < 1:
            return {}
        n = min(len(tenants), total_cols)  # no zero-width slices
        base = total_cols // n
        return {t.name: base for t in self.order(tenants)[:n]}


def _floor_cols(t: TenantDemand) -> int:
    """Reservation floor of one tenant (at least one column)."""
    return max(1, t.min_cols)


def _admit_by_floor(
    order: Sequence[TenantDemand], total_cols: int
) -> list[TenantDemand]:
    """Admit tenants in priority order while reservation floors still fit."""
    placed: list[TenantDemand] = []
    floor_sum = 0
    for t in order:
        f = _floor_cols(t)
        if floor_sum + f > total_cols:
            continue
        placed.append(t)
        floor_sum += f
    return placed


def _largest_remainder(cols: int, tenants: Sequence[TenantDemand]) -> dict[str, int]:
    """Apportion ``cols`` to tenants ∝ demand (Hamilton's method; equal
    quotas when all demands are zero; ties → earlier tenant)."""
    total_d = sum(max(t.demand, 0.0) for t in tenants)
    if total_d > 0:
        quotas = [cols * max(t.demand, 0.0) / total_d for t in tenants]
    else:
        quotas = [cols / len(tenants)] * len(tenants)
    ws = {t.name: int(q) for t, q in zip(tenants, quotas)}
    left = cols - sum(ws.values())
    frac = sorted(range(len(tenants)), key=lambda i: (-(quotas[i] - int(quotas[i])), i))
    for i in frac[:left]:
        ws[tenants[i].name] += 1
    return ws


@register_policy("proportional")
class ProportionalPolicy(PartitionPolicy):
    """Demand-weighted widths (MoCA-style): columns are apportioned to
    tenants proportionally to ``demand`` by the largest-remainder method;
    any tenant whose share falls under its ``min_cols`` floor is pinned at
    the floor and the rest re-apportioned."""

    def widths(
        self, total_cols: int, tenants: Sequence[TenantDemand]
    ) -> dict[str, int]:
        placed = _admit_by_floor(self.order(tenants), total_cols)
        if not placed:
            return {}
        ws: dict[str, int] = {}
        free = list(placed)
        cols_left = total_cols
        while free:
            shares = _largest_remainder(cols_left, free)
            short = [t for t in free if shares[t.name] < _floor_cols(t)]
            if not short:
                ws.update(shares)
                break
            for t in short:  # pin under-floor tenants, re-apportion the rest
                ws[t.name] = _floor_cols(t)
                cols_left -= _floor_cols(t)
                free.remove(t)
        return ws
