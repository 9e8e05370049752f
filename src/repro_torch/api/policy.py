"""Pluggable partition policies — the port's own copy of ``repro.api.policy``.

The paper's Algorithm 1 is ONE policy: equal ⌊Y/n⌋ vertical splits
(Partition_Calculation, Fig. 5 lines 15–19) plus heaviest-``Opr``-first
assignment (Task_Assignment, lines 20–27).  This module turns the two steps
into a protocol every consumer (scheduler, serving engine, tenancy manager)
programs against:

* :meth:`PartitionPolicy.split`  — cut a fully-free array into per-tenant
  vertical slices that **tile** ``[0, cols)``; the remainder goes to the
  highest-priority tenant, as in the paper.
* :meth:`PartitionPolicy.assign` — bind ready layers to offered slices.  A
  policy may *trim* a grant (a sub-slice anchored at the offered
  ``col_start``) or *decline* one (omit it).
* :meth:`PartitionPolicy.widths` / :meth:`PartitionPolicy.order` — the
  demand→width core both share; the tenancy manager calls them directly.
* :meth:`PartitionPolicy.preempt` / :meth:`PartitionPolicy.bandwidth` —
  optional hooks (never preempt, no caps by default).

Registered policies (``list_policies()``): ``equal`` (the paper verbatim,
alias ``paper``), ``proportional``, ``best_fit``, ``priority``,
``width_aware``, ``deadline_preempt``, ``moca``, and — loaded on demand from
:mod:`repro_torch.fairness` — ``drf`` and ``min_cost_flow``.
"""

from __future__ import annotations

import abc
import dataclasses
import math
from typing import Callable, Mapping, MutableMapping, Optional, Sequence

from repro_torch.core.dnng import LayerShape
from repro_torch.core.partition import (
    ArrayShape,
    Assignment,
    Partition,
    partition_calculation,
    task_assignment,
)
from repro_torch.core.registry import Registry

ReadyLayer = tuple[str, int, LayerShape]  # (tenant, layer_index, layer)


def _time_batch(time_fn, cost_cache, pairs):
    """Shared body of ``AssignContext.time_batch``/``PreemptContext
    .time_batch``: price many (layer, partition) pairs at once through the
    oracle's vectorized ``time_fn.batch`` when it has one, filling the
    round's shared ``cost_cache``; values are identical either way."""
    if time_fn is None:
        raise ValueError("context has no time_fn oracle")
    batch = getattr(time_fn, "batch", None)
    if cost_cache is None:
        if batch is not None:
            return list(batch(pairs))
        return [time_fn(layer, part) for layer, part in pairs]
    missing = [pair for pair in dict.fromkeys(pairs) if pair not in cost_cache]
    if missing:
        if batch is not None:
            vals = batch(missing)
        else:
            vals = [time_fn(layer, part) for layer, part in missing]
        for pair, v in zip(missing, vals):
            cost_cache[pair] = v
    return [cost_cache[pair] for pair in pairs]


@dataclasses.dataclass(frozen=True)
class TenantDemand:
    """Policy-facing view of one tenant competing for columns.

    ``demand`` is the Opr analogue (MACs for a layer, outstanding FLOPs for
    a serving tenant); ``width_demand`` is the number of columns the tenant
    can use (None = unbounded); ``min_cols`` is a reservation floor; ``tier``
    is the SLA class — smaller is more important; ``layer`` is the concrete
    next layer behind the demand, when the caller has one.
    """

    name: str
    demand: float = 1.0
    width_demand: Optional[int] = None
    min_cols: int = 1
    tier: int = 0
    layer: Optional[LayerShape] = None


@dataclasses.dataclass(frozen=True)
class InFlightLayer:
    """Policy-facing view of one executing layer (preemption candidate).

    ``remaining_s`` is the compute time left at ``PreemptContext.now``;
    ``fraction_done`` is the share of the layer's compute already finished
    (across all of its segments).
    """

    tenant: str
    layer_index: int
    layer: LayerShape
    partition: Partition
    compute_start: float
    compute_end: float
    remaining_s: float
    fraction_done: float


@dataclasses.dataclass(frozen=True)
class PreemptContext:
    """Runtime context for :meth:`PartitionPolicy.preempt`.

    Built by the scheduler at every rebalance point when a
    :class:`~repro_torch.core.scheduler.PreemptionModel` is armed: ``ready``
    is the waiting layer set, ``free`` the current free slices,
    ``inflight`` the preemptible layers, and ``deadlines`` the absolute SLA
    deadlines of tenants that carry one.  ``drain_s``/``stage_in_s`` price a
    candidate eviction.
    """

    array: ArrayShape
    now: float
    ready: tuple[ReadyLayer, ...]
    free: tuple[Partition, ...]
    inflight: Mapping[str, InFlightLayer]
    deadlines: Mapping[str, float]
    time_fn: Callable[[LayerShape, Partition], float]
    drain_s: Callable[[Partition], float]
    stage_in_s: Callable[[LayerShape], float]
    cost_cache: Optional[MutableMapping] = None
    # latency class per live tenant and the enforced bandwidth caps, as in
    # AssignContext
    tiers: Mapping[str, int] = dataclasses.field(default_factory=dict)
    bandwidth: Mapping[str, float] = dataclasses.field(default_factory=dict)

    def time(self, layer: LayerShape, part: Partition) -> float:
        """Memoized ``time_fn(layer, part)`` (the round's shared memo)."""
        if self.cost_cache is None:
            return self.time_fn(layer, part)
        key = (layer, part)
        try:
            return self.cost_cache[key]
        except KeyError:
            self.cost_cache[key] = cost = self.time_fn(layer, part)
            return cost

    def time_batch(self, pairs: Sequence[tuple[LayerShape, Partition]]) -> list[float]:
        """Batched :meth:`time`: one vectorized oracle pass for all pairs."""
        return _time_batch(self.time_fn, self.cost_cache, pairs)

    def preempt_cost_s(self, victim: InFlightLayer) -> float:
        """Drain + weight re-stage time for evicting ``victim`` now."""
        return self.drain_s(victim.partition) + self.stage_in_s(victim.layer)


@dataclasses.dataclass(frozen=True)
class AssignContext:
    """Runtime context the scheduler passes to :meth:`PartitionPolicy.assign`.

    ``busy`` is the current tenant→partition occupancy; ``time_fn`` is the
    backend's compute oracle; ``cost_cache`` is the round's shared
    ``(layer, partition) → seconds`` memo (query it via :meth:`time`).
    ``deadlines`` maps tenants to absolute SLA deadlines, ``tiers`` maps
    every live tenant to its latency class, and ``bandwidth`` is a live view
    of the enforced per-tenant memory caps.  All of these are state, not
    clock: policies may depend on them without breaking the scheduler's
    dirty-round skip.
    """

    array: ArrayShape
    time_fn: Optional[Callable[[LayerShape, Partition], float]] = None
    busy: Mapping[str, Partition] = dataclasses.field(default_factory=dict)
    cost_cache: Optional[MutableMapping] = None
    deadlines: Mapping[str, float] = dataclasses.field(default_factory=dict)
    tiers: Mapping[str, int] = dataclasses.field(default_factory=dict)
    bandwidth: Mapping[str, float] = dataclasses.field(default_factory=dict)

    def time(self, layer: LayerShape, part: Partition) -> float:
        """Memoized ``time_fn(layer, part)`` (falls through when no cache)."""
        if self.time_fn is None:
            raise ValueError("AssignContext has no time_fn oracle")
        if self.cost_cache is None:
            return self.time_fn(layer, part)
        key = (layer, part)
        try:
            return self.cost_cache[key]
        except KeyError:
            self.cost_cache[key] = cost = self.time_fn(layer, part)
            return cost

    def time_batch(self, pairs: Sequence[tuple[LayerShape, Partition]]) -> list[float]:
        """Batched :meth:`time`, filling the shared round cache."""
        return _time_batch(self.time_fn, self.cost_cache, pairs)


class PartitionPolicy(abc.ABC):
    """Base class + protocol for partition policies.

    Consumers rely on ``split``/``assign`` (and the tenancy manager on
    ``order``/``widths``), so third-party policies may duck-type the same
    surface without subclassing.
    """

    name: str = ""

    # -- demand -> width core ----------------------------------------------
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

    def _placements(
        self, array: ArrayShape, tenants: Sequence[TenantDemand]
    ) -> list[tuple[TenantDemand, Partition]]:
        """Cut the array per :meth:`widths`, in priority order, remainder
        to the first tenant — the shared body of split() and place()."""
        tenants = list(tenants)
        if not tenants:
            return []
        ws = self.widths(array.cols, tenants)
        placed = [t for t in self.order(tenants) if ws.get(t.name, 0) >= 1]
        if not placed:
            return []
        rem = array.cols - sum(ws[t.name] for t in placed)
        if rem < 0:
            raise ValueError(
                f"{self.name or type(self).__name__}.widths "
                f"oversubscribed {array.cols} columns: {ws}"
            )
        out: list[tuple[TenantDemand, Partition]] = []
        col = 0
        for i, t in enumerate(placed):
            w = ws[t.name] + (rem if i == 0 else 0)
            out.append((t, Partition(rows=array.rows, col_start=col, cols=w)))
            col += w
        return out

    # -- the protocol ------------------------------------------------------
    def split(
        self, array: ArrayShape, tenants: Sequence[TenantDemand]
    ) -> list[Partition]:
        """Cut the (fully free) array into per-tenant slices that tile it."""
        return [p for _, p in self._placements(array, tenants)]

    def assign(
        self,
        ready: Sequence[ReadyLayer],
        partitions: Sequence[Partition],
        ctx: AssignContext | None = None,
    ) -> list[Assignment]:
        """Bind ready layers to offered slices (default: the paper's
        Task_Assignment — heaviest ``Opr`` → largest slice, whole grants)."""
        return task_assignment(ready, partitions)

    def preempt(self, ctx: PreemptContext) -> Sequence[str]:
        """Name in-flight tenants whose layer should be evicted *now*.

        Called at every rebalance point, only when a ``PreemptionModel`` is
        armed.  The default never preempts, so every stock policy stays
        identical to the preemption-free scheduler.
        """
        return ()

    def bandwidth(self, ctx: AssignContext) -> Mapping[str, float] | None:
        """Per-tenant memory-bandwidth caps: tenant → share in ``(0, 1)`` of
        the node's DRAM bandwidth; absent tenants are uncapped.

        Called after every policy round; the caps govern every bus transfer
        until the next round.  The default returns ``None`` (no caps).
        Overrides must depend only on context state, never on a clock.
        """
        return None

    # -- conveniences ------------------------------------------------------
    def place(
        self, array: ArrayShape, tenants: Sequence[TenantDemand]
    ) -> dict[str, Partition]:
        """Bind each placed tenant to its slice of the split (priority order,
        first slice absorbs the remainder)."""
        return {t.name: p for t, p in self._placements(array, tenants)}

    def _demand_cols(self, layer: LayerShape, ctx: AssignContext | None) -> int:
        cap = ctx.array.cols if ctx is not None else layer.gemm_n
        return max(1, min(layer.gemm_n, cap))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

# "paper" is the legacy scheduler string for Algorithm 1 verbatim
_REGISTRY = Registry("policy", aliases={"paper": "equal"})
_POLICIES = _REGISTRY.items  # live dict (tests remove throwaway plugins)


def register_policy(name: str):
    """Class decorator: make a policy constructible by name."""
    return _REGISTRY.register(name)


def _load_plugin_policies() -> None:
    """Import the policy packages that register on import
    (:mod:`repro_torch.fairness`: ``drf``, ``min_cost_flow``), lazily and
    idempotently, so ``repro_torch.api`` carries no eager dependency."""
    import repro_torch.fairness  # noqa: F401  (import registers its policies)


def list_policies() -> list[str]:
    _load_plugin_policies()
    return _REGISTRY.names()


def get_policy(name: str, **kwargs) -> PartitionPolicy:
    """Construct a policy by name; an unknown name raises a ``ValueError``
    listing the registered names."""
    try:
        return _REGISTRY.get(name, **kwargs)
    except ValueError:
        if name in _REGISTRY.items or name in _REGISTRY.aliases:
            raise  # known name, bad kwargs: not a loading problem
        _load_plugin_policies()
        return _REGISTRY.get(name, **kwargs)


def resolve_policy(policy: "str | PartitionPolicy") -> PartitionPolicy:
    """Accept a registry name (or legacy alias) or a policy instance."""
    if isinstance(policy, str):
        return get_policy(policy)
    if callable(getattr(policy, "split", None)) and callable(
        getattr(policy, "assign", None)
    ):
        return policy
    raise ValueError(f"not a PartitionPolicy: {policy!r}")


# ---------------------------------------------------------------------------
# implementations
# ---------------------------------------------------------------------------


@register_policy("equal")
class EqualPolicy(PartitionPolicy):
    """Algorithm 1 verbatim (paper Fig. 5): ⌊Y/n⌋ equal vertical slices,
    remainder to the first slice, heaviest-``Opr`` layer → largest slice,
    grants are whole slices."""

    def widths(
        self, total_cols: int, tenants: Sequence[TenantDemand]
    ) -> dict[str, int]:
        if not tenants or total_cols < 1:
            return {}
        n = min(len(tenants), total_cols)  # no zero-width slices
        base = total_cols // n
        return {t.name: base for t in self.order(tenants)[:n]}

    def split(
        self, array: ArrayShape, tenants: Sequence[TenantDemand]
    ) -> list[Partition]:
        # the paper's Partition_Calculation, so `equal` is provably the paper
        if not tenants:
            return []
        return partition_calculation(array, len(tenants))


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


def _tiered_widths(
    placed: Sequence[TenantDemand], total_cols: int, floor_of
) -> dict[str, int]:
    """Floors for every placed tenant, the spare columns split equally,
    extras to the first (highest-priority) tenants."""
    spare = total_cols - sum(floor_of(t) for t in placed)
    per, extra = divmod(spare, len(placed))
    return {
        t.name: floor_of(t) + per + (1 if i < extra else 0)
        for i, t in enumerate(placed)
    }


def _assign_sorted(
    ready: Sequence[ReadyLayer], partitions: Sequence[Partition], key
) -> list[Assignment]:
    """Ready layers sorted by ``key``, zipped onto the offered slices
    largest first (whole grants)."""
    layers = sorted(ready, key=key)
    parts = sorted(partitions, key=lambda p: p.n_pes, reverse=True)
    return [
        Assignment(tenant=tenant, layer_index=idx, layer=layer, partition=part)
        for (tenant, idx, layer), part in zip(layers, parts)
    ]


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


@register_policy("best_fit")
class BestFitPolicy(PartitionPolicy):
    """Width-demand-aware fitting: splits cap each slice near the tenant's
    usable width and assignment gives each layer the *smallest* offered
    slice that fits it, trimmed to its demand."""

    def widths(
        self, total_cols: int, tenants: Sequence[TenantDemand]
    ) -> dict[str, int]:
        placed = _admit_by_floor(self.order(tenants), total_cols)
        if not placed:
            return {}
        base = max(1, total_cols // len(placed))
        ws = {}
        for t in placed:
            wd = t.width_demand if t.width_demand else base
            ws[t.name] = max(_floor_cols(t), min(base, wd))
        # floors can push the fair-share sum over the array: shave the
        # lowest-priority tenants back toward their floors
        over = sum(ws.values()) - total_cols
        for t in reversed(placed):
            if over <= 0:
                break
            cut = min(ws[t.name] - _floor_cols(t), over)
            ws[t.name] -= cut
            over -= cut
        leftover = total_cols - sum(ws.values())
        # grow under-served tenants (demand order) up to their width demand
        changed = True
        while leftover > 0 and changed:
            changed = False
            for t in placed:
                if leftover <= 0:
                    break
                wd = t.width_demand or total_cols
                if ws[t.name] < wd:
                    grow = min(leftover, wd - ws[t.name])
                    ws[t.name] += grow
                    leftover -= grow
                    changed = True
        return ws

    def assign(
        self,
        ready: Sequence[ReadyLayer],
        partitions: Sequence[Partition],
        ctx: AssignContext | None = None,
    ) -> list[Assignment]:
        layers = sorted(ready, key=lambda t: t[2].opr, reverse=True)
        avail = sorted(partitions, key=lambda p: (p.n_pes, p.col_start))
        out: list[Assignment] = []
        for tenant, idx, layer in layers:
            if not avail:
                break
            demand = self._demand_cols(layer, ctx)
            pick = next((p for p in avail if p.cols >= demand), None)
            if pick is None:
                pick = max(avail, key=lambda p: p.n_pes)
            avail.remove(pick)
            got = Partition(
                rows=pick.rows, col_start=pick.col_start, cols=min(pick.cols, demand)
            )
            out.append(
                Assignment(tenant=tenant, layer_index=idx, layer=layer, partition=got)
            )
        return out


@register_policy("priority")
class PriorityPolicy(PartitionPolicy):
    """SLA tiers with preemption-free reservation floors.

    Tenants are served tier-by-tier (smaller tier = more important, demand
    breaks ties); every placed tenant gets its ``min_cols`` floor, leftover
    columns are split equally with extras to the highest tiers, and
    ``assign`` offers the largest slices to the highest tiers.
    ``tiers``/``floors`` override per-tenant metadata by name.
    """

    def __init__(
        self,
        tiers: Mapping[str, int] | None = None,
        floors: Mapping[str, int] | None = None,
    ):
        self.tiers = dict(tiers or {})
        self.floors = dict(floors or {})

    def _tier(self, name: str, default: int = 0) -> int:
        return self.tiers.get(name, default)

    def _floor(self, t: TenantDemand) -> int:
        return max(1, self.floors.get(t.name, t.min_cols))

    def order(self, tenants: Sequence[TenantDemand]) -> list[TenantDemand]:
        return sorted(tenants, key=lambda t: (self._tier(t.name, t.tier), -t.demand))

    def widths(
        self, total_cols: int, tenants: Sequence[TenantDemand]
    ) -> dict[str, int]:
        placed: list[TenantDemand] = []
        floor_sum = 0
        for t in self.order(tenants):
            f = self._floor(t)
            if floor_sum + f > total_cols:
                continue  # floor unsatisfiable this round: tenant waits
            placed.append(t)
            floor_sum += f
        if not placed:
            return {}
        return _tiered_widths(placed, total_cols, self._floor)

    def assign(
        self,
        ready: Sequence[ReadyLayer],
        partitions: Sequence[Partition],
        ctx: AssignContext | None = None,
    ) -> list[Assignment]:
        return _assign_sorted(
            ready, partitions, key=lambda t: (self._tier(t[0]), -t[2].opr)
        )


@register_policy("width_aware")
class WidthAwarePolicy(EqualPolicy):
    """Equal splits, but (i) a grant is trimmed to the layer's usable width
    ``min(gemm_n, cols)``, and (ii) *hold-for-width* — a layer declines a
    sliver under half its demand whose runtime would exceed 2× the
    demand-width runtime, as long as another tenant is computing (a future
    merge event is then guaranteed, so no deadlock)."""

    def assign(
        self,
        ready: Sequence[ReadyLayer],
        partitions: Sequence[Partition],
        ctx: AssignContext | None = None,
    ) -> list[Assignment]:
        matched = task_assignment(ready, partitions)
        self._prime_decline_probes(matched, ctx)
        out: list[Assignment] = []
        for a in matched:
            if self._declines(a.layer, a.partition.cols, ctx):
                continue
            w = min(a.partition.cols, self._demand_cols(a.layer, ctx))
            out.append(
                dataclasses.replace(
                    a,
                    partition=Partition(
                        rows=a.partition.rows, col_start=a.partition.col_start, cols=w
                    ),
                )
            )
        return out

    def _prime_decline_probes(
        self, matched: Sequence[Assignment], ctx: AssignContext | None
    ) -> None:
        """Batch-price the round's hold-for-width probes (sliver and
        demand-width runtimes) in one vectorized oracle pass."""
        if ctx is None or ctx.time_fn is None or not ctx.busy:
            return
        rows = ctx.array.rows
        pairs = []
        for a in matched:
            demand = self._demand_cols(a.layer, ctx)
            if a.partition.cols * 2 < demand:
                pairs.append(
                    (a.layer, Partition(rows=rows, col_start=0, cols=a.partition.cols))
                )
                pairs.append((a.layer, Partition(rows=rows, col_start=0, cols=demand)))
        if pairs:
            ctx.time_batch(pairs)

    def _declines(
        self, layer: LayerShape, slice_cols: int, ctx: AssignContext | None
    ) -> bool:
        if ctx is None or ctx.time_fn is None or not ctx.busy:
            return False
        demand = self._demand_cols(layer, ctx)
        if slice_cols * 2 >= demand:
            return False
        rows = ctx.array.rows
        t_here = ctx.time(layer, Partition(rows=rows, col_start=0, cols=slice_cols))
        t_want = ctx.time(layer, Partition(rows=rows, col_start=0, cols=demand))
        return t_here > 2.0 * t_want


@register_policy("deadline_preempt")
class DeadlinePreemptPolicy(EqualPolicy):
    """Equal splits + deadline-driven preemption (MoCA-style runtime
    adaptation, arXiv:2305.05843 §IV).

    With no deadline pressure this schedules exactly like ``equal``.  The
    :meth:`preempt` hook fires when a ready tenant is *pressured* (waiting
    for the earliest in-flight completion would bust its deadline, ``slack
    < slack_factor × (wait + own runtime)``, while acting now can still
    meet it) and the array has no free columns: the in-flight layer with
    the weakest claim is evicted, provided its remaining compute exceeds
    ``min_gain_factor ×`` the eviction overhead.
    """

    def __init__(self, slack_factor: float = 1.25, min_gain_factor: float = 1.5):
        self.slack_factor = slack_factor
        self.min_gain_factor = min_gain_factor

    def preempt(self, ctx: PreemptContext) -> Sequence[str]:
        if ctx.free or not ctx.inflight:
            return ()  # free columns exist: let assign() place the layer
        wait_s = min(v.remaining_s for v in ctx.inflight.values())
        fair = Partition(
            rows=ctx.array.rows,
            col_start=0,
            cols=max(1, ctx.array.cols // (len(ctx.inflight) + 1)),
        )
        # fair-share runtime of every deadline holder, in one oracle pass
        holders = [
            (tenant, layer)
            for tenant, _idx, layer in ctx.ready
            if tenant in ctx.deadlines
        ]
        if not holders:
            return ()
        ests = ctx.time_batch([(layer, fair) for _, layer in holders])
        pressured = []
        for (tenant, _layer), est in zip(holders, ests):
            slack = ctx.deadlines[tenant] - ctx.now
            if slack <= est:
                continue  # hopeless even with an instant grant
            if slack < self.slack_factor * (wait_s + est):
                pressured.append((slack, tenant))
        if not pressured:
            return ()
        urgent_slack = min(pressured)[0]
        return self._pick_victims(ctx, urgent_slack)

    def assign(
        self,
        ready: Sequence[ReadyLayer],
        partitions: Sequence[Partition],
        ctx: AssignContext | None = None,
    ) -> list[Assignment]:
        """Earliest-deadline-first assignment (deadline-less tenants follow
        every deadline holder, heaviest ``Opr`` first)."""
        dls = ctx.deadlines if ctx is not None else {}
        return _assign_sorted(
            ready, partitions, key=lambda t: (dls.get(t[0], math.inf), -t[2].opr)
        )

    def _pick_victims(self, ctx: PreemptContext, urgent_slack: float) -> Sequence[str]:
        victims = []
        for v in ctx.inflight.values():
            v_dl = ctx.deadlines.get(v.tenant)
            if v_dl is not None and 0.0 < v_dl - ctx.now <= urgent_slack:
                # salvageable and at least as urgent: never invert SLAs
                # (victims past their deadline miss either way)
                continue
            if v.remaining_s <= self.min_gain_factor * ctx.preempt_cost_s(v):
                continue  # nearly done / tiny layer: eviction buys nothing
            victims.append((-v.remaining_s, v.tenant))
        if not victims:
            return ()
        return (min(victims)[1],)


@register_policy("moca")
class MocaPolicy(PartitionPolicy):
    """MoCA-style joint compute + memory partitioning per latency class
    (Kim et al., 2023).

    **Compute side** — priority-by-tier: every placed tenant gets its
    ``min_cols`` floor, leftover columns are split equally with extras to
    the highest tiers, and ``assign`` hands the largest slices to the most
    urgent (lowest-tier, then heaviest) layers.

    **Memory side** — :meth:`bandwidth`: while a tier-0 tenant is live
    alongside batch (tier > 0) tenants, each batch tenant is capped at
    ``max(min_share, (1 - tier0_guarantee) / n_batch)`` of the node's DRAM
    bandwidth.  With no tier mix no caps apply.  The hook reads only
    ``ctx.tiers``, never the clock.
    """

    def __init__(self, tier0_guarantee: float = 0.7, min_share: float = 0.1):
        if not 0.0 <= tier0_guarantee < 1.0:
            raise ValueError(
                f"tier0_guarantee must be in [0, 1), got {tier0_guarantee}"
            )
        if not 0.0 < min_share <= 1.0:
            raise ValueError(f"min_share must be in (0, 1], got {min_share}")
        self.tier0_guarantee = tier0_guarantee
        self.min_share = min_share

    def order(self, tenants: Sequence[TenantDemand]) -> list[TenantDemand]:
        return sorted(tenants, key=lambda t: (t.tier, -t.demand))

    def widths(
        self, total_cols: int, tenants: Sequence[TenantDemand]
    ) -> dict[str, int]:
        placed = _admit_by_floor(self.order(tenants), total_cols)
        if not placed:
            return {}
        return _tiered_widths(placed, total_cols, _floor_cols)

    def assign(
        self,
        ready: Sequence[ReadyLayer],
        partitions: Sequence[Partition],
        ctx: AssignContext | None = None,
    ) -> list[Assignment]:
        tiers = ctx.tiers if ctx is not None else {}
        return _assign_sorted(
            ready, partitions, key=lambda t: (tiers.get(t[0], 0), -t[2].opr)
        )

    def bandwidth(self, ctx: AssignContext) -> dict[str, float] | None:
        tiers = ctx.tiers
        if not tiers:
            return None
        batch = [name for name, tier in tiers.items() if tier > 0]
        if not batch or len(batch) == len(tiers):
            return None  # no tier mix: nothing to protect, nothing to cap
        share = max(self.min_share, (1.0 - self.tier0_guarantee) / len(batch))
        if share >= 1.0:
            return None
        return {name: share for name in batch}
