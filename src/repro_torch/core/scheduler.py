"""Event-driven multi-tenant scheduler — Algorithm 1's runtime dynamics (§3.3).

The port's own copy of ``repro.core.scheduler``.  It drives
:mod:`repro_torch.core.partition` over time:

* the **first** layer of the **first** DNNG runs on the whole array
  (Fig. 5 lines 5–6);
* when several DNNGs are waiting, the array is split by the policy and ready
  layers are bound heaviest-first (lines 8–12);
* a tenant executes its layers sequentially (DAG order); when a layer
  finishes, its partition is released, adjacent free slices **merge**, and
  assignment re-runs — so surviving tenants inherit wider partitions
  (Fig. 9(c,d): 128×16 → 128×32 → 128×64 → 128×128).

Layer lifecycle (Scale-Sim's non-overlapped DRAM model):

    assign → [bus] stage-in (weights+IFMap DRAM→SRAM) → compute → [bus]
    stage-out (OFMap SRAM→DRAM) → release partition

The DRAM bus is a shared FCFS resource: tenant A computes while tenant B
stages, where the sequential baseline idles the whole array.  The other
slack pool is column slack: layers with ``N < array cols`` idle columns the
baseline wastes and concurrent tenants reclaim.

The scheduler takes a ``time_fn(layer, partition) -> seconds`` compute
oracle and an optional :class:`StageModel`.  The grant rule — how a free
array is split and which ready layer takes which slice — is a
:class:`repro_torch.api.policy.PartitionPolicy` or a registry name; the
legacy string ``"paper"`` is an alias for ``"equal"``, Algorithm 1 verbatim.
Everything here is host Python: the event heap, its ``itertools.count``
tie-break and the dict iteration order are the reference's, so the trace is
the same floats.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Sequence

from repro_torch.core.dnng import DNNG, LayerShape
from repro_torch.core.partition import ArrayShape, Partition, PartitionSet

TimeFn = Callable[[LayerShape, Partition], float]


@dataclasses.dataclass(frozen=True)
class StageModel:
    """DRAM staging times for a layer (shared-bus FCFS service times)."""

    dram_bw_bytes: float = 64e9
    bytes_per_elem: int = 2

    def stage_in_s(self, layer: LayerShape) -> float:
        elems = layer.gemm_k * layer.gemm_n + layer.gemm_m * layer.gemm_k
        return elems * self.bytes_per_elem / self.dram_bw_bytes

    def stage_out_s(self, layer: LayerShape) -> float:
        return layer.gemm_m * layer.gemm_n * self.bytes_per_elem / self.dram_bw_bytes


@dataclasses.dataclass(frozen=True)
class PreemptionModel:
    """Cost model of preempting an in-flight layer.

    The partition's in-array partial sums (one fp32 accumulator per PE of
    the column group) are drained over the shared bus before the columns
    can be handed to another tenant.  The victim pays the normal
    :class:`StageModel` stage-in again on resume (stationary weights are
    gone once the columns are reassigned).  ``fixed_overhead_s`` is the
    control-path cost of quiescing the column group, paid once per
    preemption — the whole cost when a layer is caught during stage-in.
    """

    dram_bw_bytes: float = 64e9
    psum_bytes_per_elem: int = 4  # partial sums are fp32 accumulators
    fixed_overhead_s: float = 2e-6

    def drain_s(self, part: Partition) -> float:
        psum_bytes = part.n_pes * self.psum_bytes_per_elem
        return self.fixed_overhead_s + psum_bytes / self.dram_bw_bytes


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One executed layer *segment*: who, what, where, when (Fig. 9(c,d)).

    ``start``/``end`` bound the full lifecycle on the partition;
    ``compute_start``/``compute_end`` bound the PE-array-active phase.
    Without preemption every layer is one segment with ``fraction == 1.0``
    and both flags False.  A preempted layer emits one event per executed
    segment: ``fraction`` is the share of the layer's compute done in it
    (fractions sum to 1.0), ``preempted`` marks a segment that ended in a
    drain, and ``resumed`` one that began with a weight re-stage.
    """

    tenant: str
    layer_index: int
    layer_name: str
    partition: Partition
    start: float
    end: float
    compute_start: float
    compute_end: float
    fraction: float = 1.0
    resumed: bool = False
    preempted: bool = False

    @property
    def duration(self) -> float:
        return self.end - self.start

    @property
    def compute_duration(self) -> float:
        return self.compute_end - self.compute_start


@dataclasses.dataclass(frozen=True)
class ScheduleResult:
    trace: tuple[TraceEvent, ...]
    completion: dict[str, float]  # per-DNNG completion time (Fig. 9(a,b))
    makespan: float
    array: ArrayShape
    # exact compute-busy accumulator from the event loop; None = derive from
    # the trace (keeps utilization right when the trace was dropped)
    busy_pe_seconds: float | None = None
    preemptions: int = 0
    # seconds of extra bus occupancy from memory contention + per-tenant
    # bandwidth caps (MemorySystem.stall_s); 0.0 when contention is unarmed
    bus_stall_s: float = 0.0

    def tenant_trace(self, tenant: str) -> list[TraceEvent]:
        return [e for e in self.trace if e.tenant == tenant]

    @property
    def pe_seconds_busy(self) -> float:
        if self.busy_pe_seconds is not None:
            return self.busy_pe_seconds
        return sum(e.compute_duration * e.partition.n_pes for e in self.trace)

    @property
    def utilization(self) -> float:
        """Compute-busy PE-seconds / total PE-seconds over the makespan."""
        total = self.makespan * self.array.rows * self.array.cols
        return self.pe_seconds_busy / total if total else 0.0


@dataclasses.dataclass(frozen=True)
class ContentionModel:
    """MoCA-style shared-HBM interference curve (exact and deterministic).

    Fleet DRAM demand is bucketed into windows of ``window_s`` seconds;
    ``capacity`` is the fleet bandwidth in units of one node's bus.  A
    window whose booked demand exceeds capacity stretches every transfer
    it serves: ``stretch(p) = 1`` for ``p <= 1``, else ``1 + alpha * (p -
    1)^beta``, with ``p = demand_seconds / (window_s * capacity)``.
    """

    window_s: float = 100e-6
    capacity: float = 1.0
    alpha: float = 1.0
    beta: float = 2.0

    def stretch(self, pressure: float) -> float:
        if pressure <= 1.0:
            return 1.0
        return 1.0 + self.alpha * (pressure - 1.0) ** self.beta


class SharedBandwidth:
    """Fleet-shared per-window DRAM demand ledger.

    Each transfer books its raw duration into the window containing its
    start instant, and its stretch is read off that window's pressure.
    Nodes are advanced in a fixed order, so every stretch is deterministic.
    """

    def __init__(self, contention: ContentionModel):
        self.contention = contention
        self._demand: dict[int, float] = {}  # window index -> booked seconds
        self.peak_pressure = 0.0

    def book(self, start: float, dur: float) -> float:
        """Book ``dur`` seconds of raw demand at ``start``; return the
        contention stretch factor the transfer suffers."""
        c = self.contention
        w = int(start / c.window_s)
        d = self._demand.get(w, 0.0) + dur
        self._demand[w] = d
        pressure = d / (c.window_s * c.capacity)
        if pressure > self.peak_pressure:
            self.peak_pressure = pressure
        return c.stretch(pressure)


class MemorySystem:
    """Shared DRAM channel: FCFS, single server — optionally contention-
    aware and per-tenant rate-capped.

    Unarmed (no contention, no caps) ``acquire`` is the plain FCFS bus.
    Armed, two effects stack on every transfer: **fleet contention** (the
    raw duration is booked into the :class:`SharedBandwidth` ledger and
    stretched) and **per-tenant caps** (``caps[tenant] = share in (0, 1)``:
    the transfer completes for its owner at ``duration / share``, but the
    bus is held only for the wire time, so the slack is usable by
    co-resident tenants).  Caps are set by the policy's ``bandwidth(ctx)``
    hook via :meth:`set_caps`.  ``stall_s`` accumulates the extra transfer
    time beyond raw for the energy report.
    """

    def __init__(
        self,
        contention: ContentionModel | None = None,
        shared: SharedBandwidth | None = None,
    ) -> None:
        self.free_at = 0.0
        self.busy_s = 0.0
        self.stall_s = 0.0
        self.caps: dict[str, float] = {}
        if shared is None and contention is not None:
            shared = SharedBandwidth(contention)
        self.shared = shared

    def set_caps(self, caps) -> None:
        """Replace the per-tenant bandwidth caps (``None``/empty clears), in
        place so live views held by policy contexts stay current."""
        self.caps.clear()
        if caps:
            self.caps.update(caps)

    def acquire(
        self, now: float, dur: float, tenant: str | None = None
    ) -> tuple[float, float]:
        start = max(now, self.free_at)
        if self.shared is not None or self.caps:
            raw = dur
            if self.shared is not None:
                dur = raw * self.shared.book(start, raw)
            hold = dur  # bus occupancy: wire time only
            cap = self.caps.get(tenant)
            if cap is not None and 0.0 < cap < 1.0:
                dur = dur / cap  # owner finishes later...
            self.stall_s += dur - raw
            self.free_at = start + hold  # ...but the bus frees at hold
            self.busy_s += hold
            return start, start + dur
        self.free_at = start + dur
        self.busy_s += dur
        return start, start + dur

    def abort_reservation(self, now: float, start: float, end: float) -> None:
        """Cancel the unperformed part of the reservation ``[start, end)``
        (a preempted stage-in), only while it is still the bus's last
        reservation; demand booked in the shared ledger stays booked."""
        if self.free_at != end:
            return
        cut_from = max(now, start)
        self.busy_s -= end - cut_from
        self.free_at = cut_from


# the pre-memory-model name: MemorySystem with no contention and no caps
_Bus = MemorySystem


class _Tenant:
    __slots__ = (
        "dnng",
        "next_layer",
        "running",
        "draining",
        "done_frac",
        "seq",
        "n_layers",
    )

    def __init__(self, dnng: DNNG, seq: int = 0):
        self.dnng = dnng
        self.seq = seq  # submit order (ready-list sort key)
        self.next_layer = 0
        self.n_layers = len(dnng.layers)
        self.running = False
        self.draining = False  # preempted: partition frees at drain end
        self.done_frac: dict[int, float] = {}  # layer idx -> compute done

    @property
    def finished(self) -> bool:
        return self.next_layer >= self.n_layers

    def ready_layer(self) -> tuple[int, LayerShape] | None:
        """Next schedulable layer.  Layers execute in index order and
        ``DNNG`` enforces topological edges (``s < d``), so the predecessors
        of ``next_layer`` are complete by construction."""
        if self.running or self.draining or self.next_layer >= self.n_layers:
            return None
        return self.next_layer, self.dnng.layers[self.next_layer]


@dataclasses.dataclass
class _InFlight:
    """One launched layer segment (scheduler-internal mutable record)."""

    __slots__ = (
        "idx",
        "layer",
        "part",
        "t_assign",
        "si_start",
        "c_start",
        "c_end",
        "base_frac",
        "share",
        "resumed",
        "token",
    )

    idx: int
    layer: LayerShape
    part: Partition
    t_assign: float
    si_start: float  # stage-in bus reservation start (== c_start if no stage)
    c_start: float
    c_end: float
    base_frac: float  # compute fraction done before this segment
    share: float  # compute fraction this segment covers (1 - base)
    resumed: bool  # a prior segment of this layer was preempted
    token: int  # invalidates stale "cdone" events after preemption


class DynamicScheduler:
    """Incremental, resumable form of Algorithm 1's event loop.

    * :meth:`submit`      — admit one DNNG (its ``arrival_time`` is the event
      timestamp; must be >= the current clock).
    * :meth:`withdraw`    — remove a tenant that has not touched the array.
    * :meth:`run_until`   — process every event with timestamp <= ``t``.
    * :meth:`run`         — drain all pending events (closed-workload mode).
    * ``on_complete``     — optional ``(tenant, time)`` callback fired when a
      DNNG finishes its last layer.
    * ``keep_trace=False``— bounded-memory mode: per-layer trace records and
      the completion dict are dropped; busy PE-seconds, completion count and
      last completion time are still accumulated.
    * ``preemption``      — a :class:`PreemptionModel` arms layer-granular
      preemption through the policy's ``preempt(ctx)`` hook.  A policy
      without the hook keeps the trace identical to the preemption-free one.
    * ``check_invariants`` — run the :class:`PartitionSet` tiling check
      after every event.
    * ``obs``             — an object with a ``tracer`` (and ``audit``) that
      records preemption instants and policy-decision audits; pure
      observation.  ``node_index`` labels this scheduler's track.

    The ready set and per-tenant demand vectors are maintained by delta, and
    a policy round is skipped when the events at an instant left the (ready,
    free) state untouched; ``n_events`` counts processed events.
    """

    def __init__(
        self,
        array: ArrayShape,
        time_fn: TimeFn,
        stage: StageModel | None = None,
        policy="paper",
        on_complete: Callable[[str, float], None] | None = None,
        keep_trace: bool = True,
        start_time: float = 0.0,
        preemption: PreemptionModel | None = None,
        check_invariants: bool = False,
        obs=None,
        node_index: int = 0,
        contention: ContentionModel | None = None,
        shared_bandwidth: SharedBandwidth | None = None,
    ):
        # lazy import: repro_torch.api builds on this module (no cycle)
        from repro_torch.api.policy import (
            AssignContext,
            PartitionPolicy,
            TenantDemand,
            resolve_policy,
        )

        self.array = array
        self.time_fn = time_fn
        self.stage = stage
        self.pol = resolve_policy(policy)
        self.on_complete = on_complete
        self.keep_trace = keep_trace
        self.preemption = preemption
        self.check_invariants = check_invariants
        # observability: every emit is behind an `is not None` guard and
        # never touches event order or scheduler state
        self.node_index = node_index
        self._tr = getattr(obs, "tracer", None)
        self._audit = self._tr is not None and bool(getattr(obs, "audit", False))
        self.tenants: dict[str, _Tenant] = {}
        self.deadlines: dict[str, float] = {}
        self.tiers: dict[str, int] = {}
        self.pset = PartitionSet(array)
        self.bus = MemorySystem(contention=contention, shared=shared_bandwidth)
        self.trace: list[TraceEvent] = []
        self.completion: dict[str, float] = {}
        self.now = start_time
        self.pe_seconds_busy = 0.0
        self.n_completed = 0
        self.n_preemptions = 0
        self.n_events = 0
        self.last_completion = start_time
        self._inflight: dict[str, _InFlight] = {}
        # maintained ready set: [seq, layer_idx, layer, TenantDemand | None]
        # per ready tenant, updated by delta on arrive/launch/finish/pfree/
        # withdraw
        self._ready: dict[str, list] = {}
        self._TenantDemand = TenantDemand
        self._stage_memo: dict[LayerShape, tuple[float, float]] = {}
        # one reusable policy context: every field is a live view (busy,
        # deadlines, tiers and caps mutate in place; the cost cache is
        # cleared per round)
        self._round_cache: dict = {}
        self._ctx = AssignContext(
            array=array,
            time_fn=time_fn,
            busy=self.pset.busy_view(),
            cost_cache=self._round_cache,
            deadlines=self.deadlines,
            tiers=self.tiers,
            bandwidth=self.bus.caps,
        )
        # a rebalance round is skipped while the dirty flag is clear:
        # AssignContext carries no clock, so split/assign are
        # time-independent and the skip is exact; a preempt hook does see
        # the clock, so an armed hook disables the skip
        self._dirty = False
        self._has_preempt_hook = (
            preemption is not None
            and getattr(self.pol, "preempt", None) is not None
            and getattr(type(self.pol), "preempt", None) is not PartitionPolicy.preempt
        )
        # the base bandwidth hook returns None (no caps): a policy without an
        # override keeps the bus cap-free
        self._has_bandwidth_hook = (
            getattr(self.pol, "bandwidth", None) is not None
            and getattr(type(self.pol), "bandwidth", None)
            is not PartitionPolicy.bandwidth
        )
        self._tenant_seq = itertools.count()
        # event heap: (time, seq, kind, payload); kinds: "arrive", "cdone",
        # "done", "pfree".  payload is the tenant name, except "cdone" which
        # carries (tenant, token) so preemption can invalidate stale events.
        self._seq = itertools.count()
        self._tokens = itertools.count()
        self._events: list[tuple] = []
        # fault-injection multipliers (straggler compute inflation, bus-stall
        # transfer inflation); x * 1.0 == x, so the defaults are exact
        self.time_scale = 1.0
        self.bus_scale = 1.0
        # brownout: batch tenants' (tier > 0) column demand is multiplied by
        # this factor; at 1.0 the scaling branch in _demands never fires
        self.batch_demand_scale = 1.0

    # -- queries ------------------------------------------------------------
    @property
    def n_active(self) -> int:
        """DNNGs submitted but not yet complete (the in-system count)."""
        return len(self.tenants)

    def progress(self) -> dict[str, int]:
        """Completed-layer count per live tenant (in-flight fractions are
        not counted)."""
        return {name: t.next_layer for name, t in self.tenants.items()}

    def pending(self) -> bool:
        return bool(self._events)

    def inflight_allocations(self) -> dict[str, tuple[LayerShape, Partition]]:
        """Copy of the live column occupancy: tenant -> (layer, partition)
        for every launched-but-unfinished layer segment."""
        return {name: (inf.layer, inf.part) for name, inf in self._inflight.items()}

    def next_event_time(self) -> float | None:
        return self._events[0][0] if self._events else None

    # -- admission ----------------------------------------------------------
    def submit(self, dnng: DNNG, deadline: float | None = None, tier: int = 0) -> None:
        """Admit one DNNG; its layers become schedulable at ``arrival_time``.

        Names must be unique per scheduler.  ``deadline`` (absolute seconds)
        is SLA metadata surfaced to the policy's ``preempt(ctx)`` hook;
        ``tier`` is the job's latency class (0 = latency-critical), surfaced
        via ``AssignContext.tiers`` and ``TenantDemand.tier``.  Both are
        inert unless a policy acts on them.
        """
        if dnng.name in self.tenants or dnng.name in self.completion:
            raise ValueError(f"duplicate DNNG name: {dnng.name!r}")
        if dnng.arrival_time < self.now:
            raise ValueError(
                f"cannot submit {dnng.name!r} at t={dnng.arrival_time} in "
                f"the past (clock is at {self.now})"
            )
        self.tenants[dnng.name] = _Tenant(dnng, seq=next(self._tenant_seq))
        self.tiers[dnng.name] = tier
        if deadline is not None:
            self.deadlines[dnng.name] = deadline
        heapq.heappush(
            self._events, (dnng.arrival_time, next(self._seq), "arrive", dnng.name)
        )

    def withdraw(self, name: str) -> bool:
        """Remove a submitted tenant that has not touched the array yet.

        Only pristine tenants — no layer completed, none in flight, not
        draining — can be withdrawn; returns False otherwise.  The tenant's
        pending "arrive" event becomes a no-op.
        """
        t = self.tenants.get(name)
        if (
            t is None
            or t.running
            or t.draining
            or t.next_layer > 0
            or name in self._inflight
        ):
            return False
        del self.tenants[name]
        self._ready.pop(name, None)
        self.deadlines.pop(name, None)
        self.tiers.pop(name, None)
        # the ready set changed: the next event's policy round must run
        self._dirty = True
        return True

    # -- event loop ---------------------------------------------------------
    def _mark_ready(self, name: str, now: float) -> None:
        """Insert ``name`` into the maintained ready set if its next layer
        is schedulable (called at arrive, layer completion and pfree)."""
        t = self.tenants.get(name)
        if t is None or t.dnng.arrival_time > now:
            # withdrawn before its arrive event fired, or a stale arrive
            # event of a re-submitted name
            return
        rl = t.ready_layer()
        if rl is None:
            return
        # [sort seq, layer idx, layer, lazy TenantDemand]
        self._ready[name] = [t.seq, rl[0], rl[1], None]
        self._dirty = True

    def _ready_tenants(self, now: float) -> list[tuple[str, int, LayerShape]]:
        """Ready (tenant, layer_idx, layer) triples in submit order."""
        ready = self._ready
        if not ready:
            return []
        if len(ready) == 1:
            name, e = next(iter(ready.items()))
            return [(name, e[1], e[2])]
        return [
            (name, e[1], e[2])
            for name, e in sorted(ready.items(), key=lambda kv: kv[1][0])
        ]

    def _launch(
        self,
        now: float,
        tenant: str,
        layer_idx: int,
        layer: LayerShape,
        part: Partition,
    ) -> None:
        t = self.tenants[tenant]
        t.running = True
        self._ready.pop(tenant, None)
        # stage-in on the shared bus, then compute; stage-out acquires the
        # bus when compute completes ("cdone").  A resumed segment pays
        # stage-in again: that is the restore cost.
        if self.stage is not None:
            si_start, si_end = self.bus.acquire(
                now, self._stage_costs(layer)[0] * self.bus_scale, tenant=tenant
            )
        else:
            si_start = si_end = now
        c_dur = self.time_fn(layer, part) * self.time_scale
        if c_dur <= 0:
            raise ValueError(f"time_fn returned non-positive duration {c_dur}")
        base = t.done_frac.get(layer_idx, 0.0)
        share = 1.0 - base
        c_end = si_end + c_dur * share
        token = next(self._tokens)
        self._inflight[tenant] = _InFlight(
            idx=layer_idx,
            layer=layer,
            part=part,
            t_assign=now,
            si_start=si_start,
            c_start=si_end,
            c_end=c_end,
            base_frac=base,
            share=share,
            resumed=layer_idx in t.done_frac,
            token=token,
        )
        heapq.heappush(self._events, (c_end, next(self._seq), "cdone", (tenant, token)))

    def _demands(self, ready: Sequence[tuple[str, int, LayerShape]]):
        # demand vectors live in the maintained ready entries: built on the
        # first round that needs them, reused while the entry survives
        out = []
        cols = self.array.cols
        scale = self.batch_demand_scale
        for tenant, _idx, layer in ready:
            entry = self._ready[tenant]
            d = entry[3]
            if d is None:
                demand = float(layer.opr)
                width = max(1, min(layer.gemm_n, cols))
                tier = self.tiers.get(tenant, 0)
                if scale != 1.0 and tier > 0:
                    # brownout floor shrink: batch tenants ask for less
                    demand = demand * scale
                    width = max(1, int(width * scale))
                d = entry[3] = self._TenantDemand(
                    name=tenant,
                    demand=demand,
                    width_demand=width,
                    tier=tier,
                    layer=layer,
                )
            out.append(d)
        return out

    def set_batch_demand_scale(self, factor: float) -> None:
        """Scale batch tenants' column demand by ``factor`` in (0, 1]
        (``1.0`` restores nominal demand); cached demand vectors are
        invalidated."""
        if not 0.0 < factor <= 1.0:
            raise ValueError(f"batch_demand_scale must be in (0, 1], got {factor}")
        if factor == self.batch_demand_scale:
            return
        self.batch_demand_scale = factor
        for entry in self._ready.values():
            entry[3] = None
        self._dirty = True

    def _maybe_preempt(self, now: float, cost_cache: dict) -> None:
        """Offer the policy's ``preempt(ctx)`` hook the in-flight set.

        Any layer that has not finished computing is eligible — including
        one still in stage-in, which pays only the fixed quiesce overhead.
        Invalid victim names are ignored.  ``cost_cache`` is the round's
        shared oracle memo.
        """
        from repro_torch.api.policy import InFlightLayer, PreemptContext

        if not self._has_preempt_hook:
            return  # base hook never preempts: skip building the context
        hook = self.pol.preempt
        eligible = {
            name: inf for name, inf in self._inflight.items() if now < inf.c_end
        }
        if not eligible:
            return
        ready = self._ready_tenants(now)
        if not ready:
            return
        ctx = PreemptContext(
            array=self.array,
            now=now,
            ready=tuple(ready),
            free=tuple(self.pset.free_partitions),
            inflight={
                name: InFlightLayer(
                    tenant=name,
                    layer_index=inf.idx,
                    layer=inf.layer,
                    partition=inf.part,
                    compute_start=inf.c_start,
                    compute_end=inf.c_end,
                    remaining_s=inf.c_end - now,
                    fraction_done=inf.base_frac
                    + inf.share
                    * max(0.0, now - inf.c_start)
                    / (inf.c_end - inf.c_start),
                )
                for name, inf in eligible.items()
            },
            deadlines=dict(self.deadlines),
            tiers=dict(self.tiers),
            bandwidth=dict(self.bus.caps),
            time_fn=self.time_fn,
            cost_cache=cost_cache,
            drain_s=self.preemption.drain_s,
            stage_in_s=(
                self.stage.stage_in_s if self.stage is not None else lambda layer: 0.0
            ),
        )
        for victim in hook(ctx):
            if victim in eligible and victim in self._inflight:
                self._preempt(victim, now)

    def _assign(self, now: float) -> None:
        """(Re-)run the policy's split + assign steps at time ``now``."""
        array, pset, pol = self.array, self.pset, self.pol
        # one (layer, partition) -> seconds memo per rebalance round
        cost_cache = self._round_cache
        cost_cache.clear()
        if self.preemption is not None:
            self._maybe_preempt(now, cost_cache)
        ready = self._ready_tenants(now)
        if not ready:
            if self._has_bandwidth_hook:
                # a round with nothing to place still refreshes the caps
                self.bus.set_caps(self.pol.bandwidth(self._ctx))
            return
        busy = pset.busy_view()
        ctx = self._ctx
        free = pset.free_partitions
        audit = self._audit
        if audit:
            # pre-round snapshot for the decision audit
            cand = tuple((name, layer.name or f"L{idx}") for name, idx, layer in ready)
            offer_cols = tuple(p.cols for p in free)
            before = set(self._inflight)
        if not busy and len(free) == 1:
            if len(ready) == 1:
                # Fig. 5 lines 5–6: single available task -> offer all PEs
                offered = free
            else:
                # fresh split among all available layers (lines 8–10)
                offered = pol.split(array, self._demands(ready))
            for a in pol.assign(ready, offered, ctx):
                got = pset.allocate_exact(a.tenant, a.partition)
                self._launch(now, a.tenant, a.layer_index, a.layer, got)
        else:
            # steady state: match ready layers to merged free slices, one
            # grant at a time (trimmed grants change the free list)
            while free and ready:
                progressed = False
                for a in pol.assign(ready, free, ctx):
                    got = pset.allocate_exact(a.tenant, a.partition)
                    self._launch(now, a.tenant, a.layer_index, a.layer, got)
                    progressed = True
                    break  # free list changed; re-sort and re-match
                if not progressed:
                    break
                free = pset.free_partitions
                ready = self._ready_tenants(now)
        if audit:
            grants = tuple(
                (name, inf.part.cols)
                for name, inf in self._inflight.items()
                if name not in before
            )
            granted = {n for n, _c in grants}
            self._tr.instant(
                "decision",
                now,
                self.node_index,
                None,
                (
                    ("ready", cand),
                    ("free_cols", offer_cols),
                    ("grants", grants),
                    ("declined", tuple(n for n, _l in cand if n not in granted)),
                    ("oracle_probes", len(cost_cache)),
                ),
            )
        if self._has_bandwidth_hook:
            # the caps set here govern every bus transfer until the next round
            self.bus.set_caps(self.pol.bandwidth(self._ctx))

    def _stage_costs(self, layer: LayerShape) -> tuple[float, float]:
        """(stage_in_s, stage_out_s) memoized per layer shape."""
        c = self._stage_memo.get(layer)
        if c is None:
            c = self._stage_memo[layer] = (
                self.stage.stage_in_s(layer),
                self.stage.stage_out_s(layer),
            )
        return c

    def _compute_done(self, tenant: str, now: float) -> None:
        inf = self._inflight[tenant]
        if self.stage is not None:
            _, so_end = self.bus.acquire(
                now, self._stage_costs(inf.layer)[1] * self.bus_scale, tenant=tenant
            )
        else:
            so_end = now
        self.pe_seconds_busy += (inf.c_end - inf.c_start) * inf.part.n_pes
        if self.keep_trace:
            self.trace.append(
                TraceEvent(
                    tenant=tenant,
                    layer_index=inf.idx,
                    layer_name=inf.layer.name or f"L{inf.idx}",
                    partition=inf.part,
                    start=inf.t_assign,
                    end=so_end,
                    compute_start=inf.c_start,
                    compute_end=inf.c_end,
                    fraction=inf.share,
                    resumed=inf.resumed,
                )
            )
        heapq.heappush(self._events, (so_end, next(self._seq), "done", tenant))

    def _preempt(self, tenant: str, now: float) -> None:
        """Evict ``tenant``'s in-flight layer: emit the partial segment,
        drain partial sums over the bus, free the partition at drain end,
        and return the remaining compute to the ready set.  A layer caught
        during stage-in pays only the fixed quiesce overhead."""
        inf = self._inflight.pop(tenant)
        t = self.tenants[tenant]
        run_s = max(0.0, now - inf.c_start)
        frac_seg = inf.share * run_s / (inf.c_end - inf.c_start)
        t.done_frac[inf.idx] = inf.base_frac + frac_seg
        t.running = False
        t.draining = True
        self.n_preemptions += 1
        self.pe_seconds_busy += run_s * inf.part.n_pes
        if run_s > 0.0:
            drain = self.preemption.drain_s(inf.part)
        else:
            # caught mid-stage-in: nothing to drain, and the unperformed
            # part of the stage-in transfer is reclaimed when possible
            self.bus.abort_reservation(now, inf.si_start, inf.c_start)
            drain = self.preemption.fixed_overhead_s
        _, dr_end = self.bus.acquire(now, drain * self.bus_scale, tenant=tenant)
        if self.keep_trace:
            self.trace.append(
                TraceEvent(
                    tenant=tenant,
                    layer_index=inf.idx,
                    layer_name=inf.layer.name or f"L{inf.idx}",
                    partition=inf.part,
                    start=inf.t_assign,
                    end=dr_end,
                    compute_start=min(inf.c_start, now),
                    compute_end=now,
                    fraction=frac_seg,
                    resumed=inf.resumed,
                    preempted=True,
                )
            )
        if self._tr is not None:
            self._tr.instant(
                "preempt",
                now,
                self.node_index,
                tenant,
                (
                    ("layer_index", inf.idx),
                    ("fraction_done", inf.base_frac + frac_seg),
                ),
            )
        heapq.heappush(self._events, (dr_end, next(self._seq), "pfree", tenant))

    def _finish(self, tenant: str, now: float) -> None:
        t = self.tenants[tenant]
        t.running = False
        t.done_frac.pop(t.next_layer, None)
        t.next_layer += 1
        self._inflight.pop(tenant, None)
        self.pset.free(tenant)  # eager merge (§3.3)
        self._dirty = True  # columns freed (and maybe a new ready layer)
        if t.finished:
            if self.keep_trace:
                self.completion[tenant] = now
            self.n_completed += 1
            self.last_completion = now
            self.deadlines.pop(tenant, None)
            self.tiers.pop(tenant, None)
            # retired tenants never become ready again
            del self.tenants[tenant]
            if self.on_complete is not None:
                self.on_complete(tenant, now)
        else:
            self._mark_ready(tenant, now)

    def _dispatch(self, kind: str, payload, now: float) -> None:
        if kind == "done":
            self._finish(payload, now)
        elif kind == "cdone":
            name, token = payload
            inf = self._inflight.get(name)
            if inf is not None and inf.token == token:
                self._compute_done(name, now)
            # else: stale event — the segment was preempted first
        elif kind == "pfree":
            self.pset.free(payload)
            self.tenants[payload].draining = False
            self._dirty = True
            self._mark_ready(payload, now)
        else:  # "arrive": the tenant's layers become schedulable now
            self._dirty = True
            self._mark_ready(payload, now)

    def _step(self) -> None:
        """Pop one event timestamp: handle every event at that instant, then
        re-run the policy unless no event dirtied the (ready, free) state
        (an armed preempt hook, which sees the clock, runs every round)."""
        events = self._events
        now, _, kind, name = heapq.heappop(events)
        self.now = now
        self.n_events += 1
        self._dispatch(kind, name, now)
        # drain all events at the same timestamp before re-assigning
        while events and events[0][0] == now:
            _, _, k2, n2 = heapq.heappop(events)
            self.n_events += 1
            self._dispatch(k2, n2, now)
        if self._dirty or self._has_preempt_hook:
            self._dirty = False
            self._assign(now)
        if self.check_invariants:
            self.pset.check()

    def run_until(self, t: float) -> None:
        """Process every pending event with timestamp <= ``t``."""
        events = self._events  # the heap list object is never reassigned
        step = self._step
        while events and events[0][0] <= t:
            step()
        if t > self.now:
            self.now = t

    def run(self) -> None:
        """Drain every pending event (closed-workload mode)."""
        while self._events:
            self._step()

    # -- results ------------------------------------------------------------
    def result(self) -> ScheduleResult:
        if self.completion:
            makespan = max(self.completion.values())
        elif self.n_completed:
            makespan = self.last_completion  # lean mode: dict not retained
        else:
            makespan = self.now
        return ScheduleResult(
            trace=tuple(self.trace),
            completion=dict(self.completion),
            makespan=makespan,
            array=self.array,
            busy_pe_seconds=self.pe_seconds_busy,
            preemptions=self.n_preemptions,
            bus_stall_s=self.bus.stall_s,
        )


def schedule_dynamic(
    dnngs: Sequence[DNNG],
    array: ArrayShape,
    time_fn: TimeFn,
    stage: StageModel | None = None,
    policy="paper",
    preemption: PreemptionModel | None = None,
) -> ScheduleResult:
    """Run Algorithm 1's runtime dynamics end-to-end and return the trace.

    ``policy`` is a :class:`repro_torch.api.policy.PartitionPolicy` or a
    registry name; the default ``"paper"`` is an alias for ``"equal"``.
    This is the closed-workload wrapper over :class:`DynamicScheduler`:
    submit everything, drain, report.
    """
    if not dnngs:
        return ScheduleResult(trace=(), completion={}, makespan=0.0, array=array)
    names = [g.name for g in dnngs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate DNNG names: {names}")
    # negative arrival times are legal in batch mode: start the clock there
    start = min(0.0, min(g.arrival_time for g in dnngs))
    # closed workloads are small: keep the PartitionSet invariant check on
    sched = DynamicScheduler(
        array,
        time_fn,
        stage=stage,
        policy=policy,
        start_time=start,
        preemption=preemption,
        check_invariants=True,
    )
    for g in dnngs:
        sched.submit(g)
    sched.run()
    if len(sched.completion) != len(dnngs):
        missing = set(names) - set(sched.completion)
        raise RuntimeError(f"scheduler deadlock: {missing} never completed")
    return sched.result()


def schedule_sequential(
    dnngs: Sequence[DNNG],
    array: ArrayShape,
    time_fn: TimeFn,
    stage: StageModel | None = None,
) -> ScheduleResult:
    """Single-tenancy baseline: DNNs strictly in arrival order, every layer on
    the full array, stage-in/compute/stage-out fully serialised (the paper's
    Fig. 9 baseline under Scale-Sim's non-overlapped DRAM model)."""
    full = Partition(rows=array.rows, col_start=0, cols=array.cols)
    trace: list[TraceEvent] = []
    completion: dict[str, float] = {}
    now = 0.0
    for g in sorted(dnngs, key=lambda g: (g.arrival_time, g.name)):
        now = max(now, g.arrival_time)
        for i, layer in enumerate(g.layers):
            si = stage.stage_in_s(layer) if stage else 0.0
            so = stage.stage_out_s(layer) if stage else 0.0
            c = time_fn(layer, full)
            trace.append(
                TraceEvent(
                    tenant=g.name,
                    layer_index=i,
                    layer_name=layer.name or f"L{i}",
                    partition=full,
                    start=now,
                    end=now + si + c + so,
                    compute_start=now + si,
                    compute_end=now + si + c,
                )
            )
            now += si + c + so
        completion[g.name] = now
    return ScheduleResult(
        trace=tuple(trace), completion=completion, makespan=now, array=array
    )
