"""Open-loop arrival-driven simulation — the port's own copy of
``repro.traffic.simulator``.

:class:`TrafficSimulator` answers the serving question: under a live arrival
process, what latency percentiles, deadline-miss rate and goodput does a
partition policy deliver?

* arrivals come from a :mod:`repro_torch.traffic.arrivals` process, each job
  one Table-1 DNNG with a deadline;
* a dispatcher (:mod:`repro_torch.traffic.cluster`) routes each job to one
  of ``n_arrays`` systolic arrays; each array runs its own incremental
  :class:`~repro_torch.core.scheduler.DynamicScheduler`, so the policy's
  split+assign re-runs on every arrival and completion;
* admission control bounds co-residency (``max_concurrent``) and the wait
  queue (``queue_cap``); overflow is shed and counted as an SLA miss;
* results fold into :mod:`repro_torch.traffic.metrics` SLA numbers.

Everything is deterministic under a fixed seed: the arrival stream owns its
rng, the dispatcher gets ``random.Random(seed)``, and the scheduler is
event-ordered with a stable tie-break.  The path is host arithmetic and puts
nothing on the card.

Fault injection (``faults=``), overload control (``admission=``,
``brownout=``) and observability (``obs=``) need subsystems that are not
ported yet; arming one raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional

from repro_torch.api.session import _name_of
from repro_torch.core.scheduler import ScheduleResult
from repro_torch.traffic.arrivals import ArrivalProcess, Job, resolve_arrivals
from repro_torch.traffic.cluster import ArrayNode, FleetLoads, resolve_dispatcher
from repro_torch.traffic.metrics import JobRecord, TrafficMetrics, split_by, summarize


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One open-loop serve run: per-job records + aggregate SLA metrics."""

    policy: str
    backend: str
    arrivals: str
    dispatch: str
    n_arrays: int
    records: tuple[JobRecord, ...]
    metrics: TrafficMetrics
    schedules: Optional[tuple[ScheduleResult, ...]] = None
    preemption: Optional[str] = None  # PreemptionModel summary, None = off
    rebalance: Optional[str] = None  # rebalancer name, None = off
    # FairnessReport when the run armed fairness accounting; its headline
    # numbers also live in the gated metrics fields — this keeps the raw
    # dominant-share series
    fairness: Optional[object] = None
    # memory-contention model descriptor (repr of the armed ContentionModel)
    # when the run armed memory=; None = off
    memory: Optional[str] = None

    def per(self, key: str) -> dict:
        """Split metrics by ``"model"``, ``"tier"`` or ``"array"``.  Group
        metrics carry latency + miss numbers; fleet-level utilization and
        queue depth read 0 here."""
        groups = sorted(split_by(self.records, key).items(), key=lambda kv: str(kv[0]))
        return {k: summarize(rs, self.metrics.duration_s) for k, rs in groups}

    def per_class_p99_delta(self, baseline: "ServeResult") -> dict:
        """Per-SLA-class p99 latency deltas vs a baseline run (seconds;
        negative = this run is faster)."""
        mine = self.per("tier")
        theirs = baseline.per("tier")
        return {
            tier: mine[tier].p99_latency_s - theirs[tier].p99_latency_s
            for tier in sorted(set(mine) & set(theirs))
        }

    def as_dict(self) -> dict:
        """Machine-readable summary (the JAX package's BENCH_traffic row).
        The gated keys appear only when their feature was armed, in the JAX
        package's order (its fault, overload and obs keys follow ``memory``
        and are not ported yet)."""
        out = {
            "policy": self.policy,
            "backend": self.backend,
            "arrivals": self.arrivals,
            "dispatch": self.dispatch,
            "n_arrays": self.n_arrays,
            **self.metrics.as_dict(),
        }
        if self.preemption is not None:
            out["preemption"] = self.preemption
            out["preemptions"] = self.metrics.preemptions
        if self.rebalance is not None:
            out["rebalance"] = self.rebalance
            out["migrations"] = self.metrics.migrations
        if self.memory is not None:
            out["memory"] = self.memory
        return out


@dataclasses.dataclass(frozen=True)
class MemoryStats:
    """Fleet contention accounting of one armed run — the duck-typed
    ``memory=`` payload :func:`~repro_torch.traffic.metrics.summarize` folds
    into the gated ``memory_*`` metrics fields."""

    stall_s: float  # total extra bus-busy seconds
    stall_by_node: dict  # node index -> stall seconds
    peak_pressure: float  # max per-window demand / capacity


class _RecordBuilder:
    __slots__ = ("job", "array", "submitted", "completed")

    def __init__(self, job: Job):
        self.job = job
        self.array: Optional[int] = None
        self.submitted: Optional[float] = None
        self.completed: Optional[float] = None

    def build(self) -> JobRecord:
        return JobRecord(
            job_id=self.job.job_id,
            model=self.job.model,
            tier=self.job.tier,
            arrival=self.job.arrival,
            deadline=self.job.deadline,
            array=self.array,
            submitted=self.submitted,
            completed=self.completed,
        )


class TrafficSimulator:
    """Drive an arrival stream through a fleet of partitioned arrays.

    ``arrivals`` is an :class:`~repro_torch.traffic.arrivals.ArrivalProcess`,
    a registry name (with ``rate``/``horizon``/... forwarded), or any
    time-ordered iterable of :class:`Job`.  ``policy`` and ``backend`` take
    :mod:`repro_torch.api` registry names or instances.

    Knobs, as one :class:`~repro_torch.api.config.ServeConfig` (``config=``)
    or as flat keywords, never both:

    * ``preemption`` — ``True`` (default
      :class:`~repro_torch.core.scheduler.PreemptionModel`) or a model arms
      layer-granular preemption on every node; only policies with a
      ``preempt`` hook (``deadline_preempt``) act on it.
    * ``rebalance_interval`` — seconds between cross-node migration ticks;
      enables the ``rebalancer`` strategy (name or
      :class:`~repro_torch.traffic.rebalance.Rebalancer`, default
      ``migrate_on_pressure`` under the optional ``migration`` cost model),
      which also runs a pressure-only pass at every arrival.
    * ``check_invariants`` — re-arm the per-event partition tiling check on
      every node.
    * ``fairness`` — ``True`` (or a
      :class:`~repro_torch.fairness.drf.ResourceModel`) arms per-tenant
      fairness accounting (Jain index, per-model slowdown vs isolated
      baselines, a dominant-share series sampled at every arrival).
    * ``memory`` — ``True`` (default
      :class:`~repro_torch.core.scheduler.ContentionModel`) or a model arms
      fleet-shared DRAM bandwidth contention: every node's stage transfers
      book demand against one per-window bandwidth pool.
    * ``faults``/``recovery``/``monitor``, ``admission``/``brownout`` and
      ``obs`` raise ``NotImplementedError`` when armed (not ported yet).

    Unarmed knobs keep every serialized record byte-identical to a run
    without the feature.  Remaining keyword arguments are forwarded to the
    arrivals registry when ``arrivals`` is a name.
    """

    def __init__(self, arrivals, policy="equal", backend="sim", config=None, **kwargs):
        from repro_torch.api.backend import resolve_backend
        from repro_torch.api.config import not_ported, resolve_serve_config
        from repro_torch.api.policy import resolve_policy
        from repro_torch.core.scheduler import (
            ContentionModel,
            PreemptionModel,
            SharedBandwidth,
        )
        from repro_torch.traffic.rebalance import resolve_rebalancer

        # ONE canonical knob object either way: bare serve kwargs are coerced
        # into a ServeConfig here, leftovers go to the arrivals registry
        cfg, arrival_kwargs = resolve_serve_config(config, kwargs)
        self.config = cfg
        sch = cfg.scheduling
        rebalance_interval = cfg.rebalance.interval
        rebalancer = cfg.rebalance.rebalancer
        migration = cfg.rebalance.migration
        preemption = sch.preemption
        if sch.n_arrays < 1:
            raise ValueError(f"n_arrays must be >= 1, got {sch.n_arrays}")
        if rebalance_interval is not None and rebalance_interval <= 0:
            raise ValueError(
                f"rebalance_interval must be positive, got {rebalance_interval}"
            )
        if preemption is True:
            preemption = PreemptionModel()
        elif preemption is False:
            preemption = None
        self.preemption = preemption
        self.rebalance_interval = rebalance_interval
        if rebalance_interval is not None:
            # rebalancer=None is the "caller said nothing" sentinel: the
            # default name is filled in only once an interval arms the
            # feature, so naming it without an interval errors like any name
            if rebalancer is None:
                rebalancer = "migrate_on_pressure"
            if migration is not None and not isinstance(rebalancer, str):
                raise ValueError(
                    "migration= only applies when the rebalancer is built "
                    "from a registry name; configure the instance's "
                    "migration model directly instead"
                )
            extra = {"migration": migration} if migration is not None else {}
            self.rebalancer = resolve_rebalancer(rebalancer, **extra)
        else:
            if migration is not None or rebalancer is not None:
                raise ValueError(
                    "rebalancer=/migration= have no effect without "
                    "rebalance_interval=; set an interval to enable "
                    "cross-node migration"
                )
            self.rebalancer = None
        # memory contention: one ContentionModel + ONE SharedBandwidth ledger
        # across the whole fleet
        self.contention = None
        self._shared_bw = None
        memory = cfg.memory.contention
        if memory:
            self.contention = (
                memory if isinstance(memory, ContentionModel) else ContentionModel()
            )
            self._shared_bw = SharedBandwidth(self.contention)
        if isinstance(arrivals, str):
            # one seed steers the whole run: the arrival stream inherits it
            # unless the caller seeds the process explicitly
            arrival_kwargs.setdefault("seed", sch.seed)
        if isinstance(arrivals, (str, ArrivalProcess)):
            self.arrivals = resolve_arrivals(arrivals, **arrival_kwargs)
        else:
            if arrival_kwargs:
                raise ValueError("arrival kwargs need a registry name")
            self.arrivals = arrivals  # pre-built Job iterable
        self.policy = resolve_policy(policy)
        self.backend = resolve_backend(backend)
        self.dispatcher = resolve_dispatcher(sch.dispatch)
        self.n_arrays = sch.n_arrays
        self.keep_trace = sch.keep_trace
        self._rng = random.Random(sch.seed)
        self._builders: dict[str, _RecordBuilder] = {}
        if cfg.obs:
            raise not_ported("obs=", "obs")
        time_fn = self.backend.time_fn()
        stage = self.backend.stage_model()
        self.nodes = [
            ArrayNode(
                i,
                self.backend.array,
                time_fn,
                stage,
                self.policy,
                max_concurrent=sch.max_concurrent,
                queue_cap=sch.queue_cap,
                on_complete=self._on_complete,
                on_submit=self._on_submit,
                keep_trace=sch.keep_trace,
                preemption=preemption,
                on_load_change=self._on_load_change,
                check_invariants=sch.check_invariants,
                contention=self.contention,
                shared_bandwidth=self._shared_bw,
            )
            for i in range(sch.n_arrays)
        ]
        # delta-maintained fleet loads: dispatch reads this instead of
        # scanning every node per arrival (O(N) -> O(log N) for jsq)
        self.fleet = FleetLoads(self.nodes)
        chaos = cfg.chaos
        if chaos.faults is not None:
            raise not_ported("faults=", "chaos")
        if chaos.recovery != "retry_restart" or chaos.monitor is not None:
            raise ValueError(
                "recovery=/monitor= have no effect without faults=; pass "
                "a FaultPlan to arm fault injection"
            )
        if cfg.overload.admission is not None or cfg.overload.brownout:
            raise not_ported("admission=/brownout=", "overload")
        self.accounting = None
        fairness = cfg.fairness
        if fairness:
            from repro_torch.fairness.accounting import FairnessAccounting
            from repro_torch.fairness.drf import ResourceModel

            if isinstance(fairness, ResourceModel):
                resources = fairness
            elif stage is not None:
                # the DRF bandwidth dimension reads the staging model the
                # schedulers charge; with an armed contention model the DRF
                # window is the contention window
                window = (
                    {"window_s": self.contention.window_s}
                    if self.contention is not None
                    else {}
                )
                resources = ResourceModel(
                    bus_bytes_per_s=stage.dram_bw_bytes,
                    bytes_per_elem=stage.bytes_per_elem,
                    **window,
                )
            else:
                resources = None
            self.accounting = FairnessAccounting(
                self.backend.array,
                time_fn,
                stage=stage,
                n_arrays=sch.n_arrays,
                resources=resources,
                backend_name=_name_of(self.backend),
            )

    def _on_load_change(self, node: ArrayNode) -> None:
        self.fleet.update(node)

    # -- node callbacks -----------------------------------------------------
    def _on_complete(self, node: ArrayNode, tenant: str, t: float) -> None:
        self._builders[tenant].completed = t

    def _on_submit(self, node: ArrayNode, job: Job, t: float) -> None:
        b = self._builders[job.dnng.name]
        b.submitted = t
        b.array = node.index  # migration may have re-homed the job

    # -- execution ----------------------------------------------------------
    def _advance(self, t: float) -> None:
        for node in self.nodes:
            sched = node.scheduler
            events = sched._events
            if events and events[0][0] <= t:
                sched.run_until(t)
            # idle nodes are skipped: their clock stays at the last event,
            # and submissions carry absolute arrival instants

    def run(self) -> ServeResult:
        depth_samples: list[int] = []
        last_arrival = 0.0
        interval = self.rebalance_interval
        next_tick = interval
        nodes = self.nodes
        for job in self.arrivals:
            last_arrival = job.arrival
            # periodic rebalance ticks up to the arrival instant
            while next_tick is not None and next_tick <= job.arrival:
                self._advance(next_tick)
                self.rebalancer.rebalance(nodes, next_tick, periodic=True)
                next_tick += interval
            # advance every array to the arrival instant, so slots freed by
            # completions before t are visible to the dispatcher
            self._advance(job.arrival)
            name = job.dnng.name
            if name in self._builders:
                raise ValueError(f"duplicate job name {name!r} in arrival stream")
            b = self._builders[name] = _RecordBuilder(job)
            target = nodes[self.dispatcher.choose_tracked(self.fleet, self._rng)]
            if target.offer(job) != "rejected":
                b.array = target.index
            if self.rebalancer is not None:
                # deadline-pressure check at every arrival (pressure moves
                # only — full balancing happens on the periodic ticks)
                self.rebalancer.rebalance(nodes, job.arrival, periodic=False)
            depth_samples.append(self.fleet.queued_total)
            if self.accounting is not None:
                # template for the isolated baseline + a dominant-share
                # sample of the post-dispatch fleet occupancy
                self.accounting.observe(job)
                self.accounting.sample(job.arrival, nodes)
        # arrivals exhausted: keep ticking while queues drain, then flush
        if next_tick is not None:
            while any(n.queue for n in nodes):
                self._advance(next_tick)
                self.rebalancer.rebalance(nodes, next_tick, periodic=True)
                next_tick += interval
        for node in nodes:
            node.scheduler.run()
        horizon = getattr(self.arrivals, "horizon", 0.0)
        end = max([n.scheduler.now for n in nodes] + [last_arrival, horizon])
        records = tuple(b.build() for b in self._builders.values())
        pes = self.backend.array.rows * self.backend.array.cols
        accounting, reb = self.accounting, self.rebalancer
        fairness = accounting.report(records) if accounting is not None else None
        memory_stats = None
        if self.contention is not None:
            memory_stats = MemoryStats(
                stall_s=sum(n.bus_stall_s for n in nodes),
                stall_by_node={n.index: n.bus_stall_s for n in nodes},
                peak_pressure=self._shared_bw.peak_pressure,
            )
        metrics = summarize(
            records,
            duration_s=end,
            pe_seconds_busy=sum(n.pe_seconds_busy for n in nodes),
            total_pes=pes * self.n_arrays,
            queue_depth_samples=depth_samples,
            preemptions=sum(n.scheduler.n_preemptions for n in nodes),
            migrations=reb.n_migrations if reb is not None else 0,
            fairness=fairness,
            memory=memory_stats,
        )
        return ServeResult(
            policy=_name_of(self.policy),
            backend=_name_of(self.backend),
            arrivals=_name_of(self.arrivals),
            dispatch=self.dispatcher.name or type(self.dispatcher).__name__,
            n_arrays=self.n_arrays,
            records=records,
            metrics=metrics,
            schedules=(
                tuple(n.scheduler.result() for n in nodes) if self.keep_trace else None
            ),
            preemption=(
                type(self.preemption).__name__ if self.preemption is not None else None
            ),
            rebalance=(
                (_name_of(self.rebalancer) or type(self.rebalancer).__name__)
                if self.rebalancer is not None
                else None
            ),
            fairness=fairness,
            memory=repr(self.contention) if self.contention is not None else None,
        )


def serve(
    arrivals, policy="equal", backend="sim", config=None, **kwargs
) -> ServeResult:
    """Functional one-shot: ``serve(PoissonArrivals(...), policy="equal")``.

    Knobs go in a :class:`~repro_torch.api.config.ServeConfig` (``config=``)
    or as flat keywords — never both; leftover keywords are arrival
    constructor kwargs when ``arrivals`` is a registry name."""
    return TrafficSimulator(
        arrivals, policy=policy, backend=backend, config=config, **kwargs
    ).run()
