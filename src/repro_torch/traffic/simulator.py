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
nothing on the card.  Fault injection (:mod:`repro_torch.chaos`), overload
control (:mod:`repro_torch.overload`) and observability
(:mod:`repro_torch.obs`) are armed by their knobs and imported only then.
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
    # repro_torch.obs.Timeline when the run armed obs=: the collected tracer
    # + time-series registry with exporter shortcuts; None = obs disabled
    timeline: Optional[object] = None
    # fault injection when the run armed faults=: plan and recovery-policy
    # names plus the full ChaosReport; all None on fault-free runs
    faults: Optional[str] = None
    recovery: Optional[str] = None
    chaos: Optional[object] = None
    # memory-contention model descriptor (repr of the armed ContentionModel)
    # when the run armed memory=; None = off
    memory: Optional[str] = None
    # overload-control descriptor ("admission=<name>", "brownout", or both
    # joined with "+") when admission=/brownout= was armed; None = off
    overload: Optional[str] = None
    # BrownoutReport (stage ladder + transition log) when brownout was
    # armed; carried on the result object, not serialized
    brownout: Optional[object] = None

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
        package's order: preemption, rebalance, faults, memory, overload,
        obs."""
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
        if self.faults is not None:
            out["faults"] = self.faults
            out["recovery"] = self.recovery
        if self.memory is not None:
            out["memory"] = self.memory
        if self.overload is not None:
            out["overload"] = self.overload
        if self.timeline is not None:
            out["obs"] = self.timeline.summary()
        return out


@dataclasses.dataclass(frozen=True)
class MemoryStats:
    """Fleet contention accounting of one armed run — the duck-typed
    ``memory=`` payload :func:`~repro_torch.traffic.metrics.summarize` folds
    into the gated ``memory_*`` metrics fields."""

    stall_s: float  # total extra bus-busy seconds
    stall_by_node: dict  # node index -> stall seconds
    peak_pressure: float  # max per-window demand / capacity


@dataclasses.dataclass(frozen=True)
class OverloadStats:
    """Overload-control accounting of one armed run — the duck-typed
    ``overload=`` payload :func:`~repro_torch.traffic.metrics.summarize`
    folds into the gated overload metrics fields."""

    rejections_by_cause: dict  # cause name -> count
    shed_by_tier: dict  # tier -> non-admitted count
    brownout_transitions: int
    brownout_energy_j: float


class _RecordBuilder:
    # dispatch_node/status0 are assigned only when tracing is armed (two
    # attribute stores per arrival — the tracer's whole hot-path cost);
    # `_derive_job_instants` reads them back lazily
    __slots__ = ("job", "array", "submitted", "completed", "dispatch_node", "status0")

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


def _derive_job_instants(builders: dict) -> list[tuple]:
    """Convert the run's job-record builders into raw tracer instants.

    Registered via ``Tracer.attach_source`` at the end of a run and
    evaluated only when the trace is read: ``dispatch`` at the arrival
    instant on the chosen node (with the offer status and tier), ``arrive``
    at the (last) scheduler-submission instant, ``complete`` at the
    completion instant.  A migrated job carries its final submission here;
    the hop itself is a live ``migrate`` marker from the rebalancer."""
    out = []
    for name, b in builders.items():
        job = b.job
        t = job.arrival
        args = (("status", b.status0), ("tier", job.tier))
        out.append(("dispatch", t, t, b.dispatch_node, name, args))
        s = b.submitted
        if s is not None:
            out.append(("arrive", s, s, b.array, name, ()))
        c = b.completed
        if c is not None:
            out.append(("complete", c, c, b.array, name, ()))
    return out


def _host_oracle_calls() -> int:
    """Cumulative host-side cost-oracle invocations (memo hits + misses),
    process-global: :meth:`TrafficSimulator.run` takes a delta around its
    event loop for the oracle-calls-per-event gauge."""
    from repro_torch.core.dataflow import ws_cost_cache_stats
    from repro_torch.sim.systolic import layer_cost

    ws = ws_cost_cache_stats()
    info = layer_cost.cache_info()
    return ws["hits"] + ws["misses"] + info.hits + info.misses


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
    * ``faults`` — a :class:`~repro_torch.chaos.FaultPlan` (or a
      :class:`~repro_torch.chaos.FaultEvent` or a sequence of them) arms
      seeded fault injection: crashes, blackouts, column-loss degradation,
      bus stalls and stragglers.  A :class:`~repro_torch.chaos.HealthMonitor`
      (``monitor=``) detects failures at dispatch boundaries and excludes
      non-healthy nodes from routing; the ``recovery`` policy (registry name
      or :class:`~repro_torch.chaos.RecoveryPolicy`, default
      ``retry_restart``) re-dispatches lost jobs under capped exponential
      backoff with checkpoint warm restarts.  The report lands on
      ``ServeResult.chaos`` and the gated metrics fields.
    * ``obs`` — ``True`` (or a :class:`~repro_torch.obs.Observability`) arms
      the ring-buffered tracer and the time-series registry across the run,
      surfaced as ``ServeResult.timeline``.  Pure observation: armed runs
      serialize the same base record (the gated ``obs`` key comes last).
    * ``admission`` / ``brownout`` — overload control
      (:mod:`repro_torch.overload`).  ``admission`` names an
      :class:`~repro_torch.overload.AdmissionPolicy` (``"static"``,
      ``"codel"``, ``"token_bucket"``) or passes one: a per-arrival
      admit/shed decision in front of the dispatcher, reading the fleet's
      best-case queue-delay estimate; no registered policy sheds tier 0.
      ``brownout`` is ``True`` (default
      :class:`~repro_torch.overload.BrownoutController`) or a controller:
      the degrade-before-drop ladder (bandwidth caps, column floors,
      deadline stretch, then shedding), each stage transition a
      ``brownout`` tracer instant priced in energy.

    Unarmed knobs keep every serialized record byte-identical to a run
    without the feature.  Remaining keyword arguments are forwarded to the
    arrivals registry when ``arrivals`` is a name.
    """

    def __init__(self, arrivals, policy="equal", backend="sim", config=None, **kwargs):
        from repro_torch.api.backend import resolve_backend
        from repro_torch.api.config import resolve_serve_config
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
        # observability: resolved before the nodes so every scheduler shares
        # the one tracer/registry bundle; all hooks are None when disabled
        self._obs = None
        self._tracer = None
        self._registry = None
        self._pulse_nodes = None
        if cfg.obs:
            from repro_torch.obs import resolve_obs

            self._obs = resolve_obs(cfg.obs)
            self._tracer = self._obs.tracer
            self._registry = self._obs.registry
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
                obs=self._obs,
                contention=self.contention,
                shared_bandwidth=self._shared_bw,
            )
            for i in range(sch.n_arrays)
        ]
        if self.rebalancer is not None and self._obs is not None:
            self.rebalancer.obs = self._obs  # migration instant markers
        if self._registry is not None:
            # hoisted bound handles: the arrival pulse appends through
            # pre-resolved `.sample` methods; node.scheduler is read inside
            # the pulse (fault injection replaces a failed node's scheduler)
            reg = self._registry
            self._pulse_nodes = [
                (
                    node,
                    reg.series(f"node{i}.in_system").sample,
                    reg.series(f"node{i}.queue_depth").sample,
                    reg.series(f"node{i}.ready").sample,
                    reg.series(f"node{i}.bus_busy_s").sample,
                    reg.series(f"node{i}.utilization").sample,
                )
                for i, node in enumerate(self.nodes)
            ]
            self._pulse_fleet = (
                reg.series("fleet.queue_depth").sample,
                reg.series("fleet.in_system").sample,
            )
            # per-tenant fairness series, each looked up once by model name
            # (created at its first sample, so the registry's order stays)
            self._slowdown_samplers: dict[str, object] = {}
            self._share_samplers: dict[str, object] = {}
            self._ctr_arrivals = reg.counter("serve.arrivals")
            self._ctr_dispatch = {
                s: reg.counter(f"serve.dispatch.{s}")
                for s in ("run", "queued", "rejected")
            }
        # delta-maintained fleet loads: dispatch reads this instead of
        # scanning every node per arrival (O(N) -> O(log N) for jsq)
        self.fleet = FleetLoads(self.nodes)
        self.chaos = None
        chaos = cfg.chaos
        if chaos.faults is not None:
            from repro_torch.chaos import (
                ChaosController,
                HealthMonitor,
                resolve_faults,
                resolve_recovery,
            )

            self.chaos = ChaosController(
                resolve_faults(chaos.faults),
                self.nodes,
                self.fleet,
                monitor=chaos.monitor or HealthMonitor(),
                recovery=resolve_recovery(chaos.recovery),
                seed=sch.seed,
                tracer=self._tracer,
            )
        elif chaos.recovery != "retry_restart" or chaos.monitor is not None:
            raise ValueError(
                "recovery=/monitor= have no effect without faults=; pass "
                "a FaultPlan to arm fault injection"
            )
        # overload control: admission policy in front of the dispatcher +
        # brownout stage ladder over the fleet
        self.admission = None
        self.brownout = None
        admission, brownout = cfg.overload.admission, cfg.overload.brownout
        if admission is not None or brownout:
            from repro_torch.overload import BrownoutController, resolve_admission

            if admission is not None:
                self.admission = resolve_admission(admission)
            if brownout:
                self.brownout = (
                    brownout
                    if isinstance(brownout, BrownoutController)
                    else BrownoutController()
                )
        self._overload_armed = self.admission is not None or self.brownout is not None
        self._overload_causes = None
        self._shed_by_tier = None
        if self._overload_armed:
            self._overload_causes = {
                "queue_full": 0,
                "admission_shed": 0,
                "recovery_shed": 0,
            }
            self._shed_by_tier = {}
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
        b = self._builders[tenant]
        b.completed = t
        if self.chaos is not None:
            # service-ratio observation (straggler rule) + recovered marker
            self.chaos.note_completion(node, b, t)
        if self._registry is not None and self.accounting is not None:
            # slowdown-vs-isolated sample at the completion instant; the
            # isolated baseline exists since observe() ran at arrival
            model = b.job.model
            iso = self.accounting.isolated_s(model)
            if iso:
                sample = self._slowdown_samplers.get(model)
                if sample is None:
                    name = f"tenant.{model}.slowdown"
                    sample = self._registry.series(name).sample
                    self._slowdown_samplers[model] = sample
                sample(t, (t - b.job.arrival) / iso)

    def _on_submit(self, node: ArrayNode, job: Job, t: float) -> None:
        b = self._builders[job.dnng.name]
        b.submitted = t
        b.array = node.index  # migration may have re-homed the job

    # -- execution ----------------------------------------------------------
    def _chaos_stream(self):
        """Merge the arrival stream with released retry re-dispatches, in
        non-decreasing time order; once both drain, apply any faults still
        scheduled past the last arrival (they may release new retries)."""
        chaos = self.chaos
        cursor = 0.0
        arrivals = iter(self.arrivals)
        job = next(arrivals, None)
        while True:
            rt = chaos.next_retry_time()
            if job is not None:
                if rt is not None and rt <= job.arrival:
                    r = chaos.pop_retry(cursor)
                    cursor = r.arrival
                    yield r
                else:
                    cursor = max(cursor, job.arrival)
                    yield job
                    job = next(arrivals, None)
            elif rt is not None:
                r = chaos.pop_retry(cursor)
                cursor = r.arrival
                yield r
            else:
                ft = chaos.next_fault_time()
                if ft is None:
                    return
                chaos.advance_to(ft, self._advance)

    def _apply_brownout_stage(self) -> None:
        """Push the active brownout stage onto the fleet.

        The batch demand scale lands on every scheduler (the setter is a
        no-op at an unchanged factor); bandwidth caps land only on
        schedulers whose policy has no ``bandwidth`` hook of its own (a
        policy with one, ``moca``, keeps authority over its caps).  Called
        on every stage transition, and per admitted arrival while a capping
        stage is active, because the caps are keyed on the tenant set."""
        s = self.brownout.stage
        cap = s.batch_bw_cap if s is not None else None
        scale = s.batch_demand_scale if s is not None else 1.0
        for node in self.nodes:
            node.set_batch_demand_scale(scale)
            sched = node.scheduler
            if sched._has_bandwidth_hook:
                continue
            if cap is None:
                if sched.bus.caps:
                    sched.bus.set_caps(None)
            else:
                caps = {name: cap for name, tier in sched.tiers.items() if tier > 0}
                sched.bus.set_caps(caps)

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
        fleet = self.fleet
        registry = self._registry
        tracer = self._tracer
        chaos = self.chaos
        admission = self.admission
        brown = self.brownout
        causes = self._overload_causes  # None = overload control off
        shed_tiers = self._shed_by_tier
        node_pes = self.backend.array.rows * self.backend.array.cols
        oracle0 = _host_oracle_calls() if registry is not None else 0
        if registry is not None:
            pulse_nodes = self._pulse_nodes
            fleet_q, fleet_in = self._pulse_fleet
            sample_every = self._obs.sample_every
            i_arr = 0
            # dispatch-status tallies kept in locals and folded into the
            # counters after the loop (two Counter.inc() calls per arrival
            # are measurable against the overhead gate)
            n_run = n_queued = n_rejected = 0
        stream = self.arrivals if chaos is None else self._chaos_stream()
        for job in stream:
            last_arrival = job.arrival
            # periodic rebalance ticks up to the arrival instant
            while next_tick is not None and next_tick <= job.arrival:
                self._advance(next_tick)
                self.rebalancer.rebalance(nodes, next_tick, periodic=True)
                next_tick += interval
            # apply faults scheduled before the arrival, then advance every
            # array to the arrival instant, so slots freed by completions
            # before t are visible to the dispatcher
            if chaos is not None:
                chaos.advance_to(job.arrival, self._advance)
            self._advance(job.arrival)
            name = job.dnng.name
            if causes is not None:
                # one fleet queue-delay sample per arrival (best case: the
                # least-loaded node's estimate) feeds both the brownout loop
                # and the admission policy
                delay = min(n.wait_estimate() for n in nodes)
                if brown is not None:
                    hf = chaos.healthy_capacity_frac() if chaos is not None else 1.0
                    if brown.observe(job.arrival, delay, hf):
                        self._apply_brownout_stage()
                        if tracer is not None:
                            t0, frm, to = brown.log[-1]
                            args = (("from", frm), ("to", to))
                            tracer.instant("brownout", t0, -1, None, args)
                    if name not in self._builders:
                        # stretch only fresh batch arrivals: a chaos retry
                        # keeps the deadline its first admission stamped
                        nd = brown.stretch_deadline(job.tier, job.arrival, job.deadline)
                        if nd != job.deadline:
                            job = dataclasses.replace(job, deadline=nd)
            b = self._builders.get(name)
            if b is None:
                b = self._builders[name] = _RecordBuilder(job)
            elif chaos is None or not chaos.is_retry(name):
                raise ValueError(f"duplicate job name {name!r} in arrival stream")
            admitted = True
            if brown is not None and brown.shed(job.tier):
                admitted = False
            if (
                admitted
                and admission is not None
                and not admission.admit(job.tier, job.arrival, delay)
            ):
                admitted = False
            if not admitted:
                target, status = None, "shed"
            elif chaos is None:
                target = nodes[self.dispatcher.choose_tracked(fleet, self._rng)]
                status = target.offer(job)
                if status != "rejected":
                    b.array = target.index
            else:
                target, status = chaos.dispatch(
                    job, nodes, self.dispatcher, fleet, self._rng
                )
                if target is not None and status in ("run", "queued"):
                    b.array = target.index
            if causes is not None:
                if status in ("rejected", "shed"):
                    # "lost" stays out: the job was admitted and routed, and
                    # losing it mid-run is chaos accounting
                    if not admitted:
                        causes["admission_shed"] += 1
                    elif status == "rejected":
                        causes["queue_full"] += 1
                    else:
                        causes["recovery_shed"] += 1
                    if status == "shed":
                        # the per-tier split counts deliberate sheds only
                        shed_tiers[job.tier] = shed_tiers.get(job.tier, 0) + 1
                elif (
                    brown is not None
                    and brown.stage is not None
                    and brown.stage.batch_bw_cap is not None
                ):
                    # a new tenant entered under an active capping stage:
                    # refresh the name-keyed caps
                    self._apply_brownout_stage()
            if tracer is not None:
                # the tracer's whole per-arrival cost: the dispatch choice is
                # parked on the builder and derived into instants only when
                # the trace is read (`_derive_job_instants`)
                b.dispatch_node = target.index if target is not None else -1
                b.status0 = status
            if registry is not None:
                if status == "run":
                    n_run += 1
                elif status == "queued":
                    n_queued += 1
                else:
                    n_rejected += 1
            if self.rebalancer is not None:
                # deadline-pressure check at every arrival (pressure moves
                # only — full balancing happens on the periodic ticks)
                self.rebalancer.rebalance(nodes, job.arrival, periodic=False)
            depth_samples.append(fleet.queued_total)
            if registry is not None:
                # time-series pulse: fleet + every node (post-dispatch
                # occupancy) at every `sample_every`-th arrival
                if i_arr % sample_every == 0:
                    t = job.arrival
                    fleet_q(t, fleet.queued_total)
                    fleet_in(t, sum(fleet.loads))
                    for node, s_in, s_q, s_ready, s_bus, s_util in pulse_nodes:
                        sched = node.scheduler
                        q = len(node.queue)
                        s_in(t, len(sched.tenants) + q)
                        s_q(t, q)
                        s_ready(t, len(sched._ready))
                        s_bus(t, sched.bus.busy_s)
                        if t > 0.0:
                            s_util(t, node.pe_seconds_busy / (t * node_pes))
                i_arr += 1
            if self.accounting is not None:
                # template for the isolated baseline + a dominant-share
                # sample of the post-dispatch fleet occupancy
                self.accounting.observe(job)
                shares = self.accounting.sample(job.arrival, nodes)
                if registry is not None:
                    share_samplers = self._share_samplers
                    for model, share in shares.items():
                        sample = share_samplers.get(model)
                        if sample is None:
                            name = f"tenant.{model}.dominant_share"
                            sample = registry.series(name).sample
                            share_samplers[model] = sample
                        sample(job.arrival, share)
        # arrivals exhausted: keep ticking while queues drain, then flush
        if next_tick is not None:
            while any(n.queue for n in nodes):
                self._advance(next_tick)
                self.rebalancer.rebalance(nodes, next_tick, periodic=True)
                next_tick += interval
        for node in nodes:
            node.scheduler.run()
        horizon = getattr(self.arrivals, "horizon", 0.0)
        ends = [n.scheduler.now for n in nodes] + [last_arrival, horizon]
        if chaos is not None:
            ends.append(chaos.last_event_t)
        end = max(ends)
        records = tuple(b.build() for b in self._builders.values())
        accounting, reb = self.accounting, self.rebalancer
        fairness = accounting.report(records) if accounting is not None else None
        memory_stats = None
        if self.contention is not None:
            memory_stats = MemoryStats(
                stall_s=sum(n.bus_stall_s for n in nodes),
                stall_by_node={n.index: n.bus_stall_s for n in nodes},
                peak_pressure=self._shared_bw.peak_pressure,
            )
        overload_stats = None
        overload_descr = None
        if self._overload_armed:
            overload_stats = OverloadStats(
                rejections_by_cause=dict(self._overload_causes),
                shed_by_tier=dict(self._shed_by_tier),
                brownout_transitions=brown.transitions if brown is not None else 0,
                brownout_energy_j=brown.energy_overhead_j if brown is not None else 0.0,
            )
            parts = []
            if admission is not None:
                parts.append(
                    "admission="
                    + (getattr(admission, "name", "") or type(admission).__name__)
                )
            if brown is not None:
                parts.append("brownout")
            overload_descr = "+".join(parts)
        metrics = summarize(
            records,
            duration_s=end,
            pe_seconds_busy=sum(n.pe_seconds_busy for n in nodes),
            total_pes=node_pes * self.n_arrays,
            queue_depth_samples=depth_samples,
            preemptions=sum(n.scheduler.n_preemptions for n in nodes),
            migrations=reb.n_migrations if reb is not None else 0,
            fairness=fairness,
            chaos=chaos,
            memory=memory_stats,
            overload=overload_stats,
        )
        timeline = None
        if self._obs is not None:
            if tracer is not None:
                # lazy sources: per-job instants from the record builders,
                # per-layer spans from the schedulers' keep_trace records —
                # both converted only when the trace is read
                builders = self._builders
                tracer.attach_source(lambda: _derive_job_instants(builders))
                if self.keep_trace:
                    for node in nodes:
                        tracer.attach(node.index, node.scheduler.trace)
            if registry is not None:
                self._ctr_arrivals.inc(n_run + n_queued + n_rejected)
                self._ctr_dispatch["run"].inc(n_run)
                self._ctr_dispatch["queued"].inc(n_queued)
                self._ctr_dispatch["rejected"].inc(n_rejected)
                events = sum(n.scheduler.n_events for n in nodes)
                registry.counter("sched.events").inc(events)
                registry.counter("sched.preemptions").inc(metrics.preemptions)
                # summarize() counted the records with a completion instant
                registry.counter("sched.completions").inc(metrics.jobs_completed)
                if reb is not None:
                    registry.counter("sched.migrations").inc(reb.n_migrations)
                if events:
                    calls = _host_oracle_calls() - oracle0
                    registry.gauge("oracle.calls_per_event").set(calls / events)
            from repro_torch.obs import Timeline

            timeline = Timeline(self._obs)
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
            timeline=timeline,
            faults=chaos.plan.name if chaos is not None else None,
            recovery=chaos.recovery.name if chaos is not None else None,
            chaos=chaos.report() if chaos is not None else None,
            memory=repr(self.contention) if self.contention is not None else None,
            overload=overload_descr,
            brownout=brown.report() if brown is not None else None,
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
