"""Fleet-of-arrays dispatch — the port's own copy of
``repro.traffic.cluster``.

A serving fleet runs N systolic arrays behind a dispatcher:

* :class:`JoinShortestQueue` (``"jsq"``) — route to the array with the
  fewest in-system jobs (queued + executing), ties to the lowest index;
* :class:`PowerOfTwoChoices` (``"p2c"``) — sample two arrays uniformly,
  route to the less loaded;
* :class:`RoundRobin` (``"rr"``) — arrival ``k`` goes to array ``k mod N``.

:class:`ArrayNode` wraps one :class:`repro_torch.core.scheduler
.DynamicScheduler` with admission control (``max_concurrent`` jobs
co-resident on the array) and a bounded FIFO wait queue (``queue_cap``);
overflow is rejected.  Nodes also expose the migration surface
:mod:`repro_torch.traffic.rebalance` drives and the fault surface
:mod:`repro_torch.chaos` and :mod:`repro_torch.overload` drive (fail,
repair, degrade, speed scales, the brownout demand scale).
:class:`FleetLoads` keeps the per-node loads in a lazily rebuilt min-heap so
a jsq decision is O(log N), and excludes nodes the health monitor believes
down from routing.
"""

from __future__ import annotations

import abc
import dataclasses
import heapq
import random
from typing import Callable, Optional, Sequence

from repro_torch.core.dnng import DNNG
from repro_torch.core.partition import ArrayShape, Partition
from repro_torch.core.registry import Registry
from repro_torch.core.scheduler import (
    DynamicScheduler,
    PreemptionModel,
    StageModel,
    TimeFn,
)
from repro_torch.traffic.arrivals import Job


class ArrayNode:
    """One systolic array in the fleet: scheduler + admission + wait queue.

    ``on_load_change`` (optional) fires after any mutation that can change
    :attr:`in_system` or the queue length — admission, queue promotion,
    completion, migration in/out — so a fleet-level load tracker
    (:class:`FleetLoads`) can maintain its heap by delta.
    """

    def __init__(
        self,
        index: int,
        array: ArrayShape,
        time_fn: TimeFn,
        stage: StageModel | None,
        policy,
        max_concurrent: int,
        queue_cap: int,
        on_complete: Callable[["ArrayNode", str, float], None],
        on_submit: Callable[["ArrayNode", Job, float], None] | None = None,
        keep_trace: bool = False,
        preemption: PreemptionModel | None = None,
        on_load_change: Callable[["ArrayNode"], None] | None = None,
        check_invariants: bool = False,
        obs=None,
        contention=None,
        shared_bandwidth=None,
    ):
        if max_concurrent < 1 or queue_cap < 0:
            raise ValueError(
                f"need max_concurrent >= 1 (got {max_concurrent})"
                f" and queue_cap >= 0 (got {queue_cap})"
            )
        self.index = index
        self.max_concurrent = max_concurrent
        self.queue_cap = queue_cap
        self.queue: list[Job] = []
        self.jobs: dict[str, Job] = {}  # every job on this node, by name
        self._ready_at: dict[str, float] = {}  # migrated-in transit arrivals
        self._notify_done = on_complete
        self._notify_submit = on_submit or (lambda node, job, t: None)
        self._notify_load = on_load_change or (lambda node: None)
        self._time_fn = time_fn
        self._stage = stage
        self.array = array
        self._full = Partition(rows=array.rows, col_start=0, cols=array.cols)
        self._svc_cache: dict = {}
        # fault state (repro_torch.chaos): `alive` is ground truth set by
        # fault injection; `health` is the HealthMonitor's belief — dispatch
        # acts on belief, so an undetected failure still eats jobs
        self.alive = True
        self.health = "healthy"
        self.down_since = 0.0
        self._pe_busy_carry = 0.0  # busy PE-seconds of retired schedulers
        self._stall_carry = 0.0  # bus-stall seconds of retired schedulers
        self._time_scale = 1.0  # straggler compute inflation
        self._bus_scale = 1.0  # stage bus stall inflation
        self._batch_demand_scale = 1.0  # brownout batch floor shrink
        # constructor args retained so a fault can rebuild the scheduler
        self._policy = policy
        self._keep_trace = keep_trace
        self._preemption = preemption
        self._check_invariants = check_invariants
        self._obs = obs
        # contention/shared_bandwidth: the fleet-shared bandwidth ledger (one
        # SharedBandwidth across all nodes), which survives scheduler rebuilds
        self._contention = contention
        self._shared_bw = shared_bandwidth
        self.scheduler = self._new_scheduler(0.0)

    def _new_scheduler(self, start_time: float) -> DynamicScheduler:
        sched = DynamicScheduler(
            self.array,
            self._time_fn,
            stage=self._stage,
            policy=self._policy,
            on_complete=self._job_done,
            keep_trace=self._keep_trace,
            preemption=self._preemption,
            check_invariants=self._check_invariants,
            obs=self._obs,
            node_index=self.index,
            start_time=start_time,
            contention=self._contention,
            shared_bandwidth=self._shared_bw,
        )
        sched.time_scale = self._time_scale
        sched.bus_scale = self._bus_scale
        if self._batch_demand_scale != 1.0:
            # brownout survives fault rebuilds, like the fault scales —
            # guarded so fault-free runs never touch the scheduler
            sched.set_batch_demand_scale(self._batch_demand_scale)
        return sched

    @property
    def in_system(self) -> int:
        """Jobs on this array: executing + waiting (the dispatch load key)."""
        return self.scheduler.n_active + len(self.queue)

    @property
    def pe_seconds_busy(self) -> float:
        """Busy PE-seconds over the node's life, work done on schedulers
        retired by a fault included (``0.0 + x`` is IEEE-exact, so the
        fault-free path reads the same bits)."""
        return self._pe_busy_carry + self.scheduler.pe_seconds_busy

    @property
    def bus_stall_s(self) -> float:
        """Memory-contention stall seconds over the node's life, stalls
        booked on schedulers retired by a fault included."""
        return self._stall_carry + self.scheduler.bus.stall_s

    def offer(self, job: Job) -> str:
        """Admission control at ``job.arrival``: ``"run"`` (submitted to the
        array now), ``"queued"`` (parked in the bounded FIFO) or
        ``"rejected"`` (queue full — load shed, counted as a miss)."""
        if self.scheduler.n_active < self.max_concurrent:
            self.scheduler.submit(job.dnng, deadline=job.deadline, tier=job.tier)
            self.jobs[job.dnng.name] = job
            self._notify_submit(self, job, job.arrival)
            self._notify_load(self)
            return "run"
        if len(self.queue) < self.queue_cap:
            self.queue.append(job)
            self.jobs[job.dnng.name] = job
            self._notify_load(self)
            return "queued"
        return "rejected"

    def _job_done(self, tenant: str, t: float) -> None:
        self.jobs.pop(tenant, None)
        self._notify_done(self, tenant, t)
        # a completion freed a co-residency slot: promote the head-of-line
        # job (a migrated-in job still in checkpoint transit is submitted
        # with its future ready instant — the scheduler holds it until then)
        while self.queue and self.scheduler.n_active < self.max_concurrent:
            job = self.queue.pop(0)
            ready = max(t, self._ready_at.pop(job.dnng.name, t))
            g = job.dnng.clone(arrival_time=ready)
            self.scheduler.submit(g, deadline=job.deadline, tier=job.tier)
            self._notify_submit(self, job, ready)
        self._notify_load(self)

    # -- migration surface (driven by repro_torch.traffic.rebalance) --------
    def service_estimate(self, dnng: DNNG) -> float:
        """Full-array sequential service time of one job, memoized on the
        exact layer tuple — the rebalancer's deadline-pressure oracle."""
        key = dnng.layers
        est = self._svc_cache.get(key)
        if est is None:
            est = sum(self._time_fn(layer, self._full) for layer in dnng.layers)
            if self._stage is not None:
                est += sum(
                    self._stage.stage_in_s(layer) + self._stage.stage_out_s(layer)
                    for layer in dnng.layers
                )
            self._svc_cache[key] = est
        return est

    def wait_estimate(self) -> float:
        """Rough time before a queued job gets a run slot: the running jobs'
        remaining work (half their service, on average) plus the queued
        backlog, spread over the co-residency slots."""
        queued = {j.dnng.name for j in self.queue}
        running = sum(
            self.service_estimate(j.dnng)
            for name, j in self.jobs.items()
            if name not in queued
        )
        backlog = sum(self.service_estimate(j.dnng) for j in self.queue)
        return (running / 2.0 + backlog) / self.max_concurrent

    def take_for_migration(self, name: str) -> Optional[Job]:
        """Remove a queued or pristine-submitted job for migration; None when
        the job is unknown or already has array state."""
        for i, job in enumerate(self.queue):
            if job.dnng.name == name:
                del self.queue[i]
                self._ready_at.pop(name, None)
                job = self.jobs.pop(name)
                self._notify_load(self)
                return job
        if name in self.jobs and self.scheduler.withdraw(name):
            job = self.jobs.pop(name)
            self._notify_load(self)
            return job
        return None

    def admit_migrated(self, job: Job, now: float, ready_at: float) -> str:
        """Admit a migrated-in job that becomes runnable at ``ready_at`` (its
        checkpoint is in transit until then)."""
        self.jobs[job.dnng.name] = job
        if self.scheduler.n_active < self.max_concurrent:
            arrival = max(now, ready_at, self.scheduler.now)
            g = job.dnng.clone(arrival_time=arrival)
            self.scheduler.submit(g, deadline=job.deadline, tier=job.tier)
            self._notify_submit(self, job, arrival)
            self._notify_load(self)
            return "run"
        if len(self.queue) < self.queue_cap:
            self.queue.append(job)
            self._ready_at[job.dnng.name] = ready_at
            self._notify_load(self)
            return "queued"
        del self.jobs[job.dnng.name]
        raise ValueError(
            f"migration target {self.index} cannot accept "
            f"{job.dnng.name!r}: queue full"
        )

    # -- fault surface (driven by repro_torch.chaos and .overload) ----------
    def _evacuate(self) -> list[tuple[Job, int]]:
        """Pull every resident job off the node with its checkpointed
        (completed-layer) progress: running jobs first in submit order,
        then the FIFO queue.  Leaves queue/jobs/ready empty and banks the
        retired scheduler's busy PE-seconds and stalls."""
        progress = self.scheduler.progress()
        queued = {j.dnng.name for j in self.queue}
        lost = [
            (job, progress.get(name, 0))
            for name, job in self.jobs.items()
            if name not in queued
        ]
        lost.extend((job, 0) for job in self.queue)
        self.queue.clear()
        self.jobs.clear()
        self._ready_at.clear()
        self._pe_busy_carry += self.scheduler.pe_seconds_busy
        self._stall_carry += self.scheduler.bus.stall_s
        return lost

    def fail(self, now: float) -> list[tuple[Job, int]]:
        """Kill the node at ``now``.  Every resident job is lost (returned
        as ``(job, checkpointed_layers)``: completed layers were staged out
        to DRAM and survive, in-flight fractions do not).  The node gets a
        fresh empty scheduler so it can be repaired later."""
        lost = self._evacuate()
        self.scheduler = self._new_scheduler(now)
        self.alive = False
        self.down_since = now
        self._notify_load(self)
        return lost

    def repair(self, now: float) -> None:
        """Bring a failed node back (empty) at ``now``."""
        self.alive = True
        self.down_since = 0.0
        self._notify_load(self)

    def degrade(self, now: float, dead_cols: int) -> list[tuple[Job, int]]:
        """Lose ``dead_cols`` columns at ``now``: the array shrinks, and
        resident tenants are re-admitted onto a fresh scheduler over the
        surviving columns.  Checkpointed layers are dropped from the
        re-submitted graphs; returns the jobs that no longer fit (queue
        overflow) as ``(job, done)`` pairs."""
        if not 1 <= dead_cols < self.array.cols:
            raise ValueError(
                f"node {self.index} has {self.array.cols} "
                f"columns; cannot lose {dead_cols}"
            )
        from repro_torch.chaos.recovery import truncate_dnng

        evacuated = self._evacuate()
        self.array = ArrayShape(rows=self.array.rows, cols=self.array.cols - dead_cols)
        self._full = Partition(rows=self.array.rows, col_start=0, cols=self.array.cols)
        self._svc_cache.clear()
        self.scheduler = self._new_scheduler(now)
        overflow: list[tuple[Job, int]] = []
        for job, done in evacuated:
            if done > 0:
                job = dataclasses.replace(
                    job, dnng=truncate_dnng(job.dnng, done, arrival_time=now)
                )
            if self.scheduler.n_active < self.max_concurrent:
                self.scheduler.submit(
                    job.dnng.clone(arrival_time=now),
                    deadline=job.deadline,
                    tier=job.tier,
                )
                self.jobs[job.dnng.name] = job
                self._notify_submit(self, job, now)
            elif len(self.queue) < self.queue_cap:
                self.queue.append(job)
                self.jobs[job.dnng.name] = job
            else:
                overflow.append((job, done))
        self._notify_load(self)
        return overflow

    def set_compute_scale(self, factor: float) -> None:
        """Straggler injection: newly launched layers run ``factor``× slower
        (1.0 restores nominal speed)."""
        self._time_scale = factor
        self.scheduler.time_scale = factor

    def set_bus_scale(self, factor: float) -> None:
        """Bus-stall injection: newly acquired stage transfers take
        ``factor``× longer (1.0 restores nominal bandwidth)."""
        self._bus_scale = factor
        self.scheduler.bus_scale = factor

    def set_batch_demand_scale(self, factor: float) -> None:
        """Brownout floor shrink: batch tenants' column demand scales by
        ``factor`` (1.0 restores nominal); a fault-rebuilt scheduler
        inherits it like the fault scales."""
        self._batch_demand_scale = factor
        self.scheduler.set_batch_demand_scale(factor)


# ---------------------------------------------------------------------------
# fleet load tracking + dispatchers
# ---------------------------------------------------------------------------


class FleetLoads:
    """Delta-maintained per-node loads with a lazily rebuilt min-heap.

    Nodes push load changes via their ``on_load_change`` hook; the heap
    accumulates stale entries and discards them on pop (lazy deletion), so a
    jsq decision is O(log N) amortized.  ``min_index()`` returns exactly
    ``argmin_i (loads[i], i)`` — the linear scan's tie-break.  Nodes the
    health monitor believes down are excluded from routing.
    """

    __slots__ = (
        "loads",
        "queued",
        "_heap",
        "_queued_total",
        "_excluded",
        "_n_excluded",
    )

    def __init__(self, nodes: Sequence["ArrayNode"]):
        self.loads = [n.in_system for n in nodes]
        self.queued = [len(n.queue) for n in nodes]
        self._queued_total = sum(self.queued)
        self._heap = [(load, i) for i, load in enumerate(self.loads)]
        heapq.heapify(self._heap)
        self._excluded = [False] * len(self.loads)
        self._n_excluded = 0

    def update(self, node: "ArrayNode") -> None:
        """The node's ``on_load_change`` target."""
        i = node.index
        load = node.in_system
        q = len(node.queue)
        self._queued_total += q - self.queued[i]
        self.queued[i] = q
        if load != self.loads[i]:
            self.loads[i] = load
            heap = self._heap
            heapq.heappush(heap, (load, i))
            if len(heap) > 64 + 8 * len(self.loads):
                # compact the lazy-deletion backlog (amortized O(N))
                heap[:] = [(ld, j) for j, ld in enumerate(self.loads)]
                heapq.heapify(heap)

    @property
    def queued_total(self) -> int:
        """Fleet-wide queue depth (the per-arrival depth sample)."""
        return self._queued_total

    # -- health exclusion (driven by repro_torch.chaos.HealthMonitor) -------
    def exclude(self, i: int) -> None:
        """Take node ``i`` out of routing (belief: suspect or dead)."""
        if not self._excluded[i]:
            self._excluded[i] = True
            self._n_excluded += 1

    def readmit(self, i: int) -> None:
        """Return node ``i`` to routing; its heap entries were consumed
        while excluded, so push a fresh one."""
        if self._excluded[i]:
            self._excluded[i] = False
            self._n_excluded -= 1
            heapq.heappush(self._heap, (self.loads[i], i))

    @property
    def routing_loads(self) -> Sequence[float]:
        """The load view dispatchers route on: the live ``loads`` list
        itself while nothing is excluded (the fault-free case), else a copy
        with excluded nodes pinned to +inf."""
        if self._n_excluded == 0:
            return self.loads
        inf = float("inf")
        return [inf if self._excluded[i] else ld for i, ld in enumerate(self.loads)]

    def min_index(self) -> int:
        heap = self._heap
        loads = self.loads
        if self._n_excluded == 0:
            while True:
                load, i = heap[0]
                if loads[i] == load:
                    return i
                heapq.heappop(heap)  # stale: the node's load moved on
        excluded = self._excluded
        while heap:
            load, i = heap[0]
            if not excluded[i] and loads[i] == load:
                return i
            heapq.heappop(heap)  # stale, or excluded (readmit re-pushes)
        # every node excluded: fall back to the linear argmin so routing
        # still returns a target (the dispatch then fails realistically)
        return min(range(len(loads)), key=lambda i: (loads[i], i))


class Dispatcher(abc.ABC):
    """Pick a target array for an arriving job from in-system loads."""

    name: str = ""

    @abc.abstractmethod
    def choose(self, loads: Sequence[int], rng: random.Random) -> int:
        """Index of the array to route to (``loads[i]`` = jobs in system)."""

    def choose_tracked(self, fleet: FleetLoads, rng: random.Random) -> int:
        """Like :meth:`choose`, reading a maintained :class:`FleetLoads`.
        Must be decision-identical to ``choose``, rng draws included.  Routes
        on ``routing_loads``, so health-excluded nodes (pinned to +inf) lose
        every load comparison."""
        return self.choose(fleet.routing_loads, rng)


_REGISTRY = Registry("dispatcher")


def register_dispatcher(name: str):
    return _REGISTRY.register(name)


def list_dispatchers() -> list[str]:
    return _REGISTRY.names()


def resolve_dispatcher(dispatch) -> Dispatcher:
    return _REGISTRY.resolve(dispatch, Dispatcher)


@register_dispatcher("jsq")
class JoinShortestQueue(Dispatcher):
    """Fewest in-system jobs, ties → lowest index."""

    def choose(self, loads: Sequence[int], rng: random.Random) -> int:
        return min(range(len(loads)), key=lambda i: (loads[i], i))

    def choose_tracked(self, fleet: FleetLoads, rng: random.Random) -> int:
        # heap argmin == linear argmin incl. the lowest-index tie-break
        return fleet.min_index()


@register_dispatcher("p2c")
class PowerOfTwoChoices(Dispatcher):
    """Sample two distinct arrays, keep the shorter queue; one array when
    the fleet has one."""

    def choose(self, loads: Sequence[int], rng: random.Random) -> int:
        if len(loads) == 1:
            return 0
        i, j = rng.sample(range(len(loads)), 2)
        if loads[j] < loads[i] or (loads[j] == loads[i] and j < i):
            return j
        return i


@register_dispatcher("rr")
class RoundRobin(Dispatcher):
    """Load-oblivious cyclic dispatch: arrival ``k`` goes to array ``k mod
    N``.  It reads neither ``loads`` nor ``rng``, which makes it the sharded
    simulator's exact-identity routing mode."""

    def __init__(self):
        self._next = 0

    def choose(self, loads: Sequence[int], rng: random.Random) -> int:
        i = self._next % len(loads)
        self._next = i + 1
        return i
