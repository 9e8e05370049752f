"""Sharded fleet simulation — the port's own copy of
``repro.traffic.sharded``: per-pod event loops, epoch-synced dispatch.

:class:`ShardedTrafficSimulator` splits the fleet into ``n_shards`` *pods*
of disjoint :class:`~repro_torch.traffic.cluster.ArrayNode` groups and runs
each pod's event loop in its own process (``fork`` + pipes), synced only at
**epoch** boundaries (every ``sync_every`` arrivals).

The design is bulk-synchronous with *replicated routing*:

* every pod holds the full global load vector, refreshed from node truth at
  each epoch boundary, and replays the routing decision for every arrival
  itself — dispatcher state (rr counter, p2c rng) and the in-epoch load
  increments are identical in every pod, so all pods agree on each job's
  target with no per-arrival communication;
* within an epoch the load vector only increments (each routed job bumps
  its target); completions on other pods become visible at the next
  boundary, the same for every value of ``n_shards``;
* each pod advances its own nodes to every global arrival instant and
  records its local queued count, so the per-arrival queue-depth samples
  sum element-wise to the exact fleet series.

**Determinism contract:**

1. results are invariant to ``n_shards`` and to ``parallel=True/False`` for
   every dispatcher;
2. with ``dispatch="rr"`` the routing reads no loads, so a sharded run is
   byte-identical to the single-process
   :class:`~repro_torch.traffic.simulator.TrafficSimulator` on the same
   stream — records, metrics, depth samples.

Not supported here: cross-node migration and ``keep_trace``.

**Failure surface.**  Every epoch message a pod sends carries the jobs it
finalized (completed or rejected) during that epoch, its depth-sample slice
and its boundary busy vector; the coordinator keeps them in an
:class:`_EpochLedger`.  When a pod dies, or sends nothing within
``pod_timeout_s``, the raised :class:`PodFailureError` carries a
partial-result payload instead of hanging the sync.  With ``respawn=True``
(and a ``pod_kill`` plan) the coordinator builds a replacement pod,
fast-forwards its routing replica over the dead pod's completed epochs,
re-admits the lost in-flight jobs through the seeded retry path
(:func:`repro_torch.chaos.respawn_backoffs`) and resumes the epoch protocol.
The serial path mirrors the same recovery, so serial and forked runs stay
byte-identical through a kill.  Lost with the pod, by design: its in-flight
partial work and its private observability replica.
"""

from __future__ import annotations

import dataclasses
import heapq
import multiprocessing
import os
import random
import time
from typing import Sequence

from repro_torch.api.session import _name_of
from repro_torch.traffic.arrivals import ArrivalProcess, Job, resolve_arrivals
from repro_torch.traffic.cluster import ArrayNode, resolve_dispatcher
from repro_torch.traffic.metrics import summarize
from repro_torch.traffic.simulator import ServeResult, _RecordBuilder

#: seconds the coordinator waits for a finished worker to exit
_JOIN_TIMEOUT_S = 30.0


class PodFailureError(RuntimeError):
    """A sharded pod died and the epoch sync could not complete.

    Carries what the coordinator's epoch ledger knows survived: ``pod`` /
    ``epoch`` (which pod died, at which sync epoch), ``jobs_completed``
    (fleet-wide completions reported before the failure), ``pod_status``
    (per pod ``{"state": "ok"|"dead", "epochs_done": k}``) and
    ``partial_records`` (the finalized
    :class:`~repro_torch.traffic.metrics.JobRecord` set, arrival-ordered).
    """

    def __init__(
        self,
        message: str,
        *,
        pod: int,
        epoch: int,
        jobs_completed: int,
        pod_status: dict,
        partial_records: tuple = (),
    ):
        super().__init__(message)
        self.pod = pod
        self.epoch = epoch
        self.jobs_completed = jobs_completed
        self.pod_status = pod_status
        self.partial_records = tuple(partial_records)


class _RoutedLoads:
    """The replicated global load view one pod routes against.

    Duck-types the :class:`~repro_torch.traffic.cluster.FleetLoads` surface
    dispatchers read (``loads`` + ``min_index()``), with the same lazy
    min-heap.  Within an epoch loads only move via :meth:`bump`;
    :meth:`reset` installs the boundary snapshot.
    """

    __slots__ = ("loads", "_heap")

    def __init__(self, n: int):
        self.loads = [0] * n
        self._heap = [(0, i) for i in range(n)]

    def reset(self, snapshot: Sequence[int]) -> None:
        self.loads[:] = snapshot
        self._heap[:] = [(load, i) for i, load in enumerate(self.loads)]
        heapq.heapify(self._heap)

    def bump(self, i: int) -> None:
        self.loads[i] += 1
        heapq.heappush(self._heap, (self.loads[i], i))

    @property
    def routing_loads(self) -> Sequence[int]:
        # FleetLoads surface (Dispatcher.choose_tracked routes on it); pods
        # have no health exclusion, so it is the plain view
        return self.loads

    def min_index(self) -> int:
        heap = self._heap
        loads = self.loads
        while True:
            load, i = heap[0]
            if loads[i] == load:
                return i
            heapq.heappop(heap)


class _Pod:
    """One shard: a contiguous node group + a full replica of the routing
    state.  ``run_epoch`` processes a global arrival slice — routing every
    job, executing only the owned ones — and returns the epoch message."""

    def __init__(
        self,
        base: int,
        count: int,
        n_arrays: int,
        jobs,
        *,
        policy: str,
        backend: str,
        dispatch: str,
        max_concurrent: int,
        queue_cap: int,
        seed: int,
        preemption,
        check_invariants: bool,
        obs_cfg=None,
        kill_at_epoch: int | None = None,
    ):
        from repro_torch.api.backend import resolve_backend
        from repro_torch.api.policy import resolve_policy

        self.base = base
        self.count = count
        self.jobs = jobs
        self.kill_at_epoch = kill_at_epoch  # pod_kill fault
        bk = resolve_backend(backend)
        pol = resolve_policy(policy)
        time_fn = bk.time_fn()
        stage = bk.stage_model()
        # pod-local observability: each pod owns a private bundle built from
        # the coordinator's arm flags (an object could not cross fork + pipe),
        # folded back through finish()["obs"] and merged by the coordinator
        self.obs = None
        self._tracer = None
        self._registry = None
        self._node_series = None
        if obs_cfg is not None:
            from repro_torch.obs import Observability

            self.obs = Observability(**obs_cfg)
            self._tracer = self.obs.tracer
            self._registry = self.obs.registry
        self.nodes = [
            ArrayNode(
                base + i,
                bk.array,
                time_fn,
                stage,
                pol,
                max_concurrent=max_concurrent,
                queue_cap=queue_cap,
                on_complete=self._on_complete,
                on_submit=self._on_submit,
                preemption=preemption,
                on_load_change=self._on_load_change,
                check_invariants=check_invariants,
                obs=self.obs,
            )
            for i in range(count)
        ]
        if self._registry is not None:
            reg = self._registry
            self._node_series = [
                (
                    reg.series(f"node{base + i}.in_system"),
                    reg.series(f"node{base + i}.queue_depth"),
                )
                for i in range(count)
            ]
        self.dispatcher = resolve_dispatcher(dispatch)
        self.rng = random.Random(seed)
        self.view = _RoutedLoads(n_arrays)
        self._queued = [0] * count
        self._queued_total = 0
        self._builders: list = []  # (global job idx, builder)
        self._by_name: dict = {}
        self.depth_samples: list[int] = []
        # epoch-ledger shipping state: builders not yet reported as
        # finalized, and how many depth samples have crossed the pipe
        self._pending: list = []  # (global job idx, builder)
        self._depth_sent = 0

    # -- node callbacks (same wiring as TrafficSimulator) -------------------
    def _on_complete(self, node, tenant: str, t: float) -> None:
        self._by_name[tenant].completed = t

    def _on_submit(self, node, job: Job, t: float) -> None:
        b = self._by_name[job.dnng.name]
        b.submitted = t
        b.array = node.index

    def _on_load_change(self, node) -> None:
        i = node.index - self.base
        q = len(node.queue)
        self._queued_total += q - self._queued[i]
        self._queued[i] = q

    # -- event loop ---------------------------------------------------------
    def _advance(self, t: float) -> None:
        for node in self.nodes:
            sched = node.scheduler
            events = sched._events
            if events and events[0][0] <= t:
                sched.run_until(t)

    def run_epoch(self, lo: int, hi: int, snapshot: Sequence[int]) -> dict:
        """Process global arrivals ``jobs[lo:hi]`` against ``snapshot``
        boundary loads; return the epoch message."""
        self.view.reset(snapshot)
        view = self.view
        dispatcher = self.dispatcher
        rng = self.rng
        base, count = self.base, self.count
        for idx in range(lo, hi):
            job = self.jobs[idx]
            target = dispatcher.choose_tracked(view, rng)
            view.bump(target)
            self._advance(job.arrival)
            if base <= target < base + count:
                b = _RecordBuilder(job)
                self._builders.append((idx, b))
                self._pending.append((idx, b))
                self._by_name[job.dnng.name] = b
                status = self.nodes[target - base].offer(job)
                if status != "rejected":
                    b.array = target
                # owned arrivals only: each dispatch is emitted by exactly
                # one pod, so merged counters/traces match a global view
                if self._tracer is not None:
                    args = (("status", status), ("tier", job.tier))
                    name = job.dnng.name
                    self._tracer.instant("dispatch", job.arrival, target, name, args)
                if self._registry is not None:
                    self._registry.counter("serve.arrivals").inc()
                    self._registry.counter(f"serve.dispatch.{status}").inc()
                    for node, (s_in, s_q) in zip(self.nodes, self._node_series):
                        s_in.sample(job.arrival, node.in_system)
                        s_q.sample(job.arrival, len(node.queue))
            self.depth_samples.append(self._queued_total)
        return self._epoch_msg()

    def _epoch_msg(self) -> dict:
        """The boundary message: loads for the next snapshot + the ledger
        payload (newly finalized records, the depth-sample slice, boundary
        busy/preemption state).  A builder is finalized once its outcome can
        no longer change — completed, or rejected at admission (``array``
        never set)."""
        done, still = [], []
        for item in self._pending:
            b = item[1]
            if b.completed is not None or b.array is None:
                done.append((item[0], b.build()))
            else:
                still.append(item)
        self._pending = still
        depth = self.depth_samples[self._depth_sent :]
        self._depth_sent = len(self.depth_samples)
        return {
            "loads": [n.in_system for n in self.nodes],
            "busy": [n.pe_seconds_busy for n in self.nodes],
            "final": done,
            "depth": depth,
            "preemptions": sum(n.scheduler.n_preemptions for n in self.nodes),
        }

    # -- respawn surface (driven by the coordinator) ------------------------
    def fast_forward(self, history: Sequence[tuple]) -> list[int]:
        """Replay the routing decisions of completed epochs — no execution,
        no builders, no depth samples — so this fresh pod's dispatcher state
        and rng stream end where the dead pod's were at the failure
        boundary.  ``history`` is the coordinator's ``(lo, hi, snapshot)``
        list; returns the global job indices this pod owned over those
        epochs (the lost-job candidates, before the ledger's filter)."""
        owned = []
        base, count = self.base, self.count
        for lo, hi, snapshot in history:
            self.view.reset(snapshot)
            for idx in range(lo, hi):
                target = self.dispatcher.choose_tracked(self.view, self.rng)
                self.view.bump(target)
                if base <= target < base + count:
                    owned.append(idx)
        return owned

    def inject_lost(self, lost: Sequence[int], floor: float, seed_key: str) -> None:
        """Re-admit the dead pod's in-flight jobs through the retry path.

        Each lost job gets one fresh attempt with a seeded first-attempt
        backoff (:func:`repro_torch.chaos.respawn_backoffs`), released no
        earlier than the failure boundary (``floor``), placed on the
        least-loaded owned node (ties to the lowest index).  The record
        keeps the job's original arrival and deadline, so its latency
        includes the downtime + backoff."""
        from repro_torch.chaos import respawn_backoffs

        delays = respawn_backoffs(len(lost), seed_key)
        for idx, delay in zip(lost, delays):
            job = self.jobs[idx]
            t = max(job.arrival, floor) + delay
            retry = dataclasses.replace(
                job, arrival=t, dnng=job.dnng.clone(arrival_time=t)
            )
            b = _RecordBuilder(job)
            self._builders.append((idx, b))
            self._pending.append((idx, b))
            self._by_name[job.dnng.name] = b
            node = min(self.nodes, key=lambda n: (n.in_system, n.index))
            if node.offer(retry) != "rejected":
                b.array = node.index

    def finish(self) -> dict:
        """Drain all owned queues and fold the pod's results."""
        for node in self.nodes:
            node.scheduler.run()
        if self._registry is not None:
            reg = self._registry
            reg.counter("sched.events").inc(
                sum(n.scheduler.n_events for n in self.nodes)
            )
            reg.counter("sched.preemptions").inc(
                sum(n.scheduler.n_preemptions for n in self.nodes)
            )
            reg.counter("sched.completions").inc(
                sum(1 for _idx, b in self._builders if b.completed is not None)
            )
        return {
            "obs": self.obs.state() if self.obs is not None else None,
            "records": [(idx, b.build()) for idx, b in self._builders],
            "depth_samples": self.depth_samples,
            # per-node, not pre-summed: the coordinator adds them flat in
            # global node order so the float total equals the single-process
            # left-to-right sum
            "pe_busy": [n.pe_seconds_busy for n in self.nodes],
            "preemptions": sum(n.scheduler.n_preemptions for n in self.nodes),
            "max_now": max(n.scheduler.now for n in self.nodes),
        }


def _pod_worker(pod: _Pod, epochs, conn) -> None:
    """Child-process loop: one pod, driven over a pipe.  The pod and the
    materialized job list arrive via ``fork`` (copy-on-write), so only the
    per-epoch snapshots and the final fold cross the pipe."""
    try:
        for ei, (lo, hi) in enumerate(epochs):
            snapshot = conn.recv()
            if ei == pod.kill_at_epoch:
                # pod_kill fault: hard process death mid-epoch — no message
                # crosses the pipe, the coordinator must notice the dead
                # worker itself (ShardedTrafficSimulator._recv)
                os._exit(13)
            conn.send(pod.run_epoch(lo, hi, snapshot))
        conn.send(pod.finish())
    except BaseException as exc:  # surface the failure, don't hang the sync
        conn.send(("__error__", repr(exc)))
        raise
    finally:
        conn.close()


class _EpochLedger:
    """What the coordinator durably knows per pod, epoch by epoch: the
    :class:`PodFailureError` partial payload, and for the respawn path the
    finalized-index filter, the routing-replay history and the boundary
    busy/preemption carry."""

    def __init__(self, n_pods: int):
        self.records = [[] for _ in range(n_pods)]  # finalized (idx, rec)
        self.final_idx = [set() for _ in range(n_pods)]
        self.depth = [[] for _ in range(n_pods)]  # shipped depth samples
        self.busy = [None] * n_pods  # last boundary busy vector
        self.preemptions = [0] * n_pods  # last boundary count
        self.epochs_done = [0] * n_pods
        self.history: list[tuple] = []  # (lo, hi, snapshot)

    def note(self, pi: int, msg: dict) -> None:
        self.records[pi].extend(msg["final"])
        self.final_idx[pi].update(idx for idx, _r in msg["final"])
        self.depth[pi].extend(msg["depth"])
        self.busy[pi] = msg["busy"]
        self.preemptions[pi] = msg["preemptions"]
        self.epochs_done[pi] += 1


class ShardedTrafficSimulator:
    """Drive one arrival stream through a pod-sharded fleet.

    Same surface as :class:`~repro_torch.traffic.simulator.TrafficSimulator`
    where the semantics overlap; ``policy``/``backend``/``dispatch`` must be
    registry names (each pod constructs private instances).

    ``sync_every`` sets the epoch length in arrivals.  ``parallel=False``
    runs the identical epoch protocol in-process — bit-identical results.
    ``pod_timeout_s`` bounds every wait on a pod: a pod that dies, or sends
    nothing for that long, raises :class:`PodFailureError`.

    ``obs`` (``True`` or a :class:`~repro_torch.obs.Observability`) arms a
    private tracer/registry replica per pod (same arm flags and caps); the
    coordinator merges their states into one ``ServeResult.timeline`` —
    counters add, series interleave, trace rings merge by timestamp.  Each
    pod counts its owned arrivals only, so merged totals match a global
    view.

    ``faults`` takes a :mod:`repro_torch.chaos` plan of ``pod_kill`` events
    only (``node`` = pod index, ``epoch`` = sync epoch): the worker dies
    hard mid-epoch, and the coordinator raises :class:`PodFailureError`
    within ``pod_timeout_s``; the serial path raises the same error at the
    same epoch.  ``respawn=True`` turns the abort into recovery: the pod is
    rebuilt from the last boundary and the run completes, serial and forked
    byte-identical.  An armed plan that never fires leaves the result
    byte-identical to a fault-free run.
    """

    def __init__(
        self,
        arrivals,
        policy: str = "equal",
        backend: str = "sim",
        n_arrays: int = 2,
        n_shards: int = 2,
        dispatch: str = "rr",
        max_concurrent: int = 4,
        queue_cap: int = 16,
        seed: int = 0,
        sync_every: int = 64,
        parallel: bool = True,
        preemption=None,
        check_invariants: bool = False,
        fairness=False,
        obs=None,
        faults=None,
        pod_timeout_s: float = 120.0,
        respawn: bool = False,
        **arrival_kwargs,
    ):
        from repro_torch.core.scheduler import PreemptionModel

        names = (("policy", policy), ("backend", backend), ("dispatch", dispatch))
        for label, v in names:
            if not isinstance(v, str):
                raise ValueError(
                    f"sharded runs need a registry name for "
                    f"{label}, got {type(v).__name__} (each "
                    f"pod builds its own instance)"
                )
        if not 1 <= n_shards <= n_arrays:
            raise ValueError(
                f"need 1 <= n_shards <= n_arrays, got "
                f"n_shards={n_shards}, n_arrays={n_arrays}"
            )
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        if preemption is True:
            preemption = PreemptionModel()
        elif preemption is False:
            preemption = None
        self.preemption = preemption
        if isinstance(arrivals, str):
            arrival_kwargs.setdefault("seed", seed)
        if isinstance(arrivals, (str, ArrivalProcess)):
            self.arrivals = resolve_arrivals(arrivals, **arrival_kwargs)
        else:
            if arrival_kwargs:
                raise ValueError("arrival kwargs need a registry name")
            self.arrivals = arrivals
        self.policy_name = policy
        self.backend_name = backend
        self.dispatch_name = dispatch
        self.n_arrays = n_arrays
        self.n_shards = n_shards
        self.max_concurrent = max_concurrent
        self.queue_cap = queue_cap
        self.seed = seed
        self.sync_every = sync_every
        self.parallel = parallel
        self.check_invariants = check_invariants
        self.fairness = fairness
        if pod_timeout_s <= 0:
            raise ValueError(f"pod_timeout_s must be positive, got {pod_timeout_s}")
        self.pod_timeout_s = pod_timeout_s
        # pod_kill fault injection: e.node indexes the pod, e.epoch the sync
        # epoch the worker dies in (in-fleet faults need TrafficSimulator)
        self._kill_epochs: dict[int, int] = {}
        self._plan_name = None
        if faults is not None:
            from repro_torch.chaos import resolve_faults

            plan = resolve_faults(faults)
            self._plan_name = plan.name
            for e in plan.events:
                if e.kind != "pod_kill":
                    raise ValueError(
                        f"sharded runs only support pod_kill faults, got "
                        f"{e.kind!r}; use TrafficSimulator faults= for "
                        f"in-fleet fault injection"
                    )
                if not 0 <= e.node < n_shards:
                    raise ValueError(
                        f"pod_kill targets pod {e.node}, run has {n_shards} shards"
                    )
                cur = self._kill_epochs.get(e.node)
                if cur is None or e.epoch < cur:
                    self._kill_epochs[e.node] = e.epoch
        self.respawn = bool(respawn)
        if respawn and faults is None:
            raise ValueError(
                "respawn=True has no effect without faults=; pass a "
                "pod_kill FaultPlan to arm pod respawn"
            )
        # coordinator-side bundle: the pods' private replicas fold into it
        self._obs = None
        if obs:
            from repro_torch.obs import resolve_obs

            self._obs = resolve_obs(obs)

    # -- pod/epoch layout ---------------------------------------------------
    def _pod_spans(self) -> list[tuple[int, int]]:
        n, s = self.n_arrays, self.n_shards
        bounds = [p * n // s for p in range(s + 1)]
        return [(bounds[p], bounds[p + 1] - bounds[p]) for p in range(s)]

    def _epochs(self, n_jobs: int) -> list[tuple[int, int]]:
        e = self.sync_every
        return [(lo, min(lo + e, n_jobs)) for lo in range(0, n_jobs, e)]

    def _make_pod(self, pod_index: int, base: int, count: int, jobs) -> _Pod:
        obs_cfg = None
        if self._obs is not None:
            o = self._obs
            obs_cfg = {
                "tracer": o.tracer is not None,
                "metrics": o.registry is not None,
                "audit": bool(o.audit),
                "max_events": o.tracer.max_events if o.tracer is not None else 65536,
                "max_samples": (
                    o.registry.max_samples if o.registry is not None else 4096
                ),
                "sample_every": o.sample_every,
            }
        return _Pod(
            base,
            count,
            self.n_arrays,
            jobs,
            policy=self.policy_name,
            backend=self.backend_name,
            dispatch=self.dispatch_name,
            max_concurrent=self.max_concurrent,
            queue_cap=self.queue_cap,
            seed=self.seed,
            preemption=self.preemption,
            check_invariants=self.check_invariants,
            obs_cfg=obs_cfg,
            kill_at_epoch=self._kill_epochs.get(pod_index),
        )

    # -- execution ----------------------------------------------------------
    def run(self) -> ServeResult:
        jobs = list(self.arrivals)
        epochs = self._epochs(len(jobs))
        pods = [
            self._make_pod(pi, base, count, jobs)
            for pi, (base, count) in enumerate(self._pod_spans())
        ]
        self._ledger = _EpochLedger(self.n_shards)
        # pod index -> pre-death carry spliced into the fold (set only when
        # a respawn fired; empty = unchanged result shape)
        self._respawned: dict[int, dict] = {}
        use_fork = (
            self.parallel
            and self.n_shards > 1
            and "fork" in multiprocessing.get_all_start_methods()
        )
        if use_fork:
            folds = self._run_forked(pods, epochs, jobs)
        else:
            folds = self._run_serial(pods, epochs, jobs)
        return self._fold(jobs, folds)

    def _run_serial(self, pods, epochs, jobs) -> list[dict]:
        ledger = self._ledger
        snapshot = [0] * self.n_arrays
        for ei, (lo, hi) in enumerate(epochs):
            ledger.history.append((lo, hi, list(snapshot)))
            nxt: list[int] = []
            for pi, pod in enumerate(pods):
                if ei == pod.kill_at_epoch:
                    if not self.respawn:
                        # the forked path's failure surface: the epoch sync
                        # cannot complete once a pod is gone
                        raise self._pod_failure(
                            f"sharded pod {pi} died at epoch {ei} (pod_kill fault)",
                            pi,
                            ei,
                        )
                    pods[pi] = pod = self._respawn_pod(
                        pi, ei, jobs, floor=jobs[lo].arrival
                    )
                msg = pod.run_epoch(lo, hi, snapshot)
                ledger.note(pi, msg)
                nxt.extend(msg["loads"])
            snapshot = nxt
        return [pod.finish() for pod in pods]

    def _run_forked(self, pods, epochs, jobs) -> list[dict]:
        ctx = multiprocessing.get_context("fork")
        ledger = self._ledger
        conns, procs = [], []
        done = False

        def spawn(pod, eps):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_pod_worker, args=(pod, eps, child), daemon=True)
            p.start()
            child.close()  # parent keeps its end only
            return parent, p

        try:
            for pod in pods:
                conn, p = spawn(pod, epochs)
                conns.append(conn)
                procs.append(p)
            snapshot = [0] * self.n_arrays
            for ei, (lo, hi) in enumerate(epochs):
                ledger.history.append((lo, hi, list(snapshot)))
                for pi, conn in enumerate(conns):
                    try:
                        conn.send(snapshot)
                    except BrokenPipeError:
                        raise self._pod_failure(
                            f"sharded pod {pi} (pid {procs[pi].pid}) died "
                            f"mid-epoch: snapshot pipe is broken",
                            pi,
                            ei,
                        ) from None
                nxt: list[int] = []
                for pi in range(len(conns)):
                    try:
                        msg = self._recv(conns[pi], procs[pi], pi, ei)
                    except PodFailureError:
                        if not self.respawn:
                            raise
                        # the pod died at (or timed out across) this
                        # boundary: stop the corpse, rebuild the pod from
                        # ledger state in-process, and hand the replacement
                        # to a fresh worker that replays this epoch
                        if procs[pi].is_alive():
                            procs[pi].kill()
                        procs[pi].join(timeout=_JOIN_TIMEOUT_S)
                        conns[pi].close()
                        pod = self._respawn_pod(pi, ei, jobs, floor=jobs[lo].arrival)
                        conns[pi], procs[pi] = spawn(pod, epochs[ei:])
                        conns[pi].send(snapshot)
                        msg = self._recv(conns[pi], procs[pi], pi, ei)
                    ledger.note(pi, msg)
                    nxt.extend(msg["loads"])
                snapshot = nxt
            # the final fold: a death here (during finish) is past the last
            # boundary — nothing left to respawn for, so it raises
            folds = [
                self._recv(conn, procs[pi], pi, len(epochs))
                for pi, conn in enumerate(conns)
            ]
            done = True
            return folds
        finally:
            # on a failure the surviving pods wait for a snapshot that never
            # comes: stop them at once rather than after the join timeout
            for conn in conns:
                conn.close()
            for p in procs:
                if not done:
                    p.terminate()
                p.join(timeout=_JOIN_TIMEOUT_S)
                if p.is_alive():
                    p.kill()
                    p.join()

    def _recv(self, conn, proc, pod_index: int, epoch: int):
        """Receive one pod message without hanging the sync: poll with a
        deadline, and turn a dead worker (EOF / exited process with no
        buffered reply) into a :class:`PodFailureError` naming the pod.  A
        worker that reported an exception (``__error__``) raises a plain
        RuntimeError."""
        deadline = time.monotonic() + self.pod_timeout_s
        while not conn.poll(0.05):
            if not proc.is_alive() and not conn.poll(0):
                raise self._pod_failure(
                    f"sharded pod {pod_index} (pid {proc.pid}) died "
                    f"mid-epoch with exit code {proc.exitcode}",
                    pod_index,
                    epoch,
                )
            if time.monotonic() >= deadline:
                raise self._pod_failure(
                    f"sharded pod {pod_index} (pid {proc.pid}) sent no "
                    f"reply within {self.pod_timeout_s:g}s; aborting the "
                    f"epoch sync",
                    pod_index,
                    epoch,
                )
        try:
            msg = conn.recv()
        except EOFError:
            raise self._pod_failure(
                f"sharded pod {pod_index} (pid {proc.pid}) died "
                f"mid-epoch with exit code {proc.exitcode}",
                pod_index,
                epoch,
            ) from None
        if isinstance(msg, tuple) and len(msg) == 2 and msg[0] == "__error__":
            raise RuntimeError(f"sharded pod {pod_index} failed: {msg[1]}")
        return msg

    # -- failure surface ----------------------------------------------------
    def _pod_failure(self, message: str, pod: int, epoch: int) -> PodFailureError:
        """Build the partial-payload error from the epoch ledger."""
        led = self._ledger
        indexed = sorted(
            (pair for recs in led.records for pair in recs), key=lambda p: p[0]
        )
        records = tuple(r for _idx, r in indexed)
        status = {
            pi: {
                "state": "dead" if pi == pod else "ok",
                "epochs_done": led.epochs_done[pi],
            }
            for pi in range(self.n_shards)
        }
        return PodFailureError(
            message,
            pod=pod,
            epoch=epoch,
            jobs_completed=sum(1 for r in records if r.completed is not None),
            pod_status=status,
            partial_records=records,
        )

    def _respawn_pod(self, pi: int, ei: int, jobs, *, floor: float) -> _Pod:
        """Rebuild pod ``pi`` from the last epoch-boundary state.

        The replacement is constructed exactly like the original (same
        seeds), fast-forwarded over the dead pod's completed epochs, and
        handed the lost in-flight jobs through the retry path.  The
        pre-death finalized records, depth slices and boundary busy are
        frozen here and spliced back in at fold time — work the dead pod
        durably reported is never re-run."""
        led = self._ledger
        base, count = self._pod_spans()[pi]
        pod = self._make_pod(pi, base, count, jobs)
        pod.kill_at_epoch = None  # the plan fires once per pod
        owned = pod.fast_forward(led.history[:ei])
        done = led.final_idx[pi]
        lost = [idx for idx in owned if idx not in done]
        pod.inject_lost(lost, floor, f"respawn:{self.seed}:{pi}:{ei}")
        self._respawned[pi] = {
            "records": list(led.records[pi]),
            "depth": list(led.depth[pi]),
            "busy": list(led.busy[pi] or [0.0] * count),
            "preemptions": led.preemptions[pi],
            "epoch": ei,
            "lost": len(lost),
        }
        return pod

    def _fold(self, jobs, folds: list[dict]) -> ServeResult:
        from repro_torch.api.backend import resolve_backend

        # splice each respawned pod's pre-death carry (the ledger's durable
        # view) in front of the replacement's fold, so the merged result
        # covers every owned job once: finalized pre-death via the carry,
        # lost in-flight via the retry injection, the rest via the new pod
        for pi, carry in self._respawned.items():
            f = folds[pi]
            f["records"] = carry["records"] + f["records"]
            f["depth_samples"] = carry["depth"] + f["depth_samples"]
            f["pe_busy"] = [c + b for c, b in zip(carry["busy"], f["pe_busy"])]
            f["preemptions"] += carry["preemptions"]
        indexed = sorted(
            (pair for f in folds for pair in f["records"]), key=lambda p: p[0]
        )
        records = tuple(r for _idx, r in indexed)
        # element-wise sum of the per-pod queued series == the fleet series
        depth = [0] * (len(folds[0]["depth_samples"]) if folds else 0)
        for f in folds:
            for i, d in enumerate(f["depth_samples"]):
                depth[i] += d
        last_arrival = jobs[-1].arrival if jobs else 0.0
        horizon = getattr(self.arrivals, "horizon", 0.0)
        end = max([f["max_now"] for f in folds] + [last_arrival, horizon])
        fairness = None
        if self.fairness:
            fairness = self._fairness_report(jobs, records)
        bk = resolve_backend(self.backend_name)
        pes = bk.array.rows * bk.array.cols
        metrics = summarize(
            records,
            duration_s=end,
            pe_seconds_busy=sum(busy for f in folds for busy in f["pe_busy"]),
            total_pes=pes * self.n_arrays,
            queue_depth_samples=depth,
            preemptions=sum(f["preemptions"] for f in folds),
            fairness=fairness,
        )
        timeline = None
        if self._obs is not None:
            for f in folds:
                if f.get("obs") is not None:
                    self._obs.absorb(f["obs"])
            from repro_torch.obs import Timeline

            timeline = Timeline(self._obs)
        return ServeResult(
            policy=self.policy_name,
            backend=self.backend_name,
            arrivals=_name_of(self.arrivals),
            dispatch=self.dispatch_name,
            n_arrays=self.n_arrays,
            records=records,
            metrics=metrics,
            preemption=(
                type(self.preemption).__name__ if self.preemption is not None else None
            ),
            fairness=fairness,
            timeline=timeline,
            # set only when a respawn fired: an armed plan that never fires
            # stays byte-identical to a fault-free run
            faults=self._plan_name if self._respawned else None,
            recovery="pod_respawn" if self._respawned else None,
        )

    def _fairness_report(self, jobs, records):
        """Coordinator-side fairness fold: per-tenant slowdowns from the
        merged records.  Dominant-share sampling needs a global in-flight
        snapshot at every arrival — the cross-pod state sharding removes —
        so those report fields stay None here."""
        from repro_torch.api.backend import resolve_backend
        from repro_torch.fairness.accounting import FairnessAccounting
        from repro_torch.fairness.drf import ResourceModel

        bk = resolve_backend(self.backend_name)
        resources = self.fairness if isinstance(self.fairness, ResourceModel) else None
        acct = FairnessAccounting(
            bk.array,
            bk.time_fn(),
            stage=bk.stage_model(),
            n_arrays=self.n_arrays,
            resources=resources,
            backend_name=_name_of(bk),
        )
        for job in jobs:
            acct.observe(job)
        return acct.report(records)


def serve_sharded(
    arrivals, policy: str = "equal", backend: str = "sim", **kwargs
) -> ServeResult:
    """Functional one-shot, mirroring
    :func:`repro_torch.traffic.simulator.serve`."""
    return ShardedTrafficSimulator(
        arrivals, policy=policy, backend=backend, **kwargs
    ).run()
