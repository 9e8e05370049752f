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
finalized (completed or rejected) during that epoch; the coordinator keeps
them in an :class:`_EpochLedger`.  When a pod dies, or sends nothing within
``pod_timeout_s``, the raised :class:`PodFailureError` carries a
partial-result payload instead of hanging the sync.  Pod-kill fault plans
and pod respawn need the fault-injection subsystem, which is not ported yet.
"""

from __future__ import annotations

import heapq
import multiprocessing
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
    ):
        from repro_torch.api.backend import resolve_backend
        from repro_torch.api.policy import resolve_policy

        self.base = base
        self.count = count
        self.jobs = jobs
        bk = resolve_backend(backend)
        pol = resolve_policy(policy)
        time_fn = bk.time_fn()
        stage = bk.stage_model()
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
        # builders not yet reported to the epoch ledger as finalized
        self._pending: list = []  # (global job idx, builder)

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
                if self.nodes[target - base].offer(job) != "rejected":
                    b.array = target
            self.depth_samples.append(self._queued_total)
        return self._epoch_msg()

    def _epoch_msg(self) -> dict:
        """The boundary message: loads for the next snapshot + the ledger
        payload.  A builder is finalized once its outcome can no longer
        change — completed, or rejected at admission (``array`` never set)."""
        done, still = [], []
        for item in self._pending:
            b = item[1]
            if b.completed is not None or b.array is None:
                done.append((item[0], b.build()))
            else:
                still.append(item)
        self._pending = still
        return {"loads": [n.in_system for n in self.nodes], "final": done}

    def finish(self) -> dict:
        """Drain all owned queues and fold the pod's results."""
        for node in self.nodes:
            node.scheduler.run()
        return {
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
        for lo, hi in epochs:
            snapshot = conn.recv()
            conn.send(pod.run_epoch(lo, hi, snapshot))
        conn.send(pod.finish())
    except BaseException as exc:  # surface the failure, don't hang the sync
        conn.send(("__error__", repr(exc)))
        raise
    finally:
        conn.close()


class _EpochLedger:
    """What the coordinator durably knows per pod, epoch by epoch — the
    :class:`PodFailureError` partial payload."""

    def __init__(self, n_pods: int):
        self.records = [[] for _ in range(n_pods)]  # finalized (idx, rec)
        self.epochs_done = [0] * n_pods

    def note(self, pi: int, msg: dict) -> None:
        self.records[pi].extend(msg["final"])
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

    ``obs``, ``faults`` (pod-kill plans) and ``respawn`` need subsystems that
    are not ported yet; arming one raises ``NotImplementedError``.
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
        from repro_torch.api.config import not_ported
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
        if faults is not None:
            raise not_ported("faults=", "chaos")
        if respawn:
            raise ValueError(
                "respawn=True has no effect without faults=; pass a "
                "pod_kill FaultPlan to arm pod respawn"
            )
        if obs:
            raise not_ported("obs=", "obs")

    # -- pod/epoch layout ---------------------------------------------------
    def _pod_spans(self) -> list[tuple[int, int]]:
        n, s = self.n_arrays, self.n_shards
        bounds = [p * n // s for p in range(s + 1)]
        return [(bounds[p], bounds[p + 1] - bounds[p]) for p in range(s)]

    def _epochs(self, n_jobs: int) -> list[tuple[int, int]]:
        e = self.sync_every
        return [(lo, min(lo + e, n_jobs)) for lo in range(0, n_jobs, e)]

    def _make_pod(self, base: int, count: int, jobs) -> _Pod:
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
        )

    # -- execution ----------------------------------------------------------
    def run(self) -> ServeResult:
        jobs = list(self.arrivals)
        epochs = self._epochs(len(jobs))
        pods = [self._make_pod(base, count, jobs) for base, count in self._pod_spans()]
        self._ledger = _EpochLedger(self.n_shards)
        use_fork = (
            self.parallel
            and self.n_shards > 1
            and "fork" in multiprocessing.get_all_start_methods()
        )
        if use_fork:
            folds = self._run_forked(pods, epochs)
        else:
            folds = self._run_serial(pods, epochs)
        return self._fold(jobs, folds)

    def _run_serial(self, pods, epochs) -> list[dict]:
        ledger = self._ledger
        snapshot = [0] * self.n_arrays
        for lo, hi in epochs:
            nxt: list[int] = []
            for pi, pod in enumerate(pods):
                msg = pod.run_epoch(lo, hi, snapshot)
                ledger.note(pi, msg)
                nxt.extend(msg["loads"])
            snapshot = nxt
        return [pod.finish() for pod in pods]

    def _run_forked(self, pods, epochs) -> list[dict]:
        ctx = multiprocessing.get_context("fork")
        ledger = self._ledger
        conns, procs = [], []
        done = False
        try:
            for pod in pods:
                parent, child = ctx.Pipe()
                p = ctx.Process(
                    target=_pod_worker, args=(pod, epochs, child), daemon=True
                )
                p.start()
                child.close()  # parent keeps its end only
                conns.append(parent)
                procs.append(p)
            snapshot = [0] * self.n_arrays
            for ei, (lo, hi) in enumerate(epochs):
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
                    msg = self._recv(conns[pi], procs[pi], pi, ei)
                    ledger.note(pi, msg)
                    nxt.extend(msg["loads"])
                snapshot = nxt
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

    def _fold(self, jobs, folds: list[dict]) -> ServeResult:
        from repro_torch.api.backend import resolve_backend

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
