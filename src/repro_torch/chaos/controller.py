"""The chaos control loop — the port's own copy of
``repro.chaos.controller``: apply faults, detect, schedule recovery.

:class:`ChaosController` is the one object the traffic simulator talks
to.  It owns the expanded fault schedule (a blackout becomes a fail plus
a repair action, a stall window a set plus a reset), the retry release
heap, the run-seeded jitter rng, the :class:`~repro_torch.chaos.monitor
.HealthMonitor`, the :class:`~repro_torch.chaos.recovery.RecoveryPolicy`, and
the fault/retry counters that surface through the gated
:class:`~repro_torch.traffic.metrics.TrafficMetrics` fields.

Determinism: fault application and retry releases are heap-ordered with
sequence tie-breaks; all jitter comes from one rng seeded from the run
seed — two runs with the same seed and plan produce byte-identical
records and an identical :class:`ChaosReport`.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import random

from repro_torch.chaos.faults import FaultPlan
from repro_torch.chaos.monitor import HealthMonitor
from repro_torch.chaos.recovery import RecoveryPolicy, truncate_dnng


@dataclasses.dataclass(frozen=True)
class ChaosReport:
    """End-of-run fault/recovery accounting (``ServeResult.chaos``)."""

    plan: str
    recovery: str
    faults_injected: int
    jobs_lost: int
    jobs_retried: int
    jobs_recovered: int
    retries_exhausted: int
    jobs_shed: int
    detections: int
    # monitor belief transitions: (t, node, old, new, cause)
    transitions: tuple[tuple, ...] = ()
    # tier -> recovery-shed count (kept out of as_dict: the per-tier
    # split serializes through the gated overload metrics keys)
    sheds_by_tier: tuple[tuple, ...] = ()

    def as_dict(self) -> dict:
        return {
            "plan": self.plan,
            "recovery": self.recovery,
            "faults_injected": self.faults_injected,
            "jobs_lost": self.jobs_lost,
            "jobs_retried": self.jobs_retried,
            "jobs_recovered": self.jobs_recovered,
            "retries_exhausted": self.retries_exhausted,
            "jobs_shed": self.jobs_shed,
            "detections": self.detections,
        }


class ChaosController:
    """Drive one :class:`FaultPlan` through a fleet during a serve run."""

    def __init__(
        self,
        plan: FaultPlan,
        nodes,
        fleet,
        monitor: HealthMonitor,
        recovery: RecoveryPolicy,
        seed: int = 0,
        tracer=None,
    ):
        for e in plan.events:
            if e.kind == "pod_kill":
                raise ValueError(
                    "pod_kill faults target ShardedTrafficSimulator pods; "
                    "TrafficSimulator runs in one process"
                )
            if e.node >= len(nodes):
                raise ValueError(
                    f"fault targets node {e.node}, fleet has {len(nodes)}"
                )
        self.plan = plan
        self.nodes = nodes
        self.fleet = fleet
        self.monitor = monitor
        self.recovery = recovery
        self.tracer = tracer
        self._rng = random.Random(f"chaos:{seed}")
        self._seq = itertools.count()
        # (t, seq, action, payload): "fault" applies a FaultEvent; the
        # derived actions end transient effects
        self._sched: list[tuple] = []
        for e in plan.events:
            self._push(e.t, "fault", e)
        # (release_t, seq, Job, remainder DNNG template) — re-stamped with
        # the final (floor-clamped) arrival when popped
        self._retries: list[tuple] = []
        self._attempts: dict[str, int] = {}
        self._recovered: set[str] = set()
        self._nominal_cols = sum(n.array.cols for n in nodes)
        self.last_event_t = 0.0
        # counters (surfaced via TrafficMetrics gated fields)
        self.faults_injected = 0
        self.jobs_lost = 0
        self.jobs_retried = 0
        self.jobs_recovered = 0
        self.retries_exhausted = 0
        self.jobs_shed = 0
        # tier -> recovery-shed count; feeds the gated overload metrics
        # (rejection cause "recovery_shed") when admission/brownout is
        # armed alongside faults
        self.sheds_by_tier: dict[int, int] = {}
        self.detections = 0

    def _push(self, t: float, action: str, payload) -> None:
        heapq.heappush(self._sched, (t, next(self._seq), action, payload))

    # -- fault application --------------------------------------------------
    def next_fault_time(self) -> float | None:
        return self._sched[0][0] if self._sched else None

    def advance_to(self, t: float, advance_fn) -> None:
        """Apply every scheduled action due at or before ``t``, advancing
        the fleet to each action's instant first (completions before the
        fault instant must land; work after it is lost)."""
        while self._sched and self._sched[0][0] <= t:
            te, _, action, payload = heapq.heappop(self._sched)
            advance_fn(te)
            self._apply(te, action, payload)
            self.last_event_t = te

    def _mark(self, kind: str, t: float, node: int, args: tuple) -> None:
        if self.tracer is not None:
            self.tracer.instant(kind, t, node, None, args)

    def _apply(self, te: float, action: str, payload) -> None:
        if action == "fault":
            e = payload
            node = self.nodes[e.node]
            self.faults_injected += 1
            self._mark("fault", te, e.node, (("kind", e.kind),))
            if e.kind == "crash":
                self._fail_node(node, te, "crash")
            elif e.kind == "blackout":
                self._fail_node(node, te, "blackout")
                self._push(te + e.duration_s, "repair", e.node)
            elif e.kind == "degrade":
                if e.dead_cols >= node.array.cols:
                    # nothing left to serve on: a full-width loss is a crash
                    self._fail_node(node, te, "degrade")
                else:
                    for job, done in node.degrade(te, e.dead_cols):
                        self._lose(job, done, te, "degrade_overflow")
            elif e.kind == "bus_stall":
                node.set_bus_scale(e.factor)
                if e.duration_s > 0.0:
                    self._push(te + e.duration_s, "bus_ok", e.node)
            else:  # "straggler"
                node.set_compute_scale(e.factor)
                if e.duration_s > 0.0:
                    self._push(te + e.duration_s, "compute_ok", e.node)
        elif action == "repair":
            self.nodes[payload].repair(te)
            self._mark("recover", te, payload, (("cause", "repair"),))
        elif action == "bus_ok":
            self.nodes[payload].set_bus_scale(1.0)
        else:  # "compute_ok"
            self.nodes[payload].set_compute_scale(1.0)

    def _fail_node(self, node, te: float, cause: str) -> None:
        for job, done in node.fail(te):
            self._lose(job, done, te, cause)

    # -- loss + retry -------------------------------------------------------
    def _lose(self, job, completed: int, now: float, cause: str) -> None:
        """One job just vanished with ``completed`` layers checkpointed.
        Schedule its re-dispatch, or burn it if the budget is spent."""
        self.jobs_lost += 1
        name = job.dnng.name
        attempts = self._attempts.get(name, 0)
        budget = self.recovery.retry_budget(job.tier)
        if attempts >= budget:
            if budget > 0:
                self.retries_exhausted += 1
            return
        ckpt = self.recovery.checkpoint_layers(completed)
        remainder = truncate_dnng(job.dnng, ckpt, arrival_time=now)
        release = (
            now
            + self.recovery.backoff_s(attempts, self._rng)
            + self.recovery.restore_s(remainder)
        )
        self._attempts[name] = attempts + 1
        self.jobs_retried += 1
        heapq.heappush(self._retries, (release, next(self._seq), job, remainder))

    def is_retry(self, name: str) -> bool:
        return name in self._attempts

    def next_retry_time(self) -> float | None:
        return self._retries[0][0] if self._retries else None

    def pop_retry(self, floor: float):
        """The next released retry as a re-dispatchable Job; its arrival is
        clamped to ``floor`` (the stream cursor) so the merged job stream
        stays time-ordered."""
        release, _, job, remainder = heapq.heappop(self._retries)
        t = max(release, floor)
        return dataclasses.replace(
            job, arrival=t, dnng=remainder.clone(arrival_time=t)
        )

    # -- dispatch boundary --------------------------------------------------
    def healthy_capacity_frac(self) -> float:
        """Detected-healthy column fraction of the nominal fleet — the
        graceful-degradation watermark input.  Belief-based: an undetected
        failure still counts as capacity (shedding cannot react faster
        than detection)."""
        up = sum(n.array.cols for n in self.nodes if n.health == "healthy")
        return up / self._nominal_cols

    def dispatch(self, job, nodes, dispatcher, fleet, rng):
        """The chaos-armed dispatch path: refresh beliefs, shed if the
        fleet is under water, route, and turn a dead-target route into a
        loss.  Returns ``(target_or_None, status)`` where status extends
        the offer statuses with ``"shed"`` and ``"lost"``."""
        now = job.arrival
        fired = self.monitor.refresh(now, nodes, fleet)
        if fired:
            self.detections += fired
            for t, idx, old, new, cause in self.monitor.transitions[-fired:]:
                self._mark(
                    "detect", t, idx, (("from", old), ("to", new), ("cause", cause))
                )
        if self.recovery.should_shed(job.tier, self.healthy_capacity_frac()):
            self.jobs_shed += 1
            self.sheds_by_tier[job.tier] = self.sheds_by_tier.get(job.tier, 0) + 1
            return None, "shed"
        target = nodes[dispatcher.choose_tracked(fleet, rng)]
        if target.health == "dead":
            # only the all-excluded fallback can route here (a detected-
            # dead node is excluded, and an idle dead node wins the raw
            # argmin at load 0).  A believed-suspect node beats a
            # believed-dead one — re-route on belief, never on truth.
            believed_up = [n for n in nodes if n.health != "dead"]
            if believed_up:
                target = min(believed_up, key=lambda n: (n.in_system, n.index))
        if not target.alive:
            # the routing RPC fails: definitive detection + one lost job
            self.monitor.note_dispatch_failure(target, fleet, now)
            self.detections += 1
            self._mark(
                "detect",
                now,
                target.index,
                (("from", "healthy"), ("to", "dead"), ("cause", "dispatch_failure")),
            )
            self._lose(job, 0, now, "dispatch_dead")
            return target, "lost"
        return target, target.offer(job)

    def note_completion(self, node, builder, t: float) -> None:
        """Completion feed: service-ratio observation for the straggler
        rule, plus the recovered marker for retried jobs."""
        name = builder.job.dnng.name
        if builder.submitted is not None:
            est = node.service_estimate(builder.job.dnng)
            if est > 0.0:
                self.monitor.observe(node.index, (t - builder.submitted) / est, t)
        if name in self._attempts and name not in self._recovered:
            self._recovered.add(name)
            self.jobs_recovered += 1
            if self.tracer is not None:
                self.tracer.instant(
                    "recover",
                    t,
                    node.index,
                    name,
                    (("attempts", self._attempts[name]),),
                )

    # -- results ------------------------------------------------------------
    def report(self) -> ChaosReport:
        return ChaosReport(
            plan=self.plan.name,
            recovery=self.recovery.name,
            faults_injected=self.faults_injected,
            jobs_lost=self.jobs_lost,
            jobs_retried=self.jobs_retried,
            jobs_recovered=self.jobs_recovered,
            retries_exhausted=self.retries_exhausted,
            jobs_shed=self.jobs_shed,
            detections=self.detections,
            transitions=tuple(self.monitor.transitions),
            sheds_by_tier=tuple(sorted(self.sheds_by_tier.items())),
        )
