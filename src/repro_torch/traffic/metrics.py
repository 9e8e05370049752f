"""SLA metrics for open-loop serving — the port's own copy of
``repro.traffic.metrics``.

A finished simulation is a list of :class:`JobRecord` — one per arrived
job, whether it was rejected at admission, still in flight at the end, or
completed.  :func:`summarize` folds them into a :class:`TrafficMetrics`:

* **latency** — completion − arrival (queueing + service), p50/p95/p99 by
  linear interpolation over the completed set;
* **deadline-miss rate** — fraction of arrived jobs that were rejected,
  never completed, or completed after their deadline;
* **goodput** — deadline-met completions per second of simulated time;
* **queue depth** — mean/max of the dispatcher queue sampled at every
  arrival (the paper's A_t instants);
* **utilization** — time-weighted compute-busy PE fraction over the fleet.

Sums run in record order, as in the JAX package: the order decides the
last bit of the means.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class JobRecord:
    """Lifecycle of one arrived job (rejected jobs have ``submitted=None``)."""

    job_id: int
    model: str
    tier: int
    arrival: float
    deadline: float
    array: Optional[int] = None  # dispatch target (cluster runs)
    submitted: Optional[float] = None  # admission instant; None = rejected
    completed: Optional[float] = None

    @property
    def rejected(self) -> bool:
        return self.submitted is None

    @property
    def latency(self) -> Optional[float]:
        if self.completed is None:
            return None
        return self.completed - self.arrival

    @property
    def met_deadline(self) -> bool:
        return self.completed is not None and self.completed <= self.deadline


def percentile(values: Sequence[float], p: float) -> float:
    """Linear-interpolation percentile (numpy's default), pure Python so the
    metrics stay bit-stable across platforms."""
    if not values:
        return float("nan")
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"percentile {p} out of [0, 100]")
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    rank = p / 100.0 * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


@dataclasses.dataclass(frozen=True)
class TrafficMetrics:
    """Aggregate SLA metrics over one simulated serve run."""

    jobs_arrived: int
    jobs_rejected: int
    jobs_completed: int
    deadline_misses: int
    p50_latency_s: float
    p95_latency_s: float
    p99_latency_s: float
    mean_latency_s: float
    goodput_jobs_per_s: float
    queue_depth_mean: float
    queue_depth_max: int
    utilization: float
    duration_s: float
    # runtime-adaptation counters (0 unless preemption / migration enabled);
    # kept out of as_dict() so records stay byte-stable — ServeResult
    # .as_dict() appends them when the features are armed
    preemptions: int = 0
    migrations: int = 0
    # fairness accounting (None unless the run armed it); the as_dict() keys
    # appear only when set.  The slowdown gate and the dominant-share gate
    # are independent: the sharded simulator computes slowdowns from merged
    # records but cannot sample a global in-flight share series.
    jain_fairness: Optional[float] = None
    per_tenant_slowdown: Optional[dict] = None
    jain_dominant_share: Optional[float] = None
    dominant_share_mean: Optional[dict] = None
    # fault/recovery accounting (None unless the run armed ``faults=``);
    # same append-only as_dict contract as fairness
    faults_injected: Optional[int] = None
    jobs_lost: Optional[int] = None
    jobs_retried: Optional[int] = None
    jobs_recovered: Optional[int] = None
    retries_exhausted: Optional[int] = None
    jobs_shed: Optional[int] = None
    availability_by_tier: Optional[dict] = None
    # memory-contention accounting (None unless the run armed ``memory=``);
    # appended after the chaos gates
    memory_stall_s: Optional[float] = None
    memory_stall_by_node: Optional[dict] = None
    memory_peak_pressure: Optional[float] = None
    # overload-control accounting (None unless the run armed admission/
    # brownout); appended after the memory gates
    rejections_by_cause: Optional[dict] = None
    shed_by_tier: Optional[dict] = None
    brownout_transitions: Optional[int] = None
    brownout_energy_j: Optional[float] = None

    @property
    def deadline_miss_rate(self) -> float:
        return self.deadline_misses / self.jobs_arrived if self.jobs_arrived else 0.0

    @property
    def rejection_rate(self) -> float:
        return self.jobs_rejected / self.jobs_arrived if self.jobs_arrived else 0.0

    def as_dict(self) -> dict:
        out = {
            "jobs_arrived": self.jobs_arrived,
            "jobs_rejected": self.jobs_rejected,
            "jobs_completed": self.jobs_completed,
            "deadline_miss_rate": self.deadline_miss_rate,
            "rejection_rate": self.rejection_rate,
            "p50_latency_s": self.p50_latency_s,
            "p95_latency_s": self.p95_latency_s,
            "p99_latency_s": self.p99_latency_s,
            "mean_latency_s": self.mean_latency_s,
            "goodput_jobs_per_s": self.goodput_jobs_per_s,
            "queue_depth_mean": self.queue_depth_mean,
            "queue_depth_max": self.queue_depth_max,
            "utilization": self.utilization,
            "duration_s": self.duration_s,
        }
        # gated keys append AFTER the stable prefix, in a fixed order, only
        # when their feature ran (append-only byte-stability contract)
        if self.jain_fairness is not None:
            out["jain_fairness"] = self.jain_fairness
            out["per_tenant_slowdown"] = dict(
                sorted((self.per_tenant_slowdown or {}).items())
            )
        if self.jain_dominant_share is not None:
            out["jain_dominant_share"] = self.jain_dominant_share
            out["dominant_share_mean"] = dict(
                sorted((self.dominant_share_mean or {}).items())
            )
        if self.faults_injected is not None:
            out["faults_injected"] = self.faults_injected
            out["jobs_lost"] = self.jobs_lost
            out["jobs_retried"] = self.jobs_retried
            out["jobs_recovered"] = self.jobs_recovered
            out["retries_exhausted"] = self.retries_exhausted
            out["jobs_shed"] = self.jobs_shed
            out["availability_by_tier"] = dict(
                sorted((self.availability_by_tier or {}).items())
            )
        if self.memory_stall_s is not None:
            out["memory_stall_s"] = self.memory_stall_s
            out["memory_stall_by_node"] = dict(
                sorted((self.memory_stall_by_node or {}).items())
            )
            out["memory_peak_pressure"] = self.memory_peak_pressure
        if self.rejections_by_cause is not None:
            out["rejections_by_cause"] = {
                k: (self.rejections_by_cause or {}).get(k, 0)
                for k in ("queue_full", "admission_shed", "recovery_shed")
            }
            out["shed_by_tier"] = dict(sorted((self.shed_by_tier or {}).items()))
            out["brownout_transitions"] = self.brownout_transitions
            out["brownout_energy_j"] = self.brownout_energy_j
        return out


def summarize(
    records: Sequence[JobRecord],
    duration_s: float,
    pe_seconds_busy: float = 0.0,
    total_pes: int = 0,
    queue_depth_samples: Sequence[int] = (),
    preemptions: int = 0,
    migrations: int = 0,
    fairness=None,
    chaos=None,
    memory=None,
    overload=None,
) -> TrafficMetrics:
    """Fold job records into :class:`TrafficMetrics`.

    ``pe_seconds_busy``/``total_pes`` feed the time-weighted utilization
    (busy PE-seconds over ``duration_s × total_pes``);
    ``queue_depth_samples`` are dispatcher-queue depths observed at each
    arrival instant; ``preemptions``/``migrations`` are the
    runtime-adaptation counters.

    The optional payloads are duck-typed: ``fairness`` is a
    :class:`~repro_torch.fairness.accounting.FairnessReport`-shaped object;
    ``chaos`` carries fault counters (``faults_injected``, ``jobs_lost``,
    ``jobs_retried``, ``jobs_recovered``, ``retries_exhausted``,
    ``jobs_shed``), and per-tier availability is computed from the records;
    ``memory`` carries ``stall_s``, ``stall_by_node`` and ``peak_pressure``;
    ``overload`` carries ``rejections_by_cause``, ``shed_by_tier``,
    ``brownout_transitions`` and ``brownout_energy_j``.  Each populates its
    gated fields.
    """
    lats = [r.latency for r in records if r.latency is not None]
    completed = [r for r in records if r.completed is not None]
    met = sum(1 for r in completed if r.met_deadline)
    misses = sum(1 for r in records if not r.met_deadline)
    cap = duration_s * total_pes
    availability = None
    if chaos is not None:
        arrived_by_tier: dict = {}
        done_by_tier: dict = {}
        for r in records:
            arrived_by_tier[r.tier] = arrived_by_tier.get(r.tier, 0) + 1
            if r.completed is not None:
                done_by_tier[r.tier] = done_by_tier.get(r.tier, 0) + 1
        availability = {
            t: done_by_tier.get(t, 0) / n for t, n in arrived_by_tier.items()
        }
    has_fair = fairness is not None
    has_chaos = chaos is not None
    has_mem = memory is not None
    has_over = overload is not None
    return TrafficMetrics(
        jobs_arrived=len(records),
        jobs_rejected=sum(1 for r in records if r.rejected),
        jobs_completed=len(completed),
        deadline_misses=misses,
        p50_latency_s=percentile(lats, 50.0),
        p95_latency_s=percentile(lats, 95.0),
        p99_latency_s=percentile(lats, 99.0),
        mean_latency_s=sum(lats) / len(lats) if lats else float("nan"),
        goodput_jobs_per_s=met / duration_s if duration_s > 0 else 0.0,
        queue_depth_mean=(
            sum(queue_depth_samples) / len(queue_depth_samples)
            if queue_depth_samples
            else 0.0
        ),
        queue_depth_max=max(queue_depth_samples, default=0),
        utilization=pe_seconds_busy / cap if cap > 0 else 0.0,
        duration_s=duration_s,
        preemptions=preemptions,
        migrations=migrations,
        jain_fairness=fairness.jain_fairness if has_fair else None,
        per_tenant_slowdown=dict(fairness.per_tenant_slowdown) if has_fair else None,
        jain_dominant_share=fairness.jain_dominant_share if has_fair else None,
        dominant_share_mean=(
            dict(fairness.dominant_share_mean)
            if has_fair and fairness.dominant_share_mean is not None
            else None
        ),
        faults_injected=chaos.faults_injected if has_chaos else None,
        jobs_lost=chaos.jobs_lost if has_chaos else None,
        jobs_retried=chaos.jobs_retried if has_chaos else None,
        jobs_recovered=chaos.jobs_recovered if has_chaos else None,
        retries_exhausted=chaos.retries_exhausted if has_chaos else None,
        jobs_shed=chaos.jobs_shed if has_chaos else None,
        availability_by_tier=availability,
        memory_stall_s=memory.stall_s if has_mem else None,
        memory_stall_by_node=dict(memory.stall_by_node) if has_mem else None,
        memory_peak_pressure=memory.peak_pressure if has_mem else None,
        rejections_by_cause=dict(overload.rejections_by_cause) if has_over else None,
        shed_by_tier=dict(overload.shed_by_tier) if has_over else None,
        brownout_transitions=overload.brownout_transitions if has_over else None,
        brownout_energy_j=overload.brownout_energy_j if has_over else None,
    )


def split_by(records: Sequence[JobRecord], key: str) -> dict:
    """Group records by a JobRecord attribute (``"model"``, ``"tier"``,
    ``"array"``) — the per-tenant / per-SLA-class views."""
    out: dict = {}
    for r in records:
        out.setdefault(getattr(r, key), []).append(r)
    return out
