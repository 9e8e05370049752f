"""``Session`` — the port's front door, as ``repro.api.session`` is the JAX
package's.

    from repro_torch.api import Session

    res = Session(policy="equal", backend="sim").run("heavy")
    print(res.time_saving, res.energy_saving, res.partition_histogram())

A Session binds one :class:`~repro_torch.api.policy.PartitionPolicy` to one
:class:`~repro_torch.api.backend.Accelerator` backend, runs a workload (a
name from ``repro_torch.sim.workloads.WORKLOADS`` or a ``Sequence[DNNG]``)
under dynamic partitioning, and — unless ``compare_baseline=False`` — also
runs the sequential single-tenancy baseline so savings can be reported.
:meth:`Session.serve` drives an open-loop arrival stream through the same
policy × backend (:mod:`repro_torch.traffic`).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional, Sequence

from repro_torch.api.backend import Accelerator, EnergyReport, resolve_backend
from repro_torch.api.policy import PartitionPolicy, resolve_policy
from repro_torch.core.dnng import DNNG, LayerShape
from repro_torch.core.scheduler import (
    ScheduleResult,
    schedule_dynamic,
    schedule_sequential,
)


@dataclasses.dataclass(frozen=True)
class BaselineRun:
    """A sequential single-tenancy run of one workload on one backend.

    Policy-independent, so one instance can be shared across every policy's
    :meth:`Session.run` on the same workload; sharing is validated by
    workload name, DNNG set, array geometry and backend name.
    """

    workload: str
    schedule: ScheduleResult
    energy: Optional[EnergyReport] = None
    backend: str = ""


@dataclasses.dataclass(frozen=True)
class SessionResult:
    """One workload run: dynamic-partitioned schedule vs (optionally) the
    sequential baseline, with backend energy accounting when available."""

    workload: str
    policy: str
    backend: str
    partitioned: ScheduleResult
    baseline: Optional[ScheduleResult] = None
    partitioned_energy: Optional[EnergyReport] = None
    baseline_energy: Optional[EnergyReport] = None

    # -- headline metrics (Fig. 9) ----------------------------------------
    @property
    def time_saving(self) -> float:
        """Fractional makespan reduction vs the sequential baseline."""
        if self.baseline is None or self.baseline.makespan == 0:
            return 0.0
        return 1.0 - self.partitioned.makespan / self.baseline.makespan

    @property
    def turnaround_saving(self) -> float:
        """Fractional mean per-DNN completion-time reduction."""
        if self.baseline is None:
            return 0.0
        bsum = sum(self.baseline.completion.values())
        psum = sum(self.partitioned.completion.values())
        return 1.0 - psum / bsum if bsum else 0.0

    @property
    def energy_saving(self) -> float:
        if self.baseline_energy is None or self.partitioned_energy is None:
            return 0.0
        return 1.0 - self.partitioned_energy.total / self.baseline_energy.total

    @property
    def utilization(self) -> float:
        return self.partitioned.utilization

    def partition_histogram(self) -> dict[str, int]:
        """How many layers ran on each partition width (Fig. 9 c,d)."""
        c = Counter(
            f"{e.partition.rows}x{e.partition.cols}" for e in self.partitioned.trace
        )
        return dict(sorted(c.items()))

    def as_dict(self) -> dict:
        """Machine-readable summary (the JAX package's BENCH_fig9 row)."""
        return {
            "workload": self.workload,
            "policy": self.policy,
            "backend": self.backend,
            "makespan_s": self.partitioned.makespan,
            "baseline_makespan_s": self.baseline.makespan if self.baseline else None,
            "time_saving": self.time_saving,
            "turnaround_saving": self.turnaround_saving,
            "energy_saving": self.energy_saving,
            "utilization": self.utilization,
            "partition_histogram": self.partition_histogram(),
        }


def _name_of(obj) -> str:
    return getattr(obj, "name", type(obj).__name__)


class Session:
    """Bind a policy to a backend; run workloads by name or as DNNG lists."""

    def __init__(
        self,
        policy: "str | PartitionPolicy" = "equal",
        backend: "str | Accelerator" = "sim",
        **backend_kwargs,
    ):
        self.policy = resolve_policy(policy)
        self.backend = resolve_backend(backend, **backend_kwargs)

    # -- workload resolution ------------------------------------------------
    @staticmethod
    def _resolve_workload(workload) -> tuple[str, list[DNNG]]:
        if isinstance(workload, str):
            # read at call time so ablations may patch WORKLOADS
            from repro_torch.sim import workloads as _w

            if workload not in _w.WORKLOADS:
                raise ValueError(
                    f"unknown workload {workload!r}; known: {sorted(_w.WORKLOADS)}"
                )
            return workload, list(_w.WORKLOADS[workload]())
        dnngs = list(workload)
        if not all(isinstance(g, DNNG) for g in dnngs):
            raise ValueError("workload must be a name or a sequence of DNNGs")
        return "custom", dnngs

    @staticmethod
    def _layers_by_key(dnngs: Sequence[DNNG]) -> dict[tuple[str, int], LayerShape]:
        return {(g.name, i): layer for g in dnngs for i, layer in enumerate(g.layers)}

    # -- execution ----------------------------------------------------------
    def run_baseline(self, workload) -> BaselineRun:
        """Sequential single-tenancy run only — policy-independent, so the
        result can be passed as ``baseline=`` to several :meth:`run` calls
        on the same workload."""
        name, dnngs = self._resolve_workload(workload)
        base = schedule_sequential(
            dnngs,
            self.backend.array,
            self.backend.time_fn(),
            stage=self.backend.stage_model(),
        )
        e_base = self.backend.energy(base, self._layers_by_key(dnngs), baseline_pe=True)
        return BaselineRun(
            workload=name, schedule=base, energy=e_base, backend=_name_of(self.backend)
        )

    def run(
        self,
        workload,
        *,
        compare_baseline: bool = True,
        baseline: Optional[BaselineRun] = None,
    ) -> SessionResult:
        name, dnngs = self._resolve_workload(workload)
        time_fn = self.backend.time_fn()
        stage = self.backend.stage_model()
        layers = self._layers_by_key(dnngs)

        part = schedule_dynamic(
            dnngs, self.backend.array, time_fn, stage=stage, policy=self.policy
        )
        e_part = self.backend.energy(part, layers, baseline_pe=False)
        base = e_base = None
        if baseline is not None:
            self._check_baseline(baseline, name, dnngs)
            base, e_base = baseline.schedule, baseline.energy
        elif compare_baseline:
            base = schedule_sequential(dnngs, self.backend.array, time_fn, stage=stage)
            e_base = self.backend.energy(base, layers, baseline_pe=True)
        return SessionResult(
            workload=name,
            policy=_name_of(self.policy),
            backend=_name_of(self.backend),
            partitioned=part,
            baseline=base,
            partitioned_energy=e_part,
            baseline_energy=e_base,
        )

    def _check_baseline(
        self, baseline: BaselineRun, name: str, dnngs: Sequence[DNNG]
    ) -> None:
        """A shared baseline must cover this workload on this backend:
        every explicit DNNG sequence is "custom", so the name alone is not
        enough."""
        if baseline.workload != name:
            raise ValueError(
                f"baseline is for workload {baseline.workload!r}, not {name!r}"
            )
        if set(baseline.schedule.completion) != {g.name for g in dnngs}:
            raise ValueError(
                f"baseline covers DNNGs {sorted(baseline.schedule.completion)}, "
                f"workload has {sorted(g.name for g in dnngs)}"
            )
        if baseline.schedule.array != self.backend.array:
            raise ValueError(
                f"baseline ran on array {baseline.schedule.array}, "
                f"backend has {self.backend.array}"
            )
        mine = _name_of(self.backend)
        if baseline.backend and baseline.backend != mine:
            raise ValueError(
                f"baseline ran on backend {baseline.backend!r}, not {mine!r}"
            )

    def serve(self, arrivals, *, config=None, **kwargs):
        """Open-loop serving: drive an arrival process through this session's
        policy × backend and return a
        :class:`~repro_torch.traffic.simulator.ServeResult` (latency
        percentiles, deadline-miss rate, goodput).

        ``arrivals`` is a :mod:`repro_torch.traffic.arrivals` process, a
        registry name (``"poisson"``, ``"mmpp"``, ``"diurnal"``, ``"trace"``,
        ``"batch_instance"`` — constructor kwargs such as
        ``rate=``/``horizon=`` forwarded), or any time-ordered iterable of
        :class:`~repro_torch.traffic.arrivals.Job`.  Serving knobs go in a
        :class:`~repro_torch.api.config.ServeConfig` (``config=``) or as the
        flat keywords of
        :class:`~repro_torch.traffic.simulator.TrafficSimulator` — one
        spelling per call, never both.

        ``fairness`` (``True`` or a
        :class:`~repro_torch.fairness.drf.ResourceModel`) arms per-tenant
        fairness accounting (Jain index, per-model slowdown vs isolated
        baselines, dominant-share series).

        ``obs`` (``True`` or a :class:`~repro_torch.obs.Observability`) arms
        structured tracing + the time-series metrics registry: scheduler
        lifecycle spans, preemption/migration markers, per-node/per-tenant
        series, back as ``ServeResult.timeline`` with terminal-render,
        Perfetto-trace and CSV exporters.  Per-layer spans derive from
        ``keep_trace=True`` records, so pass both for a span-level trace.
        Pure observation: armed runs serialize the same base record.

        ``faults`` (a :class:`~repro_torch.chaos.FaultPlan`, a
        :class:`~repro_torch.chaos.FaultEvent` or a sequence of events) arms
        seeded fault injection: crashes, blackouts, column-loss
        degradation, bus stalls and stragglers.  ``monitor`` (default
        :class:`~repro_torch.chaos.HealthMonitor`) detects failures at
        dispatch boundaries; ``recovery`` (registry name or
        :class:`~repro_torch.chaos.RecoveryPolicy`, default
        ``retry_restart``) re-dispatches lost jobs with backoff and
        checkpoint warm restarts.  The accounting comes back on
        ``ServeResult.chaos``.

        ``admission`` (``"static"``, ``"codel"``, ``"token_bucket"`` or an
        :class:`~repro_torch.overload.AdmissionPolicy`) and ``brownout``
        (``True`` or a :class:`~repro_torch.overload.BrownoutController`)
        arm overload control: tier-aware shedding in front of the
        dispatcher and the degrade-before-drop stage ladder.

        ``memory`` (``True`` or a
        :class:`~repro_torch.core.scheduler.ContentionModel`) arms
        fleet-shared DRAM bandwidth contention.  Every knob left unarmed
        keeps the serialized record byte-identical to a run without it.
        """
        from repro_torch.traffic.simulator import TrafficSimulator

        return TrafficSimulator(
            arrivals, policy=self.policy, backend=self.backend, config=config, **kwargs
        ).run()

    def run_all(
        self, workloads: Sequence[str] | None = None
    ) -> dict[str, SessionResult]:
        """Run every named workload (default: all of ``WORKLOADS``)."""
        if workloads is None:
            from repro_torch.sim import workloads as _w

            workloads = sorted(_w.WORKLOADS)
        return {wl: self.run(wl) for wl in workloads}
