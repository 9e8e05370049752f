"""Per-tenant fairness accounting — the port's own copy of
``repro.fairness.accounting``.

* **per-tenant slowdown** — mean completion latency of a tenant's jobs over
  the tenant's *isolated* service time: what one job takes alone on a whole
  array, sequential single-tenancy — a per-model
  :class:`~repro_torch.api.session.BaselineRun`
  (:func:`~repro_torch.core.scheduler.schedule_sequential`), memoized per
  model;
* **Jain fairness index** — ``J = (Σx)² / (n·Σx²)`` over the per-tenant
  slowdowns: 1.0 = perfectly even suffering, 1/n = one tenant absorbs it
  all;
* **dominant-share time series** — at every arrival instant the live column
  occupancy of each node
  (:meth:`~repro_torch.core.scheduler.DynamicScheduler.inflight_allocations`)
  is folded into per-model dominant resource shares under the same
  :class:`~repro_torch.fairness.drf.ResourceModel` the ``drf`` policy
  allocates by.

:class:`~repro_torch.traffic.simulator.TrafficSimulator` drives this behind
its ``fairness=`` flag and folds the report into the gated
:class:`~repro_torch.traffic.metrics.TrafficMetrics` fields.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.api.session import BaselineRun
from repro_torch.core.partition import ArrayShape
from repro_torch.core.scheduler import StageModel, TimeFn, schedule_sequential
from repro_torch.fairness.drf import ResourceModel


def jain_index(values: Sequence[float]) -> float:
    """Jain's fairness index ``(Σx)²/(n·Σx²)`` — 1.0 when all equal, 1/n
    when one value dominates; NaN for an empty set."""
    xs = list(values)
    if not xs:
        return float("nan")
    sq = sum(x * x for x in xs)
    if sq == 0.0:
        return 1.0  # all-zero allocations are (vacuously) even
    s = sum(xs)
    return (s * s) / (len(xs) * sq)


@dataclasses.dataclass(frozen=True)
class FairnessReport:
    """Folded fairness accounting of one serve run.

    ``per_tenant_slowdown`` maps model name → mean(latency / isolated
    service time) over the model's completed jobs (sorted keys);
    ``jain_fairness`` is the Jain index over those slowdowns.
    ``dominant_share_mean`` / ``jain_dominant_share`` summarize the sampled
    dominant-share series (None when sampling was off, as in the sharded
    simulator); ``dominant_share_series`` keeps the raw
    ``(t, ((model, share), ...))`` samples.
    """

    jain_fairness: float
    per_tenant_slowdown: dict[str, float]
    jain_dominant_share: Optional[float] = None
    dominant_share_mean: Optional[dict[str, float]] = None
    dominant_share_series: tuple = ()


class FairnessAccounting:
    """Accumulate fairness state over one serve run.

    ``observe(job)`` (every arrival) memoizes one DNNG template per model;
    the isolated baseline is computed lazily from the template, once per
    model.  ``sample(now, nodes)`` (every arrival, optional) folds the
    fleet's in-flight allocations into per-model dominant shares,
    normalized by the fleet column count; the retained series is bounded at
    ``max_samples`` points by deterministic stride-doubling decimation.
    ``report(records)`` folds everything into a :class:`FairnessReport`.
    """

    def __init__(
        self,
        array: ArrayShape,
        time_fn: TimeFn,
        stage: StageModel | None = None,
        n_arrays: int = 1,
        resources: ResourceModel | None = None,
        backend_name: str = "",
        max_samples: int = 8192,
    ):
        if max_samples < 2:
            raise ValueError(f"max_samples must be >= 2, got {max_samples}")
        self.array = array
        self.time_fn = time_fn
        self.stage = stage
        self.n_arrays = n_arrays
        self.resources = resources or ResourceModel()
        self.backend_name = backend_name
        self._templates: dict = {}  # model -> DNNG (arrival_time 0)
        self._baselines: dict[str, BaselineRun] = {}
        # bounded dominant-share reservoir: every stride-th offered sample
        # is kept; at max_samples the odd-index points drop and the stride
        # doubles — a uniform subsample with no RNG
        self._samples: list[tuple] = []
        self.max_samples = max_samples
        self._stride = 1
        self._n_offered = 0

    # -- isolated baselines --------------------------------------------------
    def observe(self, job) -> None:
        """Register one arriving :class:`~repro_torch.traffic.arrivals.Job`
        so its model's isolated baseline can be built on demand."""
        model = job.model
        if model not in self._templates:
            self._templates[model] = job.dnng.clone(name=model, arrival_time=0.0)

    def baseline(self, model: str) -> Optional[BaselineRun]:
        """The model's isolated run (sequential single-tenancy on a whole
        array), or None for a never-observed model."""
        base = self._baselines.get(model)
        if base is None:
            g = self._templates.get(model)
            if g is None:
                return None
            sched = schedule_sequential([g], self.array, self.time_fn, stage=self.stage)
            base = BaselineRun(
                workload=model, schedule=sched, backend=self.backend_name
            )
            self._baselines[model] = base
        return base

    def isolated_s(self, model: str) -> Optional[float]:
        base = self.baseline(model)
        return base.schedule.makespan if base is not None else None

    # -- dominant-share sampling ---------------------------------------------
    def sample(self, now: float, nodes) -> dict[str, float]:
        """Record per-model dominant shares of the live fleet occupancy at
        ``now`` (the paper's A_t arrival instants); returns the shares."""
        shares: dict[str, float] = {}
        total_cols = self.array.cols
        res = self.resources
        for node in nodes:
            for tenant, (layer, part) in node.scheduler.inflight_allocations().items():
                model = tenant.split("#", 1)[0]
                share = (
                    part.cols * res.dominant_per_col(layer, total_cols) / self.n_arrays
                )
                shares[model] = shares.get(model, 0.0) + share
        if self._n_offered % self._stride == 0:
            self._samples.append((now, tuple(sorted(shares.items()))))
            if len(self._samples) >= self.max_samples:
                del self._samples[1::2]
                self._stride *= 2
        self._n_offered += 1
        return shares

    # -- folding -------------------------------------------------------------
    def report(self, records) -> FairnessReport:
        slow: dict[str, list] = {}
        for r in records:
            lat = r.latency
            if lat is None:
                continue
            iso = self.isolated_s(r.model)
            if iso is None or iso <= 0.0:
                continue
            slow.setdefault(r.model, []).append(lat / iso)
        per = {m: sum(v) / len(v) for m, v in sorted(slow.items())}
        j_dom = dom_mean = None
        live = [pairs for _t, pairs in self._samples if pairs]
        if live:
            jains = [jain_index([s for _m, s in pairs]) for pairs in live]
            j_dom = sum(jains) / len(live)
            totals: dict[str, float] = {}
            for pairs in live:
                for m, s in pairs:
                    totals[m] = totals.get(m, 0.0) + s
            # mean over ALL samples (idle instants count as zero share): a
            # time-series mean, not a mean-when-present
            n = len(self._samples)
            dom_mean = {m: tot / n for m, tot in sorted(totals.items())}
        return FairnessReport(
            jain_fairness=jain_index(list(per.values())),
            per_tenant_slowdown=per,
            jain_dominant_share=j_dom,
            dominant_share_mean=dom_mean,
            dominant_share_series=tuple(self._samples),
        )
