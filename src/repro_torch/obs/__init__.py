"""``repro_torch.obs`` — zero-cost-when-disabled observability, the port's
own copy of ``repro.obs``.

    from repro_torch.api import Session
    from repro_torch.obs import Observability

    obs = Observability()
    res = Session(policy="equal").serve("poisson", rate=500.0, horizon=0.1,
                                        pool="light", slo_s=0.01, obs=obs)
    print(res.timeline.render())             # terminal summary
    res.timeline.write_chrome_trace("t.json")  # load in ui.perfetto.dev

One :class:`Observability` object bundles the two collection surfaces:

* ``obs.tracer`` — ring-buffered span/event capture
  (`repro_torch.obs.tracer`): scheduler lifecycle spans, preemption/migration
  markers, policy decision audits;
* ``obs.registry`` — the time-series metrics registry
  (`repro_torch.obs.registry`): per-node/per-tenant counters, gauges and
  bounded series.

Every instrumentation point in the stack is guarded by ``if obs is not
None`` (or the per-surface ``tracer``/``registry`` handles), so the
disabled path adds no work and every serialized record stays
byte-identical; ``chip_smoke.py``'s serve phase gates the *armed*
overhead at ≤5% CPU time on the traffic cells.

Observation is pure: arming obs never changes event order, RNG
consumption, or any serialized result byte.
"""

from __future__ import annotations

from repro_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Series,
)
from repro_torch.obs.tracer import TraceEvent, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Observability",
    "Series",
    "Timeline",
    "TraceEvent",
    "Tracer",
    "resolve_obs",
]


class Observability:
    """Bundle of tracer + registry with arm/disarm flags.

    ``tracer=False`` / ``metrics=False`` disarm one surface (its handle is
    None and instrumentation points skip it).  ``audit=True`` additionally
    records a per-scheduling-round policy decision audit (ready
    candidates, offered widths, grants, declines, oracle probes) — by far
    the chattiest and most expensive event class, priced well outside the
    default overhead budget (``chip_smoke.py`` prints its cost as the
    audit ratio), so it is opt-in for targeted policy
    debugging rather than part of the default bundle.

    ``sample_every`` strides the simulator's arrival-synchronous
    time-series pulse (per-node utilization / queue depth / ready-set /
    bus series): every ``sample_every``-th arrival is sampled.  The
    default keeps the armed overhead inside the ≤5% traffic-bench gate;
    set ``1`` for full per-arrival resolution on short runs (the
    :class:`~repro_torch.obs.registry.Series` stride-doubling cap still bounds
    memory either way).
    """

    def __init__(
        self,
        tracer: bool = True,
        metrics: bool = True,
        audit: bool = False,
        max_events: int = 65536,
        max_samples: int = 4096,
        sample_every: int = 8,
    ):
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {sample_every}")
        self.tracer: Tracer | None = Tracer(max_events) if tracer else None
        self.registry: MetricsRegistry | None = (
            MetricsRegistry(max_samples) if metrics else None
        )
        self.audit = bool(audit) and tracer
        self.sample_every = sample_every

    # -- sharded folding -----------------------------------------------------
    def state(self) -> dict:
        """Picklable snapshot for cross-process pod folds."""
        return {
            "tracer": self.tracer.state() if self.tracer else None,
            "registry": self.registry.state() if self.registry else None,
        }

    def absorb(self, state: dict) -> None:
        """Merge one pod's :meth:`state` into this bundle."""
        if self.tracer is not None and state.get("tracer") is not None:
            self.tracer.absorb(state["tracer"])
        if self.registry is not None and state.get("registry") is not None:
            self.registry.merge(state["registry"])


def resolve_obs(obs) -> Observability | None:
    """Normalize the ``obs=`` front-door argument.

    ``None``/``False`` → disabled; ``True`` → a fresh default
    :class:`Observability`; an :class:`Observability` instance passes
    through (the caller reads the collected state off it afterwards).
    """
    if obs is None or obs is False:
        return None
    if obs is True:
        return Observability()
    if isinstance(obs, Observability):
        return obs
    raise ValueError(
        f"obs= takes None/bool or an Observability, got {type(obs).__name__}"
    )


class Timeline:
    """The ``ServeResult.timeline`` view of one run's collected obs state.

    Thin handle over the run's :class:`Observability`: summaries for the
    gated ``as_dict`` key, plus exporter shortcuts.
    """

    def __init__(self, obs: Observability):
        self._obs = obs

    @property
    def tracer(self) -> Tracer | None:
        return self._obs.tracer

    @property
    def registry(self) -> MetricsRegistry | None:
        return self._obs.registry

    def summary(self) -> dict:
        """Deterministic JSON-ready digest (the gated ``obs`` record key)."""
        out: dict = {}
        if self._obs.tracer is not None:
            out["events_recorded"] = self._obs.tracer.n_recorded
            out["events_dropped"] = self._obs.tracer.n_dropped
            out["events_by_kind"] = self._obs.tracer.counts_by_kind()
        if self._obs.registry is not None:
            out["metrics"] = self._obs.registry.as_dict()
        return out

    def render(self, title: str = "obs summary") -> str:
        from repro_torch.obs.render import render_summary

        return render_summary(self._obs.registry, self._obs.tracer, title=title)

    def chrome_trace(self) -> dict:
        from repro_torch.obs.export import chrome_trace

        if self._obs.tracer is None:
            raise ValueError("tracer was disarmed for this run")
        return chrome_trace(self._obs.tracer)

    def write_chrome_trace(self, path: str) -> dict:
        from repro_torch.obs.export import write_chrome_trace

        if self._obs.tracer is None:
            raise ValueError("tracer was disarmed for this run")
        return write_chrome_trace(path, self._obs.tracer)

    def timeline_csv(self) -> str:
        from repro_torch.obs.export import timeline_csv

        if self._obs.registry is None:
            raise ValueError("metrics registry was disarmed for this run")
        return timeline_csv(self._obs.registry)
