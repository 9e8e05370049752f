"""Time-series metrics registry — the port's own copy of
``repro.obs.registry``: counters, gauges, histograms, series.

The tracer (`repro_torch.obs.tracer`) answers "what happened when"; the registry
answers "how did X evolve" — per-node utilization, queue depth, ready-set
size, bus occupancy, per-tenant dominant share and slowdown, oracle-call
counters.  Four instrument types:

* :class:`Counter` — monotone accumulator (``inc``);
* :class:`Gauge` — last-write-wins scalar (``set``);
* :class:`Histogram` — streaming count/sum/min/max (``observe``) — enough
  for deterministic summaries without committing to bucket boundaries;
* :class:`Series` — a bounded ``(t, value)`` time series with
  deterministic stride-doubling decimation: once ``max_samples`` points
  are held, every other point is dropped and the acceptance stride
  doubles, so memory stays bounded and the retained points are a uniform
  subsample regardless of run length (no RNG — byte-stable exports).

A :class:`MetricsRegistry` memoizes instruments by name, serializes to a
picklable state dict, and merges pod states for
:class:`~repro_torch.traffic.sharded.ShardedTrafficSimulator` folds: counters
and histograms add, gauges keep the maximum, series interleave by
timestamp and re-decimate to the cap.
"""

from __future__ import annotations


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    __slots__ = ("count", "total", "min", "max")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def as_dict(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
        }


class Series:
    """Bounded time series under deterministic stride-doubling decimation.

    Every ``stride``-th offered sample is retained; when the retained set
    reaches ``max_samples`` the odd-index points are dropped and the
    stride doubles.  The retained points therefore always form a uniform
    ``stride``-spaced subsample of the offered stream — a windowed view
    whose resolution degrades gracefully as the run grows, with no
    randomness (exports stay byte-stable).

    The points are held as two parallel lists of times and values, not
    as ``(t, v)`` tuples: numbers are not tracked by the garbage
    collector, so an armed run's samples add no collection work;
    :attr:`samples` builds the tuples on read.
    """

    __slots__ = ("max_samples", "stride", "n_offered", "_t", "_v", "_sum")

    def __init__(self, max_samples: int = 4096):
        if max_samples < 2:
            raise ValueError(f"max_samples must be >= 2, got {max_samples}")
        self.max_samples = max_samples
        self.stride = 1
        self.n_offered = 0
        self._t: list[float] = []
        self._v: list[float] = []
        # running sum of the retained values: summaries are O(1), not a
        # rescan of up to max_samples points per digest
        self._sum = 0.0

    def sample(self, t: float, v: float) -> None:
        if self.n_offered % self.stride == 0:
            ts, vs = self._t, self._v
            ts.append(t)
            vs.append(v)
            self._sum += v
            if len(vs) >= self.max_samples:
                del ts[1::2]
                del vs[1::2]
                self.stride *= 2
                self._sum = sum(vs)
        self.n_offered += 1

    @property
    def samples(self) -> list[tuple[float, float]]:
        """The retained ``(t, value)`` points, oldest first."""
        return list(zip(self._t, self._v))

    def _set_samples(self, pts: list) -> None:
        self._t = [p[0] for p in pts]
        self._v = [p[1] for p in pts]
        self._sum = sum(self._v)

    @property
    def last(self) -> float | None:
        return self._v[-1] if self._v else None

    @property
    def mean(self) -> float:
        if not self._v:
            return float("nan")
        return self._sum / len(self._v)

    def summary(self) -> dict:
        return {
            "n": self.n_offered,
            "retained": len(self._v),
            "stride": self.stride,
            "last": self.last,
            "mean": self.mean,
        }


class MetricsRegistry:
    """Name-keyed instrument store with mergeable, picklable state."""

    def __init__(self, max_samples: int = 4096):
        self.max_samples = max_samples
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}
        self.series_map: dict[str, Series] = {}

    # -- instrument accessors (memoized by name) ----------------------------
    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        return h

    def series(self, name: str) -> Series:
        s = self.series_map.get(name)
        if s is None:
            s = self.series_map[name] = Series(self.max_samples)
        return s

    # -- summaries ----------------------------------------------------------
    def as_dict(self) -> dict:
        """Deterministic JSON-ready summary (sorted names; series are
        summarized, not dumped — use :func:`repro_torch.obs.export.timeline_csv`
        for the raw points)."""
        return {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {
                k: h.as_dict() for k, h in sorted(self.histograms.items())
            },
            "series": {
                k: s.summary() for k, s in sorted(self.series_map.items())
            },
        }

    # -- sharded folding ----------------------------------------------------
    def state(self) -> dict:
        """Full picklable snapshot (includes raw series points)."""
        return {
            "max_samples": self.max_samples,
            "counters": {k: c.value for k, c in self.counters.items()},
            "gauges": {k: g.value for k, g in self.gauges.items()},
            "histograms": {
                k: (h.count, h.total, h.min, h.max)
                for k, h in self.histograms.items()
            },
            "series": {
                k: (s.n_offered, s.samples)
                for k, s in self.series_map.items()
            },
        }

    def merge(self, state: dict) -> None:
        """Fold one pod's :meth:`state` into this registry.

        Counters and histograms add; gauges keep the max (pods report
        disjoint node gauges, so collisions only happen for fleet-level
        maxima); same-name series interleave by timestamp and re-decimate
        down to the cap.
        """
        for k, v in state["counters"].items():
            self.counter(k).inc(v)
        for k, v in state["gauges"].items():
            g = self.gauge(k)
            if v > g.value:
                g.value = v
        for k, (count, total, mn, mx) in state["histograms"].items():
            h = self.histogram(k)
            h.count += count
            h.total += total
            if mn < h.min:
                h.min = mn
            if mx > h.max:
                h.max = mx
        for k, (n_offered, samples) in state["series"].items():
            s = self.series(k)
            s.n_offered += n_offered
            pts = sorted(s.samples + [tuple(p) for p in samples])
            while len(pts) >= s.max_samples:
                del pts[1::2]
                s.stride *= 2
            s._set_samples(pts)
