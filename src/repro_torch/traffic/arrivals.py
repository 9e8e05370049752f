"""Open-loop arrival processes — the port's own copy of
``repro.traffic.arrivals``.

Jobs arrive on their own clock, each with a deadline, and the system is
measured on latency percentiles and SLO attainment.  This module generates
those arrivals as timestamped :class:`Job` streams.

Five processes, all seeded and deterministic (``random.Random``, the same
stream of draws as the JAX package):

==================  =======================================================
``poisson``         memoryless arrivals at a constant ``rate``
``mmpp``            2-state Markov-modulated Poisson (calm ↔ burst states
                    with different rates and exponential dwell times)
``diurnal``         sinusoid-modulated rate via Lewis-Shedler thinning
``trace``           replay of a recorded JSON trace (list of
                    ``{"t", "model", "slo_s", "tier"}`` rows or a file path)
``batch_instance``  replay of an Alibaba cluster-trace ``batch_instance``
                    style CSV (per-row sizes mapped onto Table-1 DNNGs)
==================  =======================================================

Each job samples ONE Table-1 DNNG from a ``pool`` (see
``repro_torch.sim.workloads.MODEL_POOLS``) and carries an absolute
``deadline`` (= arrival + per-job SLO) plus an SLA ``tier``.
"""

from __future__ import annotations

import abc
import csv
import dataclasses
import io
import json
import math
import random
from typing import Iterator, Sequence

from repro_torch.core.dnng import DNNG
from repro_torch.core.registry import Registry
from repro_torch.sim.workloads import MODEL_POOLS, MODELS, sample_dnng


@dataclasses.dataclass(frozen=True)
class Job:
    """One arriving inference request: a DNNG with a deadline and a tier."""

    job_id: int
    arrival: float  # absolute arrival time (s)
    dnng: DNNG  # arrival_time == arrival; name unique per job
    deadline: float  # absolute completion deadline (s)
    tier: int = 0  # SLA class (smaller = more important)

    @property
    def model(self) -> str:
        """Base model name (the DNNG name minus the per-job suffix)."""
        return self.dnng.name.split("#", 1)[0]

    @property
    def slo_s(self) -> float:
        return self.deadline - self.arrival


class ArrivalProcess(abc.ABC):
    """Seeded generator of a finite, time-ordered :class:`Job` stream.

    Subclasses implement :meth:`_arrival_times`; job composition (model
    sampling, deadline, tier) is shared so processes differ only in their
    point process.  Iterating a process always replays the same stream.
    """

    name: str = ""

    def __init__(
        self,
        rate: float,
        horizon: float,
        seed: int = 0,
        pool: str = "light",
        slo_s: float = 0.05,
        tiers: Sequence[int] = (0,),
    ):
        if rate <= 0 or horizon <= 0:
            raise ValueError(
                f"rate and horizon must be positive (rate={rate}, horizon={horizon})"
            )
        if pool not in MODEL_POOLS:
            raise ValueError(f"unknown pool {pool!r}; known: {sorted(MODEL_POOLS)}")
        if not tiers:
            raise ValueError("tiers must be non-empty")
        self.rate = rate
        self.horizon = horizon
        self.seed = seed
        self.pool = pool
        self.slo_s = slo_s
        self.tiers = tuple(tiers)

    @abc.abstractmethod
    def _arrival_times(self, rng: random.Random) -> Iterator[float]:
        """Yield strictly increasing arrival instants < ``horizon``."""

    def __iter__(self) -> Iterator[Job]:
        # the rng is re-seeded per generation, so the stream is materialized
        # once and replayed from cache (Job and DNNG are frozen)
        cache = getattr(self, "_job_cache", None)
        if cache is None:
            cache = self._job_cache = list(self._generate())
        return iter(cache)

    def _generate(self) -> Iterator[Job]:
        rng = random.Random(self.seed)
        for jid, t in enumerate(self._arrival_times(rng)):
            g = sample_dnng(rng, pool=self.pool, arrival_time=t)
            g = g.clone(name=f"{g.name}#{jid}")
            yield Job(
                job_id=jid,
                arrival=t,
                dnng=g,
                deadline=t + self.slo_s,
                tier=rng.choice(self.tiers),
            )

    def jobs(self) -> list[Job]:
        return list(self)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY = Registry("arrival process")


def register_arrivals(name: str):
    return _REGISTRY.register(name)


def list_arrival_processes() -> list[str]:
    return _REGISTRY.names()


def get_arrival_process(name: str, **kwargs) -> ArrivalProcess:
    return _REGISTRY.get(name, **kwargs)


def resolve_arrivals(arrivals, **kwargs) -> ArrivalProcess:
    """Accept a registry name or an :class:`ArrivalProcess` instance."""
    return _REGISTRY.resolve(arrivals, ArrivalProcess, **kwargs)


# ---------------------------------------------------------------------------
# implementations
# ---------------------------------------------------------------------------


@register_arrivals("poisson")
class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson process: exponential inter-arrival times."""

    def _arrival_times(self, rng: random.Random) -> Iterator[float]:
        t = rng.expovariate(self.rate)
        while t < self.horizon:
            yield t
            t += rng.expovariate(self.rate)


@register_arrivals("mmpp")
class MMPPArrivals(ArrivalProcess):
    """2-state Markov-modulated Poisson process (bursty traffic).

    The process alternates between a calm and a burst state (rates in ratio
    ``burst_factor``), each with exponentially distributed dwell time of
    mean ``dwell_s``.  ``rate`` is the long-run mean arrival rate: the calm
    rate is ``2·rate/(1+burst_factor)``.
    """

    def __init__(
        self,
        rate: float,
        horizon: float,
        seed: int = 0,
        burst_factor: float = 4.0,
        dwell_s: float | None = None,
        **kwargs,
    ):
        super().__init__(rate, horizon, seed, **kwargs)
        if burst_factor <= 0:
            raise ValueError("burst_factor must be positive")
        if dwell_s is not None and dwell_s <= 0:
            raise ValueError("dwell_s must be positive")
        self.burst_factor = burst_factor
        self.calm_rate = 2.0 * rate / (1.0 + burst_factor)
        self.dwell_s = dwell_s if dwell_s is not None else horizon / 8.0

    def _arrival_times(self, rng: random.Random) -> Iterator[float]:
        t = 0.0
        burst = False
        switch_at = rng.expovariate(1.0 / self.dwell_s)
        while t < self.horizon:
            lam = self.calm_rate * (self.burst_factor if burst else 1.0)
            dt = rng.expovariate(lam)
            if t + dt >= switch_at:
                # the state flips before the tentative arrival: jump to the
                # switch instant and redraw (exponential = memoryless)
                t = switch_at
                burst = not burst
                switch_at = t + rng.expovariate(1.0 / self.dwell_s)
                continue
            t += dt
            if t < self.horizon:
                yield t


@register_arrivals("diurnal")
class DiurnalArrivals(ArrivalProcess):
    """Sinusoid-modulated Poisson: λ(t) = rate·(1 + amp·sin(2πt/period)),
    by Lewis-Shedler thinning against λ_max = rate·(1+amp)."""

    def __init__(
        self,
        rate: float,
        horizon: float,
        seed: int = 0,
        amplitude: float = 0.8,
        period_s: float | None = None,
        **kwargs,
    ):
        super().__init__(rate, horizon, seed, **kwargs)
        if not 0.0 <= amplitude <= 1.0:
            raise ValueError("amplitude must be in [0, 1]")
        if period_s is not None and period_s <= 0:
            raise ValueError("period_s must be positive")
        self.amplitude = amplitude
        self.period_s = period_s if period_s is not None else horizon

    def _arrival_times(self, rng: random.Random) -> Iterator[float]:
        lam_max = self.rate * (1.0 + self.amplitude)
        t = 0.0
        while True:
            t += rng.expovariate(lam_max)
            if t >= self.horizon:
                return
            lam_t = self.rate * (
                1.0 + self.amplitude * math.sin(2.0 * math.pi * t / self.period_s)
            )
            if rng.random() * lam_max <= lam_t:
                yield t


@register_arrivals("trace")
class TraceArrivals(ArrivalProcess):
    """Replay a recorded trace: a JSON file path or a list of row dicts.

    Each row: ``{"t": float, "model": str, "slo_s": float?, "tier": int?}``.
    ``model`` must be a ``repro_torch.sim.workloads.MODELS`` key.  Rows are
    sorted by ``t``; ``rate``/``horizon`` are derived from the trace itself.
    """

    def __init__(self, trace, slo_s: float = 0.05, seed: int = 0, **kwargs):
        if isinstance(trace, str):
            with open(trace) as f:
                rows = json.load(f)
        else:
            rows = list(trace)
        if not rows:
            raise ValueError("empty arrival trace")
        for r in rows:
            if r.get("model") not in MODELS:
                raise ValueError(
                    f"trace row has unknown model "
                    f"{r.get('model')!r}; known: {sorted(MODELS)}"
                )
        self._rows = sorted(rows, key=lambda r: float(r["t"]))
        horizon = float(self._rows[-1]["t"]) + 1e-9
        rate = len(rows) / horizon
        kwargs.setdefault("pool", "all")
        super().__init__(rate=rate, horizon=horizon, seed=seed, slo_s=slo_s, **kwargs)

    def _arrival_times(self, rng: random.Random) -> Iterator[float]:
        for r in self._rows:  # pragma: no cover — __iter__ is overridden
            yield float(r["t"])

    def __iter__(self) -> Iterator[Job]:
        for jid, r in enumerate(self._rows):
            t = float(r["t"])
            g = MODELS[r["model"]]()
            g = dataclasses.replace(g, name=f"{g.name}#{jid}", arrival_time=t)
            yield Job(
                job_id=jid,
                arrival=t,
                dnng=g,
                deadline=t + float(r.get("slo_s", self.slo_s)),
                tier=int(r.get("tier", 0)),
            )


# Alibaba cluster-trace v2018 batch_instance column layout (the subset the
# loader consumes, by header name with positional fallback)
_BI_COLUMNS = (
    "instance_name",
    "job_name",
    "task_type",
    "status",
    "start_time",
    "end_time",
    "plan_cpu",
    "plan_mem",
)


@register_arrivals("batch_instance")
class BatchInstanceArrivals(ArrivalProcess):
    """Replay an Alibaba ``batch_instance``-style CSV as a DNN job stream.

    ``source`` is a CSV file path or an iterable of CSV lines with columns
    ``instance_name,job_name,task_type,status,start_time,end_time,
    plan_cpu,plan_mem`` (a header row is detected and skipped).

    * rows whose ``status`` is not in ``keep_status`` (default
      ``Terminated``) or whose times are unusable are dropped;
    * **arrival** = ``(start_time − t₀ + jitter) × time_scale``; with
      ``jitter=True`` each row is spread uniformly inside its 1 s source
      second by the seeded rng, the only randomness in the replay;
    * **model**: each row's work ``(end−start) × plan_cpu`` is rank-mapped
      onto the ``pool``'s DNNGs sorted by total Opr;
    * **tier** 0 when ``plan_cpu ≥ cpu_hi``, else 1; the deadline is
      ``arrival + slo_s × (1 + tier)``.
    """

    def __init__(
        self,
        source,
        time_scale: float = 1e-3,
        slo_s: float = 0.05,
        seed: int = 0,
        pool: str = "heavy",
        keep_status: Sequence[str] = ("Terminated",),
        jitter: bool = True,
        cpu_hi: float = 100.0,
        **kwargs,
    ):
        if time_scale <= 0:
            raise ValueError(f"time_scale must be positive, got {time_scale}")
        rows = self._parse(source, set(keep_status))
        if not rows:
            raise ValueError(
                "no usable batch_instance rows (all filtered by status/time?)"
            )
        self._trace_rows = rows
        self.time_scale = time_scale
        self.jitter = jitter
        self.cpu_hi = cpu_hi
        self._t0 = min(r[0] for r in rows)
        last = max(r[0] for r in rows)
        # +1 source second: jittered arrivals stay strictly under horizon
        horizon = (last - self._t0 + 1.0) * time_scale
        super().__init__(
            rate=len(rows) / horizon,
            horizon=horizon,
            seed=seed,
            pool=pool,
            slo_s=slo_s,
            **kwargs,
        )

    @staticmethod
    def _parse(source, keep_status):
        if isinstance(source, str):
            with open(source, newline="") as f:
                return BatchInstanceArrivals._parse_file(f, keep_status)
        return BatchInstanceArrivals._parse_file(
            io.StringIO("\n".join(str(line) for line in source)), keep_status
        )

    @staticmethod
    def _parse_file(f, keep_status):
        rows = []
        header = None
        for rec in csv.reader(f):
            if not rec:
                continue
            if header is None and rec[0].strip() == _BI_COLUMNS[0]:
                header = {name.strip(): i for i, name in enumerate(rec)}
                continue
            if header is None:
                header = {name: i for i, name in enumerate(_BI_COLUMNS)}
            try:
                status = rec[header["status"]].strip()
                start = float(rec[header["start_time"]])
                end = float(rec[header["end_time"]])
                cpu = float(rec[header["plan_cpu"]] or 0.0)
            except (KeyError, IndexError, ValueError):
                continue  # malformed row: production traces have them
            if status not in keep_status or end <= start or start <= 0:
                continue
            col = header["task_type"]
            task_type = rec[col].strip() if col < len(rec) else ""
            rows.append((start, end, cpu, task_type))
        return rows

    def _pool_by_opr(self) -> list[str]:
        names = MODEL_POOLS[self.pool]
        return sorted(
            names, key=lambda n: (sum(layer.opr for layer in MODELS[n]().layers), n)
        )

    def _arrival_times(self, rng: random.Random) -> Iterator[float]:
        # __iter__ is overridden, but the base surface stays usable
        for t, _e, _c, _tt in sorted(self._trace_rows):
            yield (t - self._t0) * self.time_scale

    def __iter__(self) -> Iterator[Job]:
        cache = getattr(self, "_job_cache", None)
        if cache is None:
            cache = self._job_cache = list(self._generate_jobs())
        return iter(cache)

    def _generate_jobs(self) -> Iterator[Job]:
        rng = random.Random(self.seed)
        rows = self._trace_rows
        arrivals = []
        for start, _end, _cpu, _tt in rows:
            j = rng.random() if self.jitter else 0.0
            arrivals.append((start - self._t0 + j) * self.time_scale)
        # rank-map work quantiles onto the pool sorted by total Opr
        by_opr = self._pool_by_opr()
        work_order = sorted(
            range(len(rows)),
            key=lambda i: ((rows[i][1] - rows[i][0]) * rows[i][2], i),
        )
        model_of = [""] * len(rows)
        for rank, i in enumerate(work_order):
            model_of[i] = by_opr[rank * len(by_opr) // len(rows)]
        order = sorted(range(len(rows)), key=lambda i: (arrivals[i], i))
        for jid, i in enumerate(order):
            t = arrivals[i]
            g = MODELS[model_of[i]]()
            g = dataclasses.replace(g, name=f"{g.name}#{jid}", arrival_time=t)
            tier = 0 if rows[i][2] >= self.cpu_hi else 1
            yield Job(
                job_id=jid,
                arrival=t,
                dnng=g,
                deadline=t + self.slo_s * (1 + tier),
                tier=tier,
            )


def synth_batch_instance_rows(
    n: int, seed: int = 0, span_s: float = 600.0, burstiness: float = 0.3
) -> list[str]:
    """Generate an in-memory Alibaba-style ``batch_instance`` CSV: a header
    and ``n`` data rows shaped like the real trace (epoch-offset integer
    seconds, bursty arrivals, lognormal-ish durations, ``plan_cpu`` in
    centi-cores, a few non-``Terminated`` rows the loader must drop).
    Deterministic from (``n``, ``seed``)."""
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    rng = random.Random(seed)
    lines = [",".join(_BI_COLUMNS)]
    t = 86400.0  # arbitrary epoch offset: exercises t0 normalization
    mean_gap = span_s / n
    for i in range(n):
        if rng.random() < burstiness:
            t += rng.expovariate(8.0 / mean_gap)  # burst: 8x rate
        else:
            t += rng.expovariate(1.0 / mean_gap)
        dur = max(1.0, rng.lognormvariate(3.0, 1.0))
        cpu = rng.choice((50, 50, 100, 100, 100, 200, 400, 800))
        mem = round(rng.uniform(0.1, 4.0), 2)
        if rng.random() >= 0.05:
            status = "Terminated"
        else:
            status = rng.choice(("Failed", "Running"))
        lines.append(
            f"instance_{i},j_{i // 4},{1 + i % 12},{status},"
            f"{int(t)},{int(t + dur)},{cpu},{mem}"
        )
    return lines
