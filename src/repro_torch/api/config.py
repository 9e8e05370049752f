"""``ServeConfig`` — the port's own copy of ``repro.api.config``.

Every knob :func:`repro_torch.traffic.serve` accepts beyond the arrival
stream and the policy × backend pair, grouped by subsystem into small frozen
dataclasses under one :class:`ServeConfig`, so a serving experiment is a
value that can be stored, diffed and re-used:

    from repro_torch.api import MemoryConfig, SchedulingConfig, ServeConfig

    cfg = ServeConfig(
        scheduling=SchedulingConfig(n_arrays=4, max_concurrent=3),
        memory=MemoryConfig(contention=True),
    )
    res = Session(policy="moca").serve("mmpp", config=cfg, rate=40.0, horizon=1.0)

Bare keywords keep working: ``serve(arrivals, n_arrays=4, memory=True)`` is
coerced into a :class:`ServeConfig` in one place
(:func:`resolve_serve_config`), so the simulator validates one canonical
object either way and its error messages are the same for both spellings.
Mixing the two spellings for the same run is rejected rather than merged.

Two fields are sentinel-valued (``None`` = "caller said nothing"):
``RebalanceConfig.rebalancer`` (naming one without an interval is an error,
even the default strategy's own name) and ``MemoryConfig.contention``
(memory contention is strictly opt-in).  The ``chaos`` and ``overload``
groups and ``obs`` arm :mod:`repro_torch.chaos`, :mod:`repro_torch.overload`
and :mod:`repro_torch.obs`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SchedulingConfig:
    """Fleet shape + per-node scheduler knobs (always active)."""

    n_arrays: int = 1
    dispatch: str = "jsq"
    max_concurrent: int = 4
    queue_cap: int = 16
    seed: int = 0
    keep_trace: bool = False
    # True (default PreemptionModel) or a model instance; None/False = off
    preemption: object = None
    check_invariants: bool = False


@dataclasses.dataclass(frozen=True)
class RebalanceConfig:
    """Cross-node migration: armed by ``interval`` (seconds per tick)."""

    interval: Optional[float] = None
    # sentinel: None = default strategy ("migrate_on_pressure") — an
    # explicit name (even the default's) without an interval is an error
    rebalancer: object = None
    migration: object = None  # MigrationModel, registry-built only


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Fault injection: armed by ``faults`` (FaultPlan/event/sequence)."""

    faults: object = None
    recovery: object = "retry_restart"
    monitor: object = None


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """Shared memory-bandwidth contention (``repro_torch.core.scheduler``).

    ``contention`` arms the fleet-shared DRAM bandwidth ledger: ``True`` for
    the default :class:`~repro_torch.core.scheduler.ContentionModel`, or a
    model instance.  ``None`` (default) keeps every serialized record
    byte-identical to runs without contention.
    """

    contention: object = None


@dataclasses.dataclass(frozen=True)
class OverloadConfig:
    """Closed-loop overload control: ``admission`` (a policy name or
    instance) and ``brownout`` (``True`` or a controller).  Both default to
    ``None`` (off)."""

    admission: object = None
    brownout: object = None


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Everything :func:`repro_torch.traffic.serve` accepts beyond the
    arrival stream and the policy × backend pair, grouped by subsystem."""

    scheduling: SchedulingConfig = dataclasses.field(default_factory=SchedulingConfig)
    rebalance: RebalanceConfig = dataclasses.field(default_factory=RebalanceConfig)
    # fairness accounting: True or a repro_torch.fairness.drf.ResourceModel
    fairness: object = False
    # observability: True or an Observability bundle
    obs: object = None
    chaos: ChaosConfig = dataclasses.field(default_factory=ChaosConfig)
    memory: MemoryConfig = dataclasses.field(default_factory=MemoryConfig)
    overload: OverloadConfig = dataclasses.field(default_factory=OverloadConfig)

    @classmethod
    def of(cls, **knobs) -> "ServeConfig":
        """Build a config from the flat keyword spelling — the one place
        bare ``serve()`` kwargs become a config."""
        unknown = set(knobs) - _SERVE_KNOBS
        if unknown:
            raise TypeError(f"unknown serve knobs: {sorted(unknown)}")
        return cls(
            scheduling=SchedulingConfig(
                n_arrays=knobs.get("n_arrays", 1),
                dispatch=knobs.get("dispatch", "jsq"),
                max_concurrent=knobs.get("max_concurrent", 4),
                queue_cap=knobs.get("queue_cap", 16),
                seed=knobs.get("seed", 0),
                keep_trace=knobs.get("keep_trace", False),
                preemption=knobs.get("preemption"),
                check_invariants=knobs.get("check_invariants", False),
            ),
            rebalance=RebalanceConfig(
                interval=knobs.get("rebalance_interval"),
                rebalancer=knobs.get("rebalancer"),
                migration=knobs.get("migration"),
            ),
            fairness=knobs.get("fairness", False),
            obs=knobs.get("obs"),
            chaos=ChaosConfig(
                faults=knobs.get("faults"),
                recovery=knobs.get("recovery", "retry_restart"),
                monitor=knobs.get("monitor"),
            ),
            memory=MemoryConfig(contention=knobs.get("memory")),
            overload=OverloadConfig(
                admission=knobs.get("admission"), brownout=knobs.get("brownout")
            ),
        )


#: the flat keyword surface ServeConfig.of consolidates — anything else
#: passed to serve()/TrafficSimulator is an arrival-process constructor
#: kwarg (forwarded to the arrivals registry)
_SERVE_KNOBS = frozenset(
    {
        "n_arrays",
        "dispatch",
        "max_concurrent",
        "queue_cap",
        "seed",
        "keep_trace",
        "preemption",
        "check_invariants",
        "rebalance_interval",
        "rebalancer",
        "migration",
        "fairness",
        "obs",
        "faults",
        "recovery",
        "monitor",
        "memory",
        "admission",
        "brownout",
    }
)


def resolve_serve_config(config, kwargs: dict) -> tuple[ServeConfig, dict]:
    """Split ``serve()``'s ``**kwargs`` into (config, arrival kwargs).

    ``kwargs`` is consumed: serve knobs are folded into a
    :class:`ServeConfig` (when ``config`` is None) and the remainder is
    returned for the arrivals registry.  Passing a knob both ways —
    ``config=`` alongside a flat serve keyword — raises, so one object
    always describes the run.
    """
    serve_kw = {k: kwargs.pop(k) for k in list(kwargs) if k in _SERVE_KNOBS}
    if config is not None:
        if not isinstance(config, ServeConfig):
            raise TypeError(
                f"config must be a ServeConfig, got {type(config).__name__}"
            )
        if serve_kw:
            raise ValueError(
                f"pass serve knobs via config= or as keywords, not both: "
                f"{sorted(serve_kw)}"
            )
        return config, kwargs
    return ServeConfig.of(**serve_kw), kwargs
