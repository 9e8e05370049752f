"""Accelerator backend protocol — the port's own copy of ``repro.api.backend``.

A backend answers what the scheduler and :class:`~repro_torch.api.session
.Session` need: ``array`` (the partitionable geometry), ``time_fn`` (the
compute oracle ``(layer, partition) -> seconds``), ``stage_model`` (the
shared-bus staging model) and ``energy`` (post-hoc energy accounting of a
finished schedule, or None).

Registered backends (``list_backends()``):

=========  ==============================================================
``mesh``   device columns timed by
           :class:`~repro_torch.distributed.tenancy.MeshLatencyModel`
           (compute + per-layer collective + launch overhead), whose
           defaults are the H100's own measured constants; no energy model
``sim``    the paper's evaluation rig: the Scale-Sim-style analytic cycle
           model (:mod:`repro_torch.sim.systolic`) and the 45 nm Mul_En
           energy model (:mod:`repro_torch.sim.energy`) on a 128×128
           weight-stationary array
=========  ==============================================================

Both are host arithmetic: they model an accelerator and put nothing on the
card.
"""

from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

from repro_torch.core.dnng import LayerShape
from repro_torch.core.partition import ArrayShape
from repro_torch.core.registry import Registry
from repro_torch.core.scheduler import ScheduleResult, StageModel, TimeFn


@runtime_checkable
class EnergyReport(Protocol):
    """Structural type of a backend's energy accounting result: a joule
    ``total`` and a serializable ``as_dict``
    (:class:`repro_torch.sim.energy.EnergyBreakdown` is the canonical one)."""

    @property
    def total(self) -> float: ...

    def as_dict(self) -> dict: ...


@runtime_checkable
class Accelerator(Protocol):
    """Structural protocol — any object with this surface is a backend."""

    name: str

    @property
    def array(self) -> ArrayShape: ...

    def time_fn(self) -> TimeFn: ...

    def stage_model(self) -> Optional[StageModel]: ...

    def energy(
        self,
        result: ScheduleResult,
        layers_by_key: dict[tuple[str, int], LayerShape],
        baseline_pe: bool,
    ) -> Optional[EnergyReport]: ...


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY = Registry("backend")
_BACKENDS = _REGISTRY.items


def register_backend(name: str):
    return _REGISTRY.register(name)


def list_backends() -> list[str]:
    return _REGISTRY.names()


def get_backend(name: str, **kwargs) -> Accelerator:
    return _REGISTRY.get(name, **kwargs)


def resolve_backend(backend: "str | Accelerator", **kwargs) -> Accelerator:
    return _REGISTRY.resolve(backend, Accelerator, **kwargs)


# ---------------------------------------------------------------------------
# implementations
# ---------------------------------------------------------------------------


@register_backend("sim")
class SimBackend:
    """The paper's evaluation toolchain: analytic 128×128 WS systolic array
    (Scale-Sim analogue) + the 45 nm Mul_En energy model.  Host arithmetic
    only: it models the paper's accelerator and puts nothing on the card."""

    def __init__(self, config=None, energy=None):
        from repro_torch.sim.energy import EnergyModel
        from repro_torch.sim.systolic import SystolicConfig

        self.config = config or SystolicConfig()
        self.energy_model = energy or EnergyModel()

    @property
    def array(self) -> ArrayShape:
        return self.config.array

    def time_fn(self) -> TimeFn:
        from repro_torch.sim.systolic import layer_time_fn

        return layer_time_fn(self.config)

    def stage_model(self) -> Optional[StageModel]:
        return StageModel(dram_bw_bytes=self.config.dram_bw_bytes)

    def energy(self, result, layers_by_key, baseline_pe):
        from repro_torch.sim.energy import schedule_energy_with_layers

        return schedule_energy_with_layers(
            result,
            layers_by_key,
            self.config,
            self.energy_model,
            baseline_pe=baseline_pe,
        )


@register_backend("mesh")
class MeshBackend:
    """Cluster-scale backend: ``n_cols`` device columns, timed by
    :class:`~repro_torch.distributed.tenancy.MeshLatencyModel` (per-slice
    compute + output collective + dispatch overhead).  No energy model —
    mesh runs report time/utilization only."""

    def __init__(self, n_cols: int = 8, rows: int = 1, latency=None):
        from repro_torch.distributed.tenancy import MeshLatencyModel

        self.latency = latency or MeshLatencyModel()
        self._array = ArrayShape(rows=rows, cols=n_cols)

    @property
    def array(self) -> ArrayShape:
        return self._array

    def time_fn(self) -> TimeFn:
        return self.latency.time_fn()

    def stage_model(self) -> Optional[StageModel]:
        return StageModel(dram_bw_bytes=self.latency.host_bw_bytes)

    def energy(self, result, layers_by_key, baseline_pe):
        return None
