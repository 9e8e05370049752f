"""Brownout — the port's own copy of ``repro.overload.brownout``: degrade
batch service in stages before dropping anything.

Brownout (Klein et al.) keeps a saturated service inside its SLA by
switching off *optional* work instead of shedding requests.  The serving
analogue here: when the fleet's queue-delay estimate stays above target
— or detected-healthy capacity drops below the floor — the controller
walks DOWN a declared :class:`BrownoutStage` ladder, and walks back UP
when the pressure clears.  The default ladder degrades batch tenants in
escalating steps, shedding only as the last resort:

1. ``cap_bandwidth``    — tighten batch tenants' DRAM-bandwidth caps
   (the ``bandwidth`` hook surface: ``MemorySystem.set_caps``);
2. ``shrink_floors``    — scale batch tenants' column demand down so the
   partition policy hands their columns to tier 0;
3. ``stretch_deadlines``— relax batch deadlines (batch throughput is an
   SLO of *eventually*, not *now*);
4. ``shed``             — drop batch arrivals at admission.

Stage transitions are hysteresis-guarded (``enter_after`` consecutive
over-target samples to escalate, ``exit_after`` under-target samples to
relax), recorded as ``brownout`` tracer instants, and priced at
``transition_energy_j`` each — reconfiguring caps/floors re-stages
weights, which is not free.

The controller itself only *decides*; the
:class:`~repro_torch.traffic.simulator.TrafficSimulator` applies the active
stage's caps/floors/stretches to the fleet (it owns the nodes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class BrownoutStage:
    """One rung of the degradation ladder (all knobs target batch tiers).

    ``batch_bw_cap`` — per-tenant DRAM bandwidth share in (0, 1] for
    every batch tenant (None = leave caps alone); ``batch_demand_scale``
    — multiplier in (0, 1] on batch tenants' column demand (1 = no
    shrink); ``deadline_stretch`` — multiplier >= 1 on batch jobs'
    arrival-to-deadline slack; ``shed_batch`` — drop batch arrivals at
    admission while this stage is active.
    """

    name: str
    batch_bw_cap: Optional[float] = None
    batch_demand_scale: float = 1.0
    deadline_stretch: float = 1.0
    shed_batch: bool = False

    def __post_init__(self) -> None:
        if self.batch_bw_cap is not None and not 0.0 < self.batch_bw_cap <= 1.0:
            raise ValueError(f"batch_bw_cap must be in (0, 1], got {self.batch_bw_cap}")
        if not 0.0 < self.batch_demand_scale <= 1.0:
            raise ValueError(
                f"batch_demand_scale must be in (0, 1], got "
                f"{self.batch_demand_scale}"
            )
        if self.deadline_stretch < 1.0:
            raise ValueError(
                f"deadline_stretch must be >= 1, got {self.deadline_stretch}"
            )


#: the declared degradation ladder: bandwidth -> floors -> deadlines ->
#: shed.  Later stages keep the earlier stages' knobs tightened — the
#: ladder is cumulative by construction, not by controller logic.
DEFAULT_STAGES: tuple[BrownoutStage, ...] = (
    BrownoutStage("cap_bandwidth", batch_bw_cap=0.25),
    BrownoutStage("shrink_floors", batch_bw_cap=0.2, batch_demand_scale=0.5),
    BrownoutStage(
        "stretch_deadlines",
        batch_bw_cap=0.15,
        batch_demand_scale=0.35,
        deadline_stretch=2.0,
    ),
    BrownoutStage(
        "shed",
        batch_bw_cap=0.1,
        batch_demand_scale=0.25,
        deadline_stretch=2.0,
        shed_batch=True,
    ),
)


@dataclasses.dataclass(frozen=True)
class BrownoutReport:
    """End-of-run brownout accounting (``ServeResult.brownout``)."""

    stages: tuple[str, ...]
    transitions: int
    energy_overhead_j: float
    final_stage: Optional[str]
    # (t, from_stage_or_None, to_stage_or_None) per transition
    log: tuple[tuple, ...] = ()


class BrownoutController:
    """The feedback loop: sample pressure, walk the stage ladder.

    ``delay_target_s`` is the queue-delay setpoint; ``capacity_floor``
    (optional) additionally treats detected-healthy capacity below the
    floor as overload, so a half-dead fleet browns out even at nominal
    arrival rate.  ``enter_after``/``exit_after`` are the hysteresis
    lengths in arrival samples; exit is deliberately slower than entry
    so the controller does not flap around the setpoint.
    """

    def __init__(
        self,
        stages: tuple = DEFAULT_STAGES,
        delay_target_s: float = 5e-3,
        enter_after: int = 4,
        exit_after: int = 12,
        capacity_floor: Optional[float] = None,
        transition_energy_j: float = 0.05,
    ):
        if not stages:
            raise ValueError("brownout needs at least one stage")
        if delay_target_s <= 0:
            raise ValueError(f"delay_target_s must be positive, got {delay_target_s}")
        if enter_after < 1 or exit_after < 1:
            raise ValueError(
                f"hysteresis lengths must be >= 1, got "
                f"enter_after={enter_after}, "
                f"exit_after={exit_after}"
            )
        if capacity_floor is not None and not 0.0 < capacity_floor <= 1.0:
            raise ValueError(f"capacity_floor must be in (0, 1], got {capacity_floor}")
        if transition_energy_j < 0:
            raise ValueError(
                f"transition_energy_j must be >= 0, got {transition_energy_j}"
            )
        self.stages = tuple(stages)
        self.delay_target_s = delay_target_s
        self.enter_after = enter_after
        self.exit_after = exit_after
        self.capacity_floor = capacity_floor
        self.transition_energy_j = transition_energy_j
        self.stage_idx = -1  # -1 = ladder off (normal service)
        self.transitions = 0
        self.energy_overhead_j = 0.0
        self.log: list[tuple] = []  # (t, from_name, to_name)
        self._over = 0
        self._under = 0

    @property
    def stage(self) -> Optional[BrownoutStage]:
        """The active stage, or None while the ladder is off."""
        return self.stages[self.stage_idx] if self.stage_idx >= 0 else None

    def observe(self, now: float, delay_s: float, healthy_frac: float = 1.0) -> bool:
        """Feed one pressure sample; returns True when the active stage
        changed (the caller then re-applies caps/floors to the fleet and
        emits the tracer instant)."""
        overloaded = delay_s > self.delay_target_s or (
            self.capacity_floor is not None and healthy_frac < self.capacity_floor
        )
        if overloaded:
            self._over += 1
            self._under = 0
            if self._over >= self.enter_after and self.stage_idx < len(self.stages) - 1:
                self._over = 0
                return self._shift(now, self.stage_idx + 1)
        else:
            self._under += 1
            self._over = 0
            if self._under >= self.exit_after and self.stage_idx >= 0:
                self._under = 0
                return self._shift(now, self.stage_idx - 1)
        return False

    def _shift(self, now: float, new_idx: int) -> bool:
        old = self.stage
        self.stage_idx = new_idx
        new = self.stage
        self.transitions += 1
        self.energy_overhead_j += self.transition_energy_j
        self.log.append(
            (
                now,
                old.name if old is not None else None,
                new.name if new is not None else None,
            )
        )
        return True

    def shed(self, tier: int) -> bool:
        """Drop this arrival?  Only batch tiers, only in a shed stage —
        everything milder ran out first (degrade before drop)."""
        s = self.stage
        return s is not None and s.shed_batch and tier > 0

    def stretch_deadline(self, tier: int, arrival: float, deadline: float) -> float:
        """The (possibly stretched) deadline for an arriving job."""
        s = self.stage
        if s is None or tier <= 0 or s.deadline_stretch == 1.0:
            return deadline
        return arrival + (deadline - arrival) * s.deadline_stretch

    def report(self) -> BrownoutReport:
        return BrownoutReport(
            stages=tuple(s.name for s in self.stages),
            transitions=self.transitions,
            energy_overhead_j=self.energy_overhead_j,
            final_stage=self.stage.name if self.stage is not None else None,
            log=tuple(self.log),
        )
