"""Seeded fault schedules — the port's own copy of ``repro.chaos.faults``.

A :class:`FaultPlan` is a time-sorted tuple of :class:`FaultEvent`, built
explicitly or sampled by :meth:`FaultPlan.seeded` from a seed.  Every
fault the serving fleet can suffer is one event kind:

* ``crash``     — permanent node loss at ``t`` (all resident jobs lost);
* ``blackout``  — transient loss: the node dies at ``t`` and comes back
  empty after ``duration_s`` of repair;
* ``degrade``   — ``dead_cols`` columns of the node's systolic array die;
  the node keeps serving on the shrunken :class:`~repro_torch.core.partition
  .ArrayShape` and resident partitions are re-fit by the live
  :class:`~repro_torch.api.policy.PartitionPolicy`;
* ``bus_stall`` — the node's stage-in/out bus slows by ``factor``× for
  ``duration_s`` (0 = permanently);
* ``straggler`` — the node's compute slows by ``factor``× for
  ``duration_s`` (0 = permanently) — the classic gray failure the
  :class:`~repro_torch.chaos.monitor.HealthMonitor` must catch from service
  outliers, not heartbeats;
* ``pod_kill``  — a :class:`~repro_torch.traffic.sharded
  .ShardedTrafficSimulator` worker process (``node`` = pod index) is
  killed at the start of epoch ``epoch``.  Only the sharded simulator
  accepts this kind; the single-process simulator rejects it.

Plans are pure data: applying them is :class:`~repro_torch.chaos.controller
.ChaosController`'s job.  Two plans built from the same seed are equal —
the determinism contract the serve phase of ``chip_smoke.py`` pins.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Sequence

FAULT_KINDS = ("crash", "blackout", "degrade", "bus_stall", "straggler", "pod_kill")
# kinds whose effect ends after duration_s (0 = permanent)
_WINDOW_KINDS = ("bus_stall", "straggler")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: what breaks, where, when, and how badly."""

    t: float
    kind: str
    node: int = 0  # array-node index ("pod_kill": pod index)
    duration_s: float = 0.0  # blackout repair time / stall|straggle window
    factor: float = 1.0  # bus_stall / straggler slowdown multiplier
    dead_cols: int = 0  # degrade: columns lost
    epoch: int = 0  # pod_kill: epoch index the worker dies at

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}")
        if self.t < 0.0:
            raise ValueError(f"fault time must be >= 0, got {self.t}")
        if self.node < 0:
            raise ValueError(f"fault node must be >= 0, got {self.node}")
        if self.duration_s < 0.0:
            raise ValueError(f"duration_s must be >= 0, got {self.duration_s}")
        if self.kind == "blackout" and self.duration_s <= 0.0:
            raise ValueError("blackout needs a positive duration_s (repair time)")
        if self.kind in _WINDOW_KINDS and self.factor <= 1.0:
            raise ValueError(
                f"{self.kind} needs a slowdown factor > 1, got {self.factor}"
            )
        if self.kind == "degrade" and self.dead_cols < 1:
            raise ValueError(f"degrade needs dead_cols >= 1, got {self.dead_cols}")
        if self.kind == "pod_kill" and self.epoch < 0:
            raise ValueError(f"pod_kill epoch must be >= 0, got {self.epoch}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A named, time-sorted schedule of fault events."""

    events: tuple[FaultEvent, ...] = ()
    name: str = "plan"

    def __post_init__(self) -> None:
        ordered = tuple(
            sorted(self.events, key=lambda e: (e.t, e.node, e.kind, e.epoch))
        )
        object.__setattr__(self, "events", ordered)

    def __len__(self) -> int:
        return len(self.events)

    def kinds(self) -> dict[str, int]:
        """Histogram of event kinds (sorted keys) — the bench's plan digest."""
        out: dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return dict(sorted(out.items()))

    @classmethod
    def single(cls, kind: str, t: float, node: int = 0, **kw) -> "FaultPlan":
        """One-event plan — the common test/example shape."""
        return cls(events=(FaultEvent(t=t, kind=kind, node=node, **kw),), name=kind)

    @classmethod
    def seeded(
        cls,
        seed: int,
        horizon: float,
        n_nodes: int,
        *,
        crashes: int = 0,
        blackouts: int = 0,
        degrades: int = 0,
        bus_stalls: int = 0,
        stragglers: int = 0,
        dead_cols: int = 16,
        stall_factor: float = 4.0,
        straggler_factor: float = 3.0,
        repair_frac: float = 0.2,
        window: tuple[float, float] = (0.25, 0.75),
        name: str | None = None,
    ) -> "FaultPlan":
        """Sample a deterministic plan from ``seed``.

        Event times are uniform in ``window`` (fractions of ``horizon``),
        nodes uniform over the fleet; blackout repair and stall/straggle
        windows last ``repair_frac × horizon``.  The same arguments always
        yield an equal plan.
        """
        if horizon <= 0 or n_nodes < 1:
            raise ValueError(
                f"need horizon > 0 and n_nodes >= 1, got {horizon}, {n_nodes}"
            )
        rng = random.Random(f"faultplan:{seed}")
        lo, hi = window[0] * horizon, window[1] * horizon
        events = []
        for kind, count in (
            ("crash", crashes),
            ("blackout", blackouts),
            ("degrade", degrades),
            ("bus_stall", bus_stalls),
            ("straggler", stragglers),
        ):
            for _ in range(count):
                t = rng.uniform(lo, hi)
                node = rng.randrange(n_nodes)
                if kind == "crash":
                    events.append(FaultEvent(t=t, kind=kind, node=node))
                elif kind == "blackout":
                    events.append(
                        FaultEvent(
                            t=t, kind=kind, node=node, duration_s=repair_frac * horizon
                        )
                    )
                elif kind == "degrade":
                    events.append(
                        FaultEvent(t=t, kind=kind, node=node, dead_cols=dead_cols)
                    )
                elif kind == "bus_stall":
                    events.append(
                        FaultEvent(
                            t=t,
                            kind=kind,
                            node=node,
                            factor=stall_factor,
                            duration_s=repair_frac * horizon,
                        )
                    )
                else:
                    events.append(
                        FaultEvent(
                            t=t,
                            kind=kind,
                            node=node,
                            factor=straggler_factor,
                            duration_s=repair_frac * horizon,
                        )
                    )
        return cls(events=tuple(events), name=name or f"seeded-{seed}")


def resolve_faults(faults) -> FaultPlan:
    """Coerce a plan / event / event sequence into a :class:`FaultPlan`."""
    if isinstance(faults, FaultPlan):
        return faults
    if isinstance(faults, FaultEvent):
        return FaultPlan(events=(faults,), name=faults.kind)
    if isinstance(faults, Sequence) and not isinstance(faults, (str, bytes)):
        events = tuple(faults)
        if all(isinstance(e, FaultEvent) for e in events):
            return FaultPlan(events=events)
    raise ValueError(
        f"faults= takes a FaultPlan, a FaultEvent, or a sequence of "
        f"FaultEvent, got {type(faults).__name__}"
    )
