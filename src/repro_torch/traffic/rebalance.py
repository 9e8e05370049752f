"""Cross-node tenant migration — the port's own copy of
``repro.traffic.rebalance``.

Dispatch (:mod:`repro_torch.traffic.cluster`) is a one-shot decision at
arrival time: once a job lands on an array it stays there, even when
service-time variance leaves one array drowning while a neighbour idles.
A :class:`Rebalancer`, which the
:class:`~repro_torch.traffic.simulator.TrafficSimulator` invokes
periodically (``rebalance_interval=``) and on deadline pressure at every
arrival, moves whole tenants between arrays.

Only *queued or pristine* tenants move — jobs waiting in a node's FIFO, or
submitted ones that have not touched the array yet
(:meth:`~repro_torch.core.scheduler.DynamicScheduler.withdraw`).  A moved
job pays a :class:`MigrationModel` transit delay (checkpoint over the
inter-node link) before it can start on the target, so thrash is
self-limiting.

The stock strategy is ``migrate_on_pressure``:

* **pressure moves** (every invocation): a queued job whose deadline would
  be busted where it sits is moved to the least-loaded node with a free
  run slot, as long as the transit delay does not itself bust the
  deadline;
* **balance moves** (periodic ticks only): while the fleet is imbalanced
  (``max - min in-system > imbalance``), tail jobs of the longest queue
  move to nodes with spare run slots.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Sequence

from repro_torch.core.dnng import DNNG
from repro_torch.core.registry import Registry


@dataclasses.dataclass(frozen=True)
class MigrationModel:
    """Checkpoint-transfer cost of moving one tenant between arrays.

    Only unstarted tenants migrate, so the checkpoint is the job's *input*
    (entry-layer IFMap) plus control state — model weights are assumed
    resident on every node of the serving fleet, as in any real
    multi-replica deployment.  ``include_weights=True`` models the cold
    fleet where the target must also receive the weights.

    ``fixed_overhead_s`` covers the control round-trip (drain decision,
    route update, admission at the target).
    """

    link_bw_bytes: float = 16e9
    fixed_overhead_s: float = 20e-6
    bytes_per_elem: int = 2
    include_weights: bool = False

    def checkpoint_bytes(self, dnng: DNNG) -> int:
        entry = dnng.layers[0]
        total = entry.ifmap_elems * self.bytes_per_elem
        if self.include_weights:
            total += sum(layer.weight_bytes for layer in dnng.layers)
        return total

    def migrate_s(self, dnng: DNNG) -> float:
        return self.fixed_overhead_s + self.checkpoint_bytes(dnng) / self.link_bw_bytes


class Rebalancer(abc.ABC):
    """Move queued/pristine tenants between :class:`ArrayNode`s."""

    name: str = ""

    def __init__(self, migration: MigrationModel | None = None):
        self.migration = migration or MigrationModel()
        self.n_migrations = 0
        # optional repro_torch.obs.Observability, set by the traffic
        # simulator; strategies emit a "migrate" instant per move through it
        self.obs = None

    @abc.abstractmethod
    def rebalance(self, nodes: Sequence, now: float, periodic: bool = False) -> int:
        """Perform migrations at time ``now``; return how many moved.

        ``periodic`` distinguishes the simulator's interval ticks (full
        rebalancing allowed) from arrival-time pressure checks (only
        deadline-driven moves).
        """


_REGISTRY = Registry("rebalancer")


def register_rebalancer(name: str):
    return _REGISTRY.register(name)


def list_rebalancers() -> list[str]:
    return _REGISTRY.names()


def resolve_rebalancer(rebalancer, **kwargs) -> Rebalancer:
    return _REGISTRY.resolve(rebalancer, Rebalancer, **kwargs)


@register_rebalancer("migrate_on_pressure")
class MigrateOnPressure(Rebalancer):
    """Deadline-pressure migration + periodic queue balancing.

    ``pressure_factor`` scales the miss prediction (``slack <
    pressure_factor × (local wait estimate + service estimate)`` marks a
    queued job as pressured); ``imbalance`` is the minimum in-system gap
    between the most- and least-loaded nodes before a periodic balance
    move fires.
    """

    def __init__(
        self,
        migration: MigrationModel | None = None,
        pressure_factor: float = 1.0,
        imbalance: int = 2,
    ):
        super().__init__(migration)
        self.pressure_factor = pressure_factor
        self.imbalance = imbalance

    # -- helpers ------------------------------------------------------------
    def _best_target(self, nodes, src):
        """Least-loaded node (ties → lowest index) with a free run slot.

        Queue-to-queue moves are never worth the checkpoint transit, so a
        target must be able to run the job promptly."""
        best = None
        for node in nodes:
            if node is src:
                continue
            if not node.alive or node.health != "healthy":
                continue  # never migrate onto a failed/suspect node
            if node.scheduler.n_active >= node.max_concurrent:
                continue
            key = (node.in_system, node.index)
            if best is None or key < (best.in_system, best.index):
                best = node
        return best

    def _move(self, src, target, name: str, now: float) -> bool:
        job = src.take_for_migration(name)
        if job is None:
            return False
        delay = self.migration.migrate_s(job.dnng)
        target.admit_migrated(job, now, ready_at=now + delay)
        self.n_migrations += 1
        tracer = getattr(self.obs, "tracer", None)
        if tracer is not None:
            tracer.instant(
                "migrate",
                now,
                target.index,
                name,
                (("src", src.index), ("dst", target.index), ("delay_s", delay)),
            )
        return True

    # -- the strategy -------------------------------------------------------
    def rebalance(self, nodes: Sequence, now: float, periodic: bool = False) -> int:
        if len(nodes) < 2:
            return 0
        if not any(n.queue for n in nodes):
            # only queued jobs ever move (pressure AND balance paths), so
            # an all-drained fleet needs no sort/wait-estimate work — the
            # common case at every sub-saturation arrival
            return 0
        moves = 0
        # pressure moves: queued jobs predicted to miss where they sit
        for src in sorted(nodes, key=lambda n: (-n.in_system, n.index)):
            wait = src.wait_estimate()  # loop-invariant until a move
            for job in list(src.queue):
                slack = job.deadline - now
                if slack <= 0:
                    continue  # already doomed: moving it cannot help
                est = src.service_estimate(job.dnng)
                if slack >= self.pressure_factor * (wait + est):
                    continue
                target = self._best_target(nodes, src)
                if target is None or target.in_system >= src.in_system:
                    continue
                if self.migration.migrate_s(job.dnng) + est >= slack:
                    continue  # transit would bust the deadline anyway
                if self._move(src, target, job.dnng.name, now):
                    moves += 1
                    wait = src.wait_estimate()
        if not periodic:
            return moves
        # balance moves: drain the longest queues into idle capacity
        while True:
            src = max(nodes, key=lambda n: (n.in_system, -n.index))
            target = self._best_target(nodes, src)
            if (
                target is None
                or not src.queue
                or src.in_system - target.in_system < self.imbalance
            ):
                break
            if not self._move(src, target, src.queue[-1].dnng.name, now):
                break
            moves += 1
        return moves
