"""Recovery policies — the port's own copy of ``repro.chaos.recovery``:
what happens to the jobs a fault took down.

The primitives already exist elsewhere in the stack; this module only
composes them:

* **capped exponential backoff** (:class:`RetryPolicy`) with per-tier
  retry budgets and seeded jitter — the release schedule for lost jobs;
* **checkpoint-based warm restart** — a tenant's completed layers were
  staged out to DRAM, so a retry replays only the un-checkpointed tail
  (:func:`truncate_dnng`) and pays the
  :class:`~repro_torch.traffic.rebalance.MigrationModel` transit for exactly
  that remainder (the truncated entry layer's IFMap *is* the
  checkpoint);
* **graceful degradation** — when detected-healthy fleet capacity drops
  below a tier's watermark, that tier's arrivals are shed at admission
  so tier-0 latency survives the capacity loss.

Policies are registry-named (``resolve_recovery``): ``retry_restart`` is
the full recovery path, ``none`` disables re-dispatch entirely — the
control arm of the crash cell.
"""

from __future__ import annotations

import abc
import dataclasses
import random

from repro_torch.core.dnng import DNNG
from repro_torch.core.registry import Registry
from repro_torch.traffic.rebalance import MigrationModel


def truncate_dnng(dnng: DNNG, completed: int, arrival_time: float) -> DNNG:
    """The un-checkpointed remainder of ``dnng`` after ``completed`` layers.

    Keeps the job's name (the record builder keys on it); a chain simply
    drops its prefix, a DAG additionally remaps edges (edges into the
    completed prefix are satisfied by checkpointed outputs and vanish).
    """
    if completed <= 0:
        return dnng.clone(arrival_time=arrival_time)
    if completed >= len(dnng.layers):
        raise ValueError(
            f"{dnng.name!r}: cannot truncate {completed} of {len(dnng.layers)} layers"
        )
    edges = None
    if dnng.edges is not None:
        edges = tuple(
            (s - completed, d - completed) for s, d in dnng.edges if s >= completed
        )
    return DNNG(
        name=dnng.name,
        layers=dnng.layers[completed:],
        arrival_time=arrival_time,
        edges=edges,
    )


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with per-tier budgets and seeded jitter.

    ``budgets[tier]`` is how many re-dispatches a lost job of that tier
    gets (tiers beyond the tuple clamp to the last entry — lower tiers
    get fewer retries, the same way they get shed first).  ``jitter_frac``
    spreads releases ±frac around the deterministic backoff using the
    run-seeded rng the controller owns, so identical seeds yield
    identical retry schedules.
    """

    base_backoff_s: float = 1e-3
    backoff_factor: float = 2.0
    max_backoff_s: float = 50e-3
    jitter_frac: float = 0.1
    budgets: tuple[int, ...] = (3, 2, 1)

    def __post_init__(self) -> None:
        if self.base_backoff_s <= 0 or self.max_backoff_s <= 0:
            raise ValueError("backoff times must be positive")
        if self.backoff_factor < 1.0:
            raise ValueError(f"backoff_factor must be >= 1, got {self.backoff_factor}")
        if not 0.0 <= self.jitter_frac < 1.0:
            raise ValueError(f"jitter_frac must be in [0, 1), got {self.jitter_frac}")
        if not self.budgets or any(b < 0 for b in self.budgets):
            raise ValueError(f"budgets must be non-negative, got {self.budgets}")

    def budget(self, tier: int) -> int:
        return self.budgets[min(tier, len(self.budgets) - 1)]

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        d = min(self.base_backoff_s * self.backoff_factor**attempt, self.max_backoff_s)
        if self.jitter_frac:
            d *= 1.0 + self.jitter_frac * (2.0 * rng.random() - 1.0)
        return d


def respawn_backoffs(
    n: int, seed_key: str, retry: RetryPolicy | None = None
) -> list[float]:
    """First-attempt backoff delays for ``n`` jobs re-admitted after a pod
    respawn (`repro_torch.traffic.sharded`).

    A dead pod's in-flight jobs re-enter through the same capped-backoff
    schedule a node crash uses — one fresh attempt each, jittered by a
    dedicated ``random.Random(seed_key)`` stream so respawn recovery is
    seed-stable and independent of every other rng in the run (the pod's
    own dispatch rng is reconstructed separately by the routing
    fast-forward).
    """
    retry = retry or RetryPolicy()
    rng = random.Random(seed_key)
    return [retry.delay_s(0, rng) for _ in range(n)]


class RecoveryPolicy(abc.ABC):
    """What to do with a lost job, and when to shed under low capacity."""

    name: str = ""

    @abc.abstractmethod
    def retry_budget(self, tier: int) -> int:
        """How many re-dispatches a lost job of ``tier`` is entitled to."""

    @abc.abstractmethod
    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Backoff before re-dispatch number ``attempt`` (0-based)."""

    def checkpoint_layers(self, completed: int) -> int:
        """Layers recoverable from checkpoints given ``completed`` done."""
        return completed

    def restore_s(self, remainder: DNNG) -> float:
        """Warm-restart transit cost for the un-checkpointed remainder."""
        return 0.0

    def should_shed(self, tier: int, healthy_frac: float) -> bool:
        """Shed a ``tier`` arrival at ``healthy_frac`` detected capacity?"""
        return False


_REGISTRY = Registry("recovery policy")


def register_recovery(name: str):
    return _REGISTRY.register(name)


def list_recoveries() -> list[str]:
    return _REGISTRY.names()


def resolve_recovery(recovery) -> RecoveryPolicy:
    return _REGISTRY.resolve(recovery, RecoveryPolicy)


@register_recovery("retry_restart")
class RetryRestart(RecoveryPolicy):
    """Backoff re-dispatch + checkpoint warm restart + watermark shedding.

    ``checkpoint_every`` sets checkpoint granularity: a job that finished
    k layers restarts from the highest multiple of ``checkpoint_every``
    at or below k (1 = every layer output is a checkpoint).
    ``shed_below`` maps *tier -> capacity watermark*: a tier-T arrival is
    shed while the detected-healthy capacity fraction is below the
    watermark of any tier <= T.  Tier 0 is never shed (keys must be
    >= 1) — that is the point of graceful degradation.
    """

    def __init__(
        self,
        retry: RetryPolicy | None = None,
        migration: MigrationModel | None = None,
        checkpoint_every: int = 1,
        shed_below: dict[int, float] | None = None,
    ):
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
        if shed_below and min(shed_below) < 1:
            raise ValueError(
                f"shed_below tiers must be >= 1 (tier 0 is never shed), "
                f"got {sorted(shed_below)}"
            )
        self.retry = retry or RetryPolicy()
        self.migration = migration or MigrationModel()
        self.checkpoint_every = checkpoint_every
        self.shed_below = dict(shed_below or {})

    def retry_budget(self, tier: int) -> int:
        return self.retry.budget(tier)

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        return self.retry.delay_s(attempt, rng)

    def checkpoint_layers(self, completed: int) -> int:
        return (completed // self.checkpoint_every) * self.checkpoint_every

    def restore_s(self, remainder: DNNG) -> float:
        return self.migration.migrate_s(remainder)

    def should_shed(self, tier: int, healthy_frac: float) -> bool:
        for t, watermark in self.shed_below.items():
            if tier >= t and healthy_frac < watermark:
                return True
        return False


@register_recovery("none")
class NoRecovery(RecoveryPolicy):
    """Detection still runs, but lost jobs stay lost — the control arm of
    the recovered-vs-unrecovered bench comparison."""

    def retry_budget(self, tier: int) -> int:
        return 0

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        return 0.0
