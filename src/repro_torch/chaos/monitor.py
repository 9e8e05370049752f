"""Failure detection — the port's own copy of ``repro.chaos.monitor``:
heartbeat staleness + service-estimate outliers.

A real fleet never sees a "crash event"; it sees heartbeats stop and tail
latencies blow up.  :class:`HealthMonitor` models exactly that at the
dispatch boundary (the simulator calls :meth:`refresh` before every
routing decision):

* **heartbeat staleness** — a dead node's last heartbeat is its failure
  instant; once the gap exceeds ``suspect_after_s`` the node is
  *suspect*, past ``dead_after_s`` it is *dead*.  Detection latency is
  therefore deterministic given the arrival stream: the first refresh at
  ``t >= fail_t + dead_after_s`` flips the belief;
* **dispatch failure** — routing a job to a node that is actually down
  is a definitive signal (the RPC fails): the node is marked dead
  immediately, costing one lost job instead of a staleness wait;
* **service outliers** — a straggler (gray failure) heartbeats fine but
  completes slowly.  Completions feed a per-node EWMA of
  ``observed service / estimate``; a node whose EWMA exceeds
  ``outlier_factor ×`` the fleet median (with ``min_observations``
  samples) is suspect.  After ``probe_after_s`` it is re-probed: stats
  reset, node readmitted — if it is still slow it re-trips after
  another ``min_observations`` completions.

Beliefs (``healthy`` / ``suspect`` / ``dead``) live on
``ArrayNode.health``; truth lives on ``ArrayNode.alive``.  The monitor
only ever *reads* truth through the heartbeat model — dispatchers act on
belief via :meth:`~repro_torch.traffic.cluster.FleetLoads.exclude` /
``readmit``, so an undetected failure still eats jobs (the realistic
window the retry path exists for).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"


@dataclasses.dataclass
class HealthMonitor:
    """Classify fleet nodes at dispatch boundaries; drive exclusion."""

    suspect_after_s: float = 2e-3  # heartbeat gap -> suspect
    dead_after_s: float = 5e-3  # heartbeat gap -> dead
    outlier_factor: float = 3.0  # EWMA vs fleet median -> suspect
    min_observations: int = 3  # completions before the ratio rule arms
    ewma_alpha: float = 0.3
    probe_after_s: float = 20e-3  # suspected-straggler re-probe interval

    def __post_init__(self) -> None:
        if not 0.0 < self.suspect_after_s <= self.dead_after_s:
            raise ValueError(
                f"need 0 < suspect_after_s <= dead_after_s, got "
                f"{self.suspect_after_s}, {self.dead_after_s}"
            )
        if self.outlier_factor <= 1.0:
            raise ValueError(f"outlier_factor must be > 1, got {self.outlier_factor}")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}")
        self._ratio: dict[int, float] = {}  # node -> service-ratio EWMA
        self._n_obs: dict[int, int] = {}
        self._suspected_at: dict[int, float] = {}  # straggler probation start
        # (t, node, old, new, cause) belief transitions, in detection order
        self.transitions: list[tuple[float, int, str, str, str]] = []

    # -- signal feeds -------------------------------------------------------
    def observe(self, node_index: int, ratio: float, now: float) -> None:
        """Fold one completion's ``observed/estimated`` service ratio."""
        prev = self._ratio.get(node_index)
        if prev is None:
            self._ratio[node_index] = ratio
            self._n_obs[node_index] = 1
        else:
            a = self.ewma_alpha
            self._ratio[node_index] = (1.0 - a) * prev + a * ratio
            self._n_obs[node_index] += 1

    def note_dispatch_failure(self, node, fleet, now: float) -> None:
        """A routed job hit a down node: the failed RPC is proof of death."""
        if node.health != DEAD:
            self._transition(now, node, DEAD, "dispatch_failure")
            fleet.exclude(node.index)

    # -- classification -----------------------------------------------------
    def _transition(self, now: float, node, new: str, cause: str) -> None:
        self.transitions.append((now, node.index, node.health, new, cause))
        node.health = new

    def refresh(self, now: float, nodes: Sequence, fleet) -> int:
        """Re-classify every node; sync fleet exclusion.  Returns how many
        transitions fired (the caller emits tracer markers off
        :attr:`transitions`)."""
        n0 = len(self.transitions)
        ratios = self._ratio
        n_obs = self._n_obs
        # fleet median service ratio over armed, believed-up nodes — the
        # straggler baseline (a mostly-healthy fleet pins it near 1.0)
        armed = sorted(
            ratios[n.index]
            for n in nodes
            if n.health != DEAD
            and n_obs.get(n.index, 0) >= self.min_observations
        )
        median = armed[len(armed) // 2] if armed else 0.0
        for node in nodes:
            i = node.index
            # heartbeat staleness: truth reaches belief only through this
            stale = 0.0 if node.alive else now - node.down_since
            if stale >= self.dead_after_s:
                if node.health != DEAD:
                    self._transition(now, node, DEAD, "heartbeat_lost")
                fleet.exclude(i)
                continue
            if stale >= self.suspect_after_s:
                if node.health == HEALTHY:
                    self._transition(now, node, SUSPECT, "heartbeat_stale")
                fleet.exclude(i)
                continue
            if not node.alive:
                # down, but the heartbeat gap is still below the suspect
                # threshold: undetectable by staleness.  A belief already
                # non-healthy (e.g. a definitive dispatch_failure) must
                # NOT be reset by the fresh-looking gap — keep it, and
                # keep the node excluded, until the node really returns.
                if node.health != HEALTHY:
                    fleet.exclude(i)
                continue
            # node is up: clear any stale non-healthy belief
            if node.health == DEAD:
                # blackout repair: the heartbeat is back
                self._transition(now, node, HEALTHY, "heartbeat_back")
                self._reset_stats(i)
                fleet.readmit(i)
                continue
            if node.health == SUSPECT and i in self._suspected_at:
                if now - self._suspected_at[i] >= self.probe_after_s:
                    # probation over: reset stats, readmit, re-judge fresh
                    del self._suspected_at[i]
                    self._transition(now, node, HEALTHY, "probe_ok")
                    self._reset_stats(i)
                    fleet.readmit(i)
                continue
            if node.health == SUSPECT:
                # heartbeat-suspect node came back before dead_after_s
                self._transition(now, node, HEALTHY, "heartbeat_back")
                fleet.readmit(i)
                continue
            # healthy + fresh heartbeat: service-outlier rule
            if (
                median > 0.0
                and n_obs.get(i, 0) >= self.min_observations
                and ratios[i] >= self.outlier_factor * median
            ):
                self._transition(now, node, SUSPECT, "service_outlier")
                self._suspected_at[i] = now
                fleet.exclude(i)
        return len(self.transitions) - n0

    def _reset_stats(self, i: int) -> None:
        self._ratio.pop(i, None)
        self._n_obs.pop(i, None)
        self._suspected_at.pop(i, None)
