"""Min-cost-flow assignment: Firmament-style global matching.

The port's own copy of ``repro.fairness.flow``.  The stock policies bind
ready layers to free slices greedily (heaviest → largest); Firmament (Gog et
al., OSDI'16) poses the same decision as a **min-cost max-flow** over a
task→resource graph, which is tiny here (ready layers × free slices).

:func:`min_cost_assignment` is successive shortest paths (Bellman-Ford on
the residual graph), deterministic under cost ties.
:class:`MinCostFlowPolicy` (registered ``"min_cost_flow"``) prices every
(layer, slice) edge with one batch oracle pass
(:meth:`~repro_torch.api.policy.AssignContext.time_batch`) and returns the
matching of maximum cardinality and, among those, least predicted runtime.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from repro_torch.api.policy import (
    AssignContext,
    EqualPolicy,
    ReadyLayer,
    register_policy,
)
from repro_torch.core.partition import Assignment, Partition


def min_cost_assignment(costs: Sequence[Sequence[float]]) -> list[tuple[int, int]]:
    """Max-cardinality, min-cost bipartite matching.

    ``costs[i][j]`` is the (finite, non-negative) cost of matching left node
    ``i`` to right node ``j``; an infinite entry forbids the edge.  Returns
    matched ``(i, j)`` pairs sorted by ``i``.
    """
    n = len(costs)
    m = len(costs[0]) if n else 0
    if n == 0 or m == 0:
        return []
    src, snk = n + m, n + m + 1
    size = n + m + 2
    # edge: [to, residual capacity, cost, index of reverse edge]
    graph: list[list[list]] = [[] for _ in range(size)]

    def add(u: int, v: int, cap: int, cost: float) -> list:
        fwd = [v, cap, cost, len(graph[v])]
        graph[u].append(fwd)
        graph[v].append([u, 0, -cost, len(graph[u]) - 1])
        return fwd

    # a large negative credit per matched left node dominates any real edge
    # cost: max-cardinality first, min cost among those second
    finite = [c for row in costs for c in row if math.isfinite(c)]
    credit = sum(finite) + len(finite) + 1.0
    for i in range(n):
        add(src, i, 1, -credit)
    for j in range(m):
        add(n + j, snk, 1, 0.0)
    match_edges = []
    for i in range(n):
        for j in range(m):
            c = costs[i][j]
            if math.isfinite(c):
                match_edges.append((i, j, add(i, n + j, 1, float(c))))
    inf = math.inf
    while True:
        # Bellman-Ford shortest path src→snk over residual edges
        dist = [inf] * size
        dist[src] = 0.0
        prev: list = [None] * size
        for _ in range(size):
            improved = False
            for u in range(size):
                du = dist[u]
                if du == inf:
                    continue
                for e in graph[u]:
                    if e[1] > 0 and du + e[2] < dist[e[0]]:
                        dist[e[0]] = du + e[2]
                        prev[e[0]] = (u, e)
                        improved = True
            if not improved:
                break
        if prev[snk] is None or dist[snk] >= 0.0:
            break  # no augmenting path still profitable
        v = snk
        while v != src:
            u, e = prev[v]
            e[1] -= 1
            graph[e[0]][e[3]][1] += 1
            v = u
    return sorted((i, j) for i, j, e in match_edges if e[1] == 0)


@register_policy("min_cost_flow")
class MinCostFlowPolicy(EqualPolicy):
    """Equal splits + globally min-cost layer→slice assignment.

    ``split``/``widths`` stay Algorithm 1's equal cuts; only the binding
    step changes.  Grants are whole slices.  ``max_width_factor`` (optional)
    forbids edges that would strand a layer on a slice wider than that
    multiple of its usable width.  Without an oracle in the context, costs
    fall back to ``opr / n_pes``.
    """

    def __init__(self, max_width_factor: Optional[float] = None):
        if max_width_factor is not None and max_width_factor < 1.0:
            raise ValueError(f"max_width_factor must be >= 1, got {max_width_factor}")
        self.max_width_factor = max_width_factor

    def assign(
        self,
        ready: Sequence[ReadyLayer],
        partitions: Sequence[Partition],
        ctx: AssignContext | None = None,
    ) -> list[Assignment]:
        ready = list(ready)
        parts = list(partitions)
        if not ready or not parts:
            return []
        if ctx is not None and ctx.time_fn is not None:
            pairs = [(layer, p) for _, _, layer in ready for p in parts]
            flat = ctx.time_batch(pairs)
            k = len(parts)
            costs = [flat[i * k : (i + 1) * k] for i in range(len(ready))]
        else:
            costs = [[layer.opr / p.n_pes for p in parts] for _, _, layer in ready]
        if self.max_width_factor is not None:
            for row, (_, _, layer) in zip(costs, ready):
                limit = self.max_width_factor * self._demand_cols(layer, ctx)
                for j, p in enumerate(parts):
                    if p.cols > limit:
                        row[j] = math.inf
        out = []
        for i, j in min_cost_assignment(costs):
            tenant, idx, layer = ready[i]
            out.append(
                Assignment(
                    tenant=tenant, layer_index=idx, layer=layer, partition=parts[j]
                )
            )
        return out
