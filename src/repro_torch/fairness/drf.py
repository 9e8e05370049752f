"""Dominant-resource fairness over systolic-array resource vectors.

The port's own copy of ``repro.fairness.drf``.  A tenant's footprint on the
accelerator is a vector: the columns it occupies, the share of the stage-in
DRAM bus its transfers consume, and the SRAM its stationary weights pin.
DRF (Ghodsi et al., NSDI'11) allocates by **progressive filling** so every
tenant's *dominant* share stays as equal as floors and demands allow.

:class:`ResourceModel` maps one layer to its per-column demand vector;
:class:`DRFPolicy` (registered ``"drf"``) runs progressive filling inside
:meth:`~repro_torch.api.policy.PartitionPolicy.widths`: one column at a
time to the tenant with the smallest dominant share (ties → placement
order), floors first, saturation at ``width_demand``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.api.policy import (
    PartitionPolicy,
    TenantDemand,
    _admit_by_floor,
    _floor_cols,
    register_policy,
)
from repro_torch.core.dnng import LayerShape


@dataclasses.dataclass(frozen=True)
class ResourceModel:
    """Per-column resource demand vector of one layer.

    Three resources, each normalized by a capacity so shares compare:
    **columns** (1/``total_cols`` per granted column), **stage-in bus** (the
    layer's stage-in transfer time spread over its usable columns, over
    ``window_s``) and **SRAM** (``weight_bytes / usable width`` over
    ``sram_bytes``).  Defaults follow the sim backend's constants (64 GB/s
    bus, 2-byte elements) with a 100 µs window and a 4 MiB weight SRAM.
    """

    bus_bytes_per_s: float = 64e9
    window_s: float = 100e-6
    sram_bytes: float = 4 * 2**20
    bytes_per_elem: int = 2

    def usable_width(self, layer: LayerShape, total_cols: int) -> int:
        return max(1, min(layer.gemm_n, total_cols))

    def per_col_vector(
        self, layer: LayerShape, total_cols: int
    ) -> tuple[float, float, float]:
        """(columns, bus, sram) consumed per granted column, normalized."""
        width = self.usable_width(layer, total_cols)
        stage_elems = layer.gemm_k * (layer.gemm_n + layer.gemm_m)
        bus_s = stage_elems * self.bytes_per_elem / self.bus_bytes_per_s
        return (
            1.0 / total_cols,
            (bus_s / width) / self.window_s,
            (layer.weight_bytes / width) / self.sram_bytes,
        )

    def dominant_per_col(self, layer: LayerShape, total_cols: int) -> float:
        """Dominant-share increment of one granted column (all resources
        scale linearly with columns, so ``w`` columns cost ``w`` times this)."""
        return max(self.per_col_vector(layer, total_cols))


@register_policy("drf")
class DRFPolicy(PartitionPolicy):
    """Dominant-resource-fair widths via progressive filling.

    ``assign`` stays the paper's Task_Assignment: DRF acts at the split.
    Demands without a concrete ``layer`` fall back to a columns-only vector
    (max-min fairness over columns).
    """

    def __init__(self, resources: ResourceModel | None = None):
        self.resources = resources or ResourceModel()

    def _dominant_per_col(self, t: TenantDemand, total_cols: int) -> float:
        if t.layer is None:
            return 1.0 / max(1, total_cols)
        return self.resources.dominant_per_col(t.layer, total_cols)

    def widths(
        self, total_cols: int, tenants: Sequence[TenantDemand]
    ) -> dict[str, int]:
        placed = _admit_by_floor(self.order(tenants), total_cols)
        if not placed:
            return {}
        ws = {t.name: _floor_cols(t) for t in placed}
        cols_left = total_cols - sum(ws.values())
        per_col = {t.name: self._dominant_per_col(t, total_cols) for t in placed}
        caps = {}
        for t in placed:
            cap = t.width_demand if t.width_demand else total_cols
            caps[t.name] = max(_floor_cols(t), min(cap, total_cols))
        rank = {t.name: i for i, t in enumerate(placed)}
        active = [t.name for t in placed if ws[t.name] < caps[t.name]]
        # progressive filling, one column per step — O(cols × tenants)
        while cols_left > 0 and active:
            name = min(active, key=lambda n: (ws[n] * per_col[n], rank[n]))
            ws[name] += 1
            cols_left -= 1
            if ws[name] >= caps[name]:
                active.remove(name)
        return ws

    def dominant_share(
        self, layer: Optional[LayerShape], cols: int, total_cols: int
    ) -> float:
        """Dominant share of a tenant holding ``cols`` columns for ``layer``,
        consistent with the shares :meth:`widths` equalizes."""
        if layer is None:
            return cols / max(1, total_cols)
        return cols * self.resources.dominant_per_col(layer, total_cols)
