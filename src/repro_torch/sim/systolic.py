"""Analytic weight-stationary systolic-array timing model (Scale-Sim analogue).

The port's own copy of ``repro.sim.systolic``.  The paper evaluates with
Scale-Sim [16] in analytical mode; this is the equivalent closed-form model,
partition-aware (col offsets, per-partition folds) via
:func:`repro_torch.core.dataflow.ws_cost`.  Array config follows the paper
§4.2: a 128×128 PE array at the simulated accelerator's clock.  It is a
model of the paper's accelerator, not of the card: nothing here runs there.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

from repro_torch.core.dataflow import (
    GEMM,
    BatchCost,
    DataflowCost,
    ws_cost,
    ws_cost_batch,
)
from repro_torch.core.dnng import LayerShape
from repro_torch.core.partition import ArrayShape, Partition
from repro_torch.core.scheduler import TimeFn


@dataclasses.dataclass(frozen=True)
class SystolicConfig:
    """Hardware parameters of the simulated accelerator (paper §4.2)."""

    rows: int = 128
    cols: int = 128
    clock_hz: float = 940e6  # the simulated array's core clock (paper §4.2)
    dram_bw_bytes: float = 64e9  # off-chip staging bandwidth (shared bus)

    @property
    def array(self) -> ArrayShape:
        return ArrayShape(rows=self.rows, cols=self.cols)

    @property
    def macs_per_cycle(self) -> int:
        return self.rows * self.cols


@functools.lru_cache(maxsize=1 << 16)
def layer_cost(layer: LayerShape, part: Partition) -> DataflowCost:
    """Cycle/access breakdown of one layer on one partition (memoized on top
    of :func:`ws_cost`, skipping even the layer→GEMM lowering on repeats)."""
    return ws_cost(GEMM.of_layer(layer), part)


def layer_cycles(layer: LayerShape, part: Partition) -> int:
    return layer_cost(layer, part).cycles


def layer_cost_batch(
    layers: Sequence[LayerShape],
    parts: Sequence[Partition],
    bw_shares: Sequence[float] | None = None,
) -> BatchCost:
    """Vectorized :func:`layer_cost` over paired (layer, partition)
    candidates — one :func:`ws_cost_batch` NumPy pass after the layer→GEMM
    lowering.  Bit-identical to the scalar path; ``bw_shares`` fills only
    the ``dram_stall_elems`` column."""
    return ws_cost_batch(
        [GEMM.of_layer(layer) for layer in layers], parts, bw_shares=bw_shares
    )


class _BatchTimeOracle:
    """Memoized vectorized seconds oracle — ``time_fn.batch``.

    ``pairs`` → seconds for each (layer, partition), serving repeats from a
    dict memo.  Misses are evaluated in one :func:`layer_cost_batch` NumPy
    pass when there are at least ``VECTOR_THRESHOLD`` of them; fewer go
    through the ``layer_cost`` LRU.  Seconds always come from Python-int
    cycles (``.tolist()`` on the batch path) divided by ``clock_hz`` — the
    float op of the scalar path, so both paths give the same Python float.

    The memo is shared per ``clock_hz`` across the port's oracle instances
    (and is the port's own: the JAX package keeps a separate one).
    """

    __slots__ = ("clock_hz", "_memo", "hits", "misses")

    #: below this many missing pairs the scalar LRU path is used
    VECTOR_THRESHOLD = 32
    #: memo reset bound, as the scalar LRUs' maxsize (entries are pure)
    MAX_ENTRIES = 1 << 16

    _shared_memos: dict = {}

    @classmethod
    def clear_all(cls) -> None:
        """Drop every shared memo (tests, memory)."""
        cls._shared_memos.clear()

    def __init__(self, clock_hz: float):
        self.clock_hz = clock_hz
        self._memo = self._shared_memos.setdefault(clock_hz, {})
        self.hits = 0
        self.misses = 0

    def __call__(self, pairs: Sequence[tuple[LayerShape, Partition]]) -> list[float]:
        memo = self._memo
        missing = [pair for pair in pairs if pair not in memo]
        if missing:
            missing = list(dict.fromkeys(missing))  # dedupe, order kept
            self.misses += len(missing)
            if len(memo) + len(missing) > self.MAX_ENTRIES:
                # reset, but keep the entries this very call still serves
                keep = {p: memo[p] for p in pairs if p in memo}
                memo.clear()
                memo.update(keep)
            if len(missing) < self.VECTOR_THRESHOLD:
                clock = self.clock_hz
                for pair in missing:
                    memo[pair] = layer_cost(*pair).cycles / clock
            else:
                table = layer_cost_batch(
                    [la for la, _ in missing], [p for _, p in missing]
                )
                for pair, cyc in zip(missing, table.cycles.tolist()):
                    memo[pair] = cyc / self.clock_hz
        self.hits += len(pairs) - len(missing)
        return [memo[pair] for pair in pairs]

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses, "currsize": len(self._memo)}


def layer_time_fn(cfg: SystolicConfig) -> TimeFn:
    """Scheduler oracle: seconds for ``layer`` on ``part`` at ``cfg.clock_hz``.

    The callable carries a ``batch`` attribute (a :class:`_BatchTimeOracle`)
    that :meth:`repro_torch.api.policy.AssignContext.time_batch` discovers
    by ``getattr``.
    """

    clock = cfg.clock_hz

    def fn(layer: LayerShape, part: Partition) -> float:
        return layer_cost(layer, part).cycles / clock

    fn.batch = _BatchTimeOracle(clock)
    return fn
