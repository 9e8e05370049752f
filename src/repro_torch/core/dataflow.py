"""Partitioned weight-stationary dataflow model (paper §3.4, Fig. 5 lines 28–42).

The port's own copy of ``repro.core.dataflow``.  The three phases of the
paper's loop-nest — ① *load* (weights → PE load registers), ② *feed* (IFMap
streamed left-to-right), ③ *drain* (OFMap columns → drain buffer) — are
modelled analytically per (GEMM × partition) pair.

GEMM convention (see ``repro_torch.core.dnng``):

    stationary:  K × N     (K on PE rows, N on PE columns — N is partitioned)
    streamed:    T × K     (T im2col rows fed through the array)
    output:      T × N

A partition of ``R`` rows × ``C`` columns executes the GEMM in
``ceil(K/R) · ceil(N/C)`` *folds*; each fold costs the Scale-Sim
weight-stationary cycle count ``2R + C + T - 2`` (R load, T feed, R+C-2
pipeline skew).  Partitions behave as independent sub-accelerators; a tenant
whose partition starts at column ``c0`` pays ``c0`` extra fill cycles once
per fold (data crosses foreign partitions tri-stated).

This is host arithmetic on Python ints and NumPy int64, as in the JAX
package: nothing here runs on the card.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np

from repro_torch.core.dnng import LayerShape
from repro_torch.core.partition import Partition


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class GEMM:
    """A (T × K) · (K × N) matmul in the WS orientation."""

    T: int  # streamed rows (N·P·Q of the layer)
    K: int  # reduction (C·R·S)
    N: int  # output channels (M) — the partitioned dimension

    @staticmethod
    def of_layer(layer: LayerShape) -> "GEMM":
        return GEMM(T=layer.gemm_m, K=layer.gemm_k, N=layer.gemm_n)

    @property
    def macs(self) -> int:
        return self.T * self.K * self.N


@dataclasses.dataclass(frozen=True)
class DataflowCost:
    """Cycle & access-count breakdown of one GEMM on one partition."""

    cycles: int
    folds_k: int
    folds_n: int
    macs: int
    # SRAM access counts (elements, not bytes)
    load_buf_reads: int  # ① weights read from load buffer
    feed_buf_reads: int  # ② ifmap rows read from feed buffer (per N-fold)
    drain_buf_writes: int  # ③ psums/ofmap written to drain buffer (per K-fold)
    # DRAM traffic (elements)
    dram_reads: int
    dram_writes: int
    # PE-cycle occupancy of the partition (for leakage/idle accounting)
    pe_cycles: int  # cycles × partition PEs
    active_pe_cycles: int  # cycles in which a PE performs a useful MAC
    # Mul_En accounting (paper Fig. 7): the multiplier fires only while the
    # partition's own feed data streams through; during ① load only the
    # load-register latch toggles.
    feed_pe_cycles: int  # fk·fn·T·R·C — multiplier-enabled PE-cycles
    load_pe_cycles: int  # fk·fn·R·R·C — load-phase latch-only PE-cycles


@functools.lru_cache(maxsize=1 << 16)
def ws_cost(gemm: GEMM, part: Partition) -> DataflowCost:
    """Analytic partitioned-WS cost of ``gemm`` on ``part`` (Fig. 5 loop-nest).

    Memoized: both arguments are frozen dataclasses and the result is pure,
    while the dynamic scheduler re-derives the same (layer, partition) costs
    on every rebalance.  :func:`ws_cost_cache_stats` exposes the hit rate and
    :func:`ws_cost_cache_clear` resets it.  This LRU is the port's own; the
    JAX package's is a different object.
    """
    R, C = part.rows, part.cols
    fk = _ceil_div(gemm.K, R)
    fn = _ceil_div(gemm.N, C)
    # per-fold cycles: load R + feed T + pipeline skew (R + C - 2), plus the
    # pass-through offset for partitions not starting at column 0
    per_fold = 2 * R + C + gemm.T - 2 + part.col_start
    cycles = fk * fn * per_fold
    macs = gemm.macs
    return DataflowCost(
        cycles=cycles,
        folds_k=fk,
        folds_n=fn,
        macs=macs,
        load_buf_reads=gemm.K * gemm.N,  # ① each weight loaded once
        feed_buf_reads=gemm.T * gemm.K * fn,  # ② ifmap re-streamed per N-fold
        drain_buf_writes=gemm.T * gemm.N * fk,  # ③ a T×N psum tile per K-fold
        dram_reads=gemm.K * gemm.N + gemm.T * gemm.K,  # weights + ifmap once
        dram_writes=gemm.T * gemm.N,  # ofmap once
        pe_cycles=cycles * part.n_pes,
        active_pe_cycles=macs,  # one MAC ≡ one active PE-cycle
        feed_pe_cycles=fk * fn * gemm.T * part.n_pes,
        load_pe_cycles=fk * fn * R * part.n_pes,
    )


def ws_cost_cache_stats() -> dict:
    """``ws_cost`` LRU counters: hits / misses / currsize / maxsize."""
    info = ws_cost.cache_info()
    return {
        "hits": info.hits,
        "misses": info.misses,
        "currsize": info.currsize,
        "maxsize": info.maxsize,
    }


def ws_cost_cache_clear() -> None:
    ws_cost.cache_clear()


# ---------------------------------------------------------------------------
# Batch cost oracle — one NumPy pass over pre-packed shape arrays.
#
# ws_cost_batch evaluates n paired (GEMM, partition) candidates elementwise
# over int64 arrays with the same integer arithmetic as ws_cost, so every
# field is bit-identical to the scalar path.  The largest product formed,
# cycles × n_pes, stays well inside int64 for the Table-1 shapes.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatchCost:
    """Structure-of-arrays :class:`DataflowCost` for n (GEMM, partition)
    pairs — the batch cost oracle's result table (all fields int64)."""

    cycles: np.ndarray
    folds_k: np.ndarray
    folds_n: np.ndarray
    macs: np.ndarray
    load_buf_reads: np.ndarray
    feed_buf_reads: np.ndarray
    drain_buf_writes: np.ndarray
    dram_reads: np.ndarray
    dram_writes: np.ndarray
    pe_cycles: np.ndarray
    active_pe_cycles: np.ndarray
    feed_pe_cycles: np.ndarray
    load_pe_cycles: np.ndarray
    # extra DRAM element-transfer slots lost to a reduced bandwidth share
    # (float64, all-zero at share 1.0); None unless priced with bw_shares=
    dram_stall_elems: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.cycles)

    def row(self, i: int) -> DataflowCost:
        """The i-th pair as a scalar :class:`DataflowCost` (Python ints)."""
        return DataflowCost(
            *(int(getattr(self, f.name)[i]) for f in dataclasses.fields(DataflowCost))
        )


def pack_gemms(gemms: Sequence[GEMM]) -> np.ndarray:
    """(n, 3) int64 array of (T, K, N) — the pre-packed shape side."""
    return np.array([(g.T, g.K, g.N) for g in gemms], dtype=np.int64).reshape(-1, 3)


def pack_partitions(parts: Sequence[Partition]) -> np.ndarray:
    """(n, 3) int64 array of (rows, col_start, cols)."""
    return np.array(
        [(p.rows, p.col_start, p.cols) for p in parts], dtype=np.int64
    ).reshape(-1, 3)


_BATCH_STATS = {"calls": 0, "pairs": 0}


def ws_cost_batch(
    gemms: Sequence[GEMM] | np.ndarray,
    parts: Sequence[Partition] | np.ndarray,
    bw_shares: Sequence[float] | np.ndarray | None = None,
) -> BatchCost:
    """Vectorized :func:`ws_cost` over paired candidates.

    ``gemms[i]`` is priced on ``parts[i]``.  Accepts pre-packed ``(n, 3)``
    int64 arrays (:func:`pack_gemms` / :func:`pack_partitions`) or the
    dataclass sequences.  Every output field equals the scalar
    :func:`ws_cost` exactly.

    ``bw_shares`` (optional) is the memory-bandwidth share in ``(0, 1]`` of
    each pair's tenant: it fills ``dram_stall_elems`` with ``(dram_reads +
    dram_writes) × (1/share − 1)``, exactly zero at share 1.0.  The int64
    columns never depend on it.
    """
    gm = gemms if isinstance(gemms, np.ndarray) else pack_gemms(gemms)
    pm = parts if isinstance(parts, np.ndarray) else pack_partitions(parts)
    if gm.shape != pm.shape:
        raise ValueError(
            f"paired batch needs matching shapes, got {gm.shape} vs {pm.shape}"
        )
    _BATCH_STATS["calls"] += 1
    _BATCH_STATS["pairs"] += len(gm)
    T, K, N = gm[:, 0], gm[:, 1], gm[:, 2]
    R, c0, C = pm[:, 0], pm[:, 1], pm[:, 2]
    fk = (K + R - 1) // R
    fn = (N + C - 1) // C
    folds = fk * fn
    per_fold = 2 * R + C + T - 2 + c0
    cycles = folds * per_fold
    n_pes = R * C
    macs = T * K * N
    stall = None
    if bw_shares is not None:
        bw = np.asarray(bw_shares, dtype=np.float64).reshape(-1)
        if len(bw) != len(gm):
            raise ValueError(
                f"bw_shares needs one share per pair, got {len(bw)} "
                f"for {len(gm)} pairs"
            )
        if np.any(bw <= 0.0) or np.any(bw > 1.0):
            raise ValueError("bw_shares must lie in (0, 1]")
        stall = (K * N + T * K + T * N) * (1.0 / bw - 1.0)
    return BatchCost(
        cycles=cycles,
        folds_k=fk,
        folds_n=fn,
        macs=macs,
        load_buf_reads=K * N,
        feed_buf_reads=T * K * fn,
        drain_buf_writes=T * N * fk,
        dram_reads=K * N + T * K,
        dram_writes=T * N,
        pe_cycles=cycles * n_pes,
        active_pe_cycles=macs,
        feed_pe_cycles=folds * T * n_pes,
        load_pe_cycles=folds * R * n_pes,
        dram_stall_elems=stall,
    )


def ws_cost_batch_stats() -> dict:
    """Batch-oracle counters: calls made / pairs evaluated."""
    return dict(_BATCH_STATS)


def ws_cost_batch_stats_clear() -> None:
    _BATCH_STATS["calls"] = 0
    _BATCH_STATS["pairs"] = 0


def utilization(gemm: GEMM, part: Partition) -> float:
    """Fraction of PE-cycles doing useful MACs (the paper's headline metric)."""
    c = ws_cost(gemm, part)
    return c.active_pe_cycles / c.pe_cycles if c.pe_cycles else 0.0


# ---------------------------------------------------------------------------
# Loop-nest description (Fig. 6(c)): the paper's Parallel_for / Temporal_for
# schedule in machine-checkable form.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LoopNest:
    """One partition's 3-phase schedule as (kind, axis, extent) triples."""

    partition: Partition
    load: tuple[tuple[str, str, int], ...]
    feed: tuple[tuple[str, str, int], ...]
    drain: tuple[tuple[str, str, int], ...]


def partitioned_ws_loopnest(gemm: GEMM, part: Partition) -> LoopNest:
    """Fig. 5 lines 28–42 for a single partition."""
    R, C = part.rows, part.cols
    return LoopNest(
        partition=part,
        # step ① — two Parallel_for: weights spatially mapped to rows & cols
        load=(("parallel", "row", min(R, gemm.K)), ("parallel", "col", min(C, gemm.N))),
        # step ② — feed: spatial rows, temporal columns (stream T values)
        feed=(("parallel", "row", min(R, gemm.K)), ("temporal", "col", gemm.T)),
        # step ③ — drain: spatial cols, temporal rows
        drain=(("parallel", "col", min(C, gemm.N)), ("temporal", "row", gemm.T)),
    )
