"""Host-facing wrappers around the partitioned-GEMM kernels.

Counterpart of ``repro.kernels.ops``.  ``fused_tenant_gemm`` takes one
(x, w) GEMM per tenant — arbitrary ragged shapes — pads them to a shared
geometry, builds the column-block ``owner`` map (each tenant's columns are a
contiguous run of blocks: the paper's vertical slices), makes ONE fused
kernel call and splits the outputs back out.  The zero padding is what makes
the ragged fusion exact (see ``ref.py``).

On top of the raw kernel this layer picks the grid mode (``"auto"``: the
compact live-tile launch whenever the ragged mix leaves dead blocks, the
dense launch when every block is live) and, when not pinned, the partition
block sizes (ranked by predicted fetched bytes per useful MAC).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.partitioned_matmul import (
    BlockAccounting,
    grid_accounting,
    partitioned_matmul,
)

# candidate partition-block edge lengths the autotuner searches per dimension
BLOCK_CANDIDATES = (128, 256, 512)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def build_owner_map(n_cols: Sequence[int], block_n: int) -> np.ndarray:
    """Column-block owner map for tenants with ``n_cols[i]`` output columns.

    Each tenant's columns are padded up to a whole number of blocks, so
    partitions are contiguous block runs — the kernel-level mirror of the
    paper's vertical slices.
    """
    owners = []
    for i, n in enumerate(n_cols):
        owners += [i] * (_round_up(n, block_n) // block_n)
    return np.asarray(owners, np.int32)


# ---------------------------------------------------------------------------
# geometry accounting + block-size autotuner
# ---------------------------------------------------------------------------


def _geometry_accounting(
    shapes: tuple[tuple[int, int, int], ...],
    block_t: int,
    block_k: int,
    block_n: int,
    x_dtype: str,
    w_dtype: str,
    grid_mode: str,
) -> BlockAccounting:
    """Accounting for a fused call over per-tenant ``(T, K, N)`` shapes,
    after the shared-grid padding ``fused_tenant_gemm`` applies."""
    T = _round_up(max(t for t, _, _ in shapes), block_t)
    K = _round_up(max(k for _, k, _ in shapes), block_k)
    owner = build_owner_map([n for _, _, n in shapes], block_n)
    return grid_accounting(
        T=T,
        K=K,
        N=int(owner.size) * block_n,
        owner=owner,
        valid_t=np.asarray([t for t, _, _ in shapes], np.int64),
        valid_k=np.asarray([k for _, k, _ in shapes], np.int64),
        block_t=block_t,
        block_k=block_k,
        block_n=block_n,
        x_dtype=x_dtype,
        w_dtype=w_dtype,
        grid_mode=grid_mode,
    )


@functools.lru_cache(maxsize=1024)
def autotune_blocks(
    shapes: tuple[tuple[int, int, int], ...],
    x_dtype: str = "float32",
    w_dtype: str = "float32",
    grid_mode: str = "compact",
    candidates: tuple[int, ...] = BLOCK_CANDIDATES,
) -> tuple[int, int, int]:
    """Pick the partition blocks ``(block_t, block_k, block_n)`` for a
    fused-GEMM geometry.

    Exhaustive search over ``candidates³``, ranked by predicted fetched bytes
    per useful MAC (padding inflates fetches, so the model penalises
    oversized blocks), ties broken toward fewer scheduled blocks, then
    smaller blocks — the JAX package's ranking key.  The TPU version also
    drops blockings whose working set busts the VMEM budget; the CUDA
    kernels' shared-memory need is fixed by their own CTA tile, whatever the
    partition blocks, so no candidate is filtered here.  Cached per geometry.
    """
    useful_macs = sum(t * k * n for t, k, n in shapes) or 1
    best, best_key = None, None
    for bt in candidates:
        for bk in candidates:
            for bn in candidates:
                acc = _geometry_accounting(
                    shapes, bt, bk, bn, x_dtype, w_dtype, grid_mode
                )
                key = (
                    acc.bytes_fetched / useful_macs,
                    acc.blocks_scheduled,
                    bt * bk * bn,
                )
                if best_key is None or key < best_key:
                    best, best_key = (bt, bk, bn), key
    return best


@dataclasses.dataclass(frozen=True)
class FusedGemmStats:
    """What one :func:`fused_tenant_gemm` call actually scheduled."""

    grid_mode: str
    block_t: int
    block_k: int
    block_n: int
    accounting: BlockAccounting

    def as_dict(self) -> dict:
        return {
            "grid_mode": self.grid_mode,
            "block_t": self.block_t,
            "block_k": self.block_k,
            "block_n": self.block_n,
            **self.accounting.as_dict(),
        }


def record_gemm_stats(registry, stats: FusedGemmStats) -> None:
    """Fold one fused-call :class:`FusedGemmStats` into a metrics registry
    (duck-typed: ``counter(name).inc(n)``, ``gauge(name).set(v)``,
    ``histogram(name).observe(v)``), under the JAX package's
    ``kernel.gemm.*`` names."""
    registry.counter("kernel.gemm.calls").inc()
    registry.gauge("kernel.gemm.block_t").set(stats.block_t)
    registry.gauge("kernel.gemm.block_k").set(stats.block_k)
    registry.gauge("kernel.gemm.block_n").set(stats.block_n)
    registry.histogram("kernel.gemm.schedule_efficiency").observe(
        stats.accounting.schedule_efficiency
    )
    acc = stats.accounting
    for key in (
        "blocks_total",
        "blocks_scheduled",
        "blocks_live",
        "blocks_skipped",
        "x_bytes_fetched",
        "w_bytes_fetched",
        "out_bytes_written",
    ):
        registry.counter(f"kernel.gemm.{key}").inc(getattr(acc, key))


def _operand_dtypes(xs, ws) -> tuple[torch.dtype, torch.dtype]:
    """The fused call's operand dtypes.  Mixed x/w dtypes promote to a
    common type here, BEFORE the byte accounting, as the kernel call will."""
    x_dt = functools.reduce(torch.promote_types, (x.dtype for x in xs))
    w_dt = functools.reduce(torch.promote_types, (w.dtype for w in ws))
    if x_dt != w_dt:
        x_dt = w_dt = torch.promote_types(x_dt, w_dt)
    return x_dt, w_dt


def pad_operands(
    xs: Sequence[torch.Tensor],
    ws: Sequence[torch.Tensor],
    *,
    block_t: int,
    block_k: int,
    block_n: int,
):
    """The operands of the fused call: ``(xs_pad, w_pad, owner, valid_t,
    valid_k)``, i.e. every tenant's x zero-padded to the shared (T, K) and
    stacked to (E, T, K), every w zero-padded to (K, whole blocks) and
    concatenated along N, the owner map and the valid extents."""
    x_dt, w_dt = _operand_dtypes(xs, ws)
    T = _round_up(max(x.shape[0] for x in xs), block_t)
    K = _round_up(max(x.shape[1] for x in xs), block_k)
    xs_pad = torch.stack(
        [F.pad(x.to(x_dt), (0, K - x.shape[1], 0, T - x.shape[0])) for x in xs]
    )
    w_cols = []
    for w in ws:
        n_pad = _round_up(w.shape[1], block_n) - w.shape[1]
        w_cols.append(F.pad(w.to(w_dt), (0, n_pad, 0, K - w.shape[0])))
    w_pad = torch.cat(w_cols, dim=1)
    owner = build_owner_map([w.shape[1] for w in ws], block_n)
    valid_t = np.asarray([x.shape[0] for x in xs], np.int64)
    valid_k = np.asarray([x.shape[1] for x in xs], np.int64)
    return xs_pad, w_pad, owner, valid_t, valid_k


# ---------------------------------------------------------------------------
# fused multi-tenant GEMM
# ---------------------------------------------------------------------------


def fused_tenant_gemm(
    xs: Sequence[torch.Tensor],
    ws: Sequence[torch.Tensor],
    *,
    block_t: Optional[int] = None,
    block_k: Optional[int] = None,
    block_n: Optional[int] = None,
    grid_mode: str = "auto",
    return_stats: bool = False,
):
    """Run every tenant's GEMM ``xs[i] @ ws[i]`` in ONE fused kernel call.

    xs[i]: (T_i, K_i);  ws[i]: (K_i, N_i).  Returns [(T_i, N_i) f32, ...]
    — or ``(outs, FusedGemmStats)`` with ``return_stats=True``.  The outputs
    are views into the one fused output.

    Block sizes left as ``None`` are autotuned per geometry (see
    :func:`autotune_blocks`); ``grid_mode`` is ``"dense"``, ``"compact"``
    or ``"auto"`` (compact exactly when the ragged mix leaves dead blocks).
    """
    if len(xs) != len(ws) or not xs:
        raise ValueError("need one (x, w) pair per tenant")
    for i, (x, w) in enumerate(zip(xs, ws)):
        if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
            raise ValueError(
                f"tenant {i}: bad shapes {tuple(x.shape)} @ {tuple(w.shape)}"
            )
    if grid_mode not in ("auto", "dense", "compact"):
        raise ValueError(
            f"grid_mode must be 'auto', 'dense' or 'compact', got {grid_mode!r}"
        )

    shapes = tuple(
        (int(x.shape[0]), int(x.shape[1]), int(w.shape[1])) for x, w in zip(xs, ws)
    )
    x_dt, w_dt = _operand_dtypes(xs, ws)
    x_dtype, w_dtype = _dtype_name(x_dt), _dtype_name(w_dt)
    if block_t is None or block_k is None or block_n is None:
        tuned = autotune_blocks(
            shapes,
            x_dtype,
            w_dtype,
            grid_mode="compact" if grid_mode == "auto" else grid_mode,
        )
        block_t = block_t if block_t is not None else tuned[0]
        block_k = block_k if block_k is not None else tuned[1]
        block_n = block_n if block_n is not None else tuned[2]

    probe = None
    if grid_mode == "auto":
        probe = _geometry_accounting(
            shapes, block_t, block_k, block_n, x_dtype, w_dtype, "dense"
        )
        grid_mode = "compact" if probe.blocks_live < probe.blocks_total else "dense"

    out = partitioned_matmul(
        *pad_operands(xs, ws, block_t=block_t, block_k=block_k, block_n=block_n),
        block_t=block_t,
        block_k=block_k,
        block_n=block_n,
        grid_mode=grid_mode,
    )

    outs = []
    col = 0
    for t, _, n in shapes:
        outs.append(out[:t, col : col + n])
        col += _round_up(n, block_n)
    if not return_stats:
        return outs
    if probe is not None and grid_mode == "dense":
        acc = probe
    else:
        acc = _geometry_accounting(
            shapes, block_t, block_k, block_n, x_dtype, w_dtype, grid_mode
        )
    stats = FusedGemmStats(
        grid_mode=grid_mode,
        block_t=block_t,
        block_k=block_k,
        block_n=block_n,
        accounting=acc,
    )
    return outs, stats


def sequential_tenant_gemm(
    xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor]
) -> list[torch.Tensor]:
    """Single-tenancy baseline: one dense GEMM per tenant, run back-to-back
    (what a non-partitioned accelerator does — the Fig. 9 baseline).  Plain
    ``torch.matmul``, as the JAX package leaves it to XLA."""
    return [x.float() @ w.float() for x, w in zip(xs, ws)]
