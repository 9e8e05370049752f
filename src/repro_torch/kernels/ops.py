"""Host-facing wrappers around the partitioned-GEMM kernels.

Counterpart of ``repro.kernels.ops``.  ``fused_tenant_gemm`` takes one
(x, w) GEMM per tenant — arbitrary ragged shapes — and makes ONE fused
kernel call.  On the card the kernels read every tenant's own tensors in
place and write each tenant's own output (``tenant_matmul``); on the CPU the
plain version runs on the JAX package's geometry: every operand
zero-padded to a shared shape, a column-block ``owner`` map (each tenant's
columns a contiguous run of blocks: the paper's vertical slices), the
outputs split back out.  The zero padding is what makes that ragged fusion
exact (see ``ref.py``).

On top of the raw kernel this layer picks the grid mode, ``"auto"``: the
card takes the dense launch exactly when every tenant has the same rows
and depth, so the dense grid has no dead tile (``_dense_fits``), and the
compact live-tile launch otherwise; the CPU makes the JAX package's
choice, the compact launch whenever the ragged mix leaves a dead partition
block.  The partition block sizes, when not pinned, are tuned only where
they decide something (the CPU geometry, the stats), ranked by predicted
fetched bytes per useful MAC.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import tracing
from repro_torch.kernels.partitioned_matmul import (
    BlockAccounting,
    _dense_fits,
    _tenant_matmul,
    _tenant_matmul_into,
    grid_accounting,
    partitioned_matmul,
)

# candidate partition-block edge lengths the autotuner searches per dimension
BLOCK_CANDIDATES = (128, 256, 512)
EPILOGUES = (None, "swiglu")


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


@functools.lru_cache(maxsize=1024)
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
    x_dts, w_dts = {x.dtype for x in xs}, {w.dtype for w in ws}
    if len(x_dts) == 1 and x_dts == w_dts:  # the common case, without promotion
        (dt,) = x_dts
        return dt, dt
    x_dt = functools.reduce(torch.promote_types, x_dts)
    w_dt = functools.reduce(torch.promote_types, w_dts)
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
    epilogue: Optional[str] = None,
    row_scale: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
):
    """Run every tenant's GEMM ``xs[i] @ ws[i]`` in ONE fused kernel call.

    xs[i]: (T_i, K_i);  ws[i]: (K_i, N_i).  Returns [(T_i, N_i) f32, ...]
    — or ``(outs, FusedGemmStats)`` with ``return_stats=True``.  On CUDA
    tensors each output is its own contiguous tensor, written by the one
    launch; nothing is padded and no shared (T, N) buffer exists.  On CPU
    tensors the outputs are views into the plain version's padded output.
    The stats count the partition-block model of the JAX package either way.

    ``grid_mode`` is ``"dense"``, ``"compact"`` or ``"auto"``: on the card,
    dense exactly when every tenant has the same (T_i, K_i); on the CPU,
    compact exactly when the ragged mix leaves dead partition blocks.  Block
    sizes left as ``None`` are autotuned per geometry (see
    :func:`autotune_blocks`) where they are used: always on the CPU, on the
    card only for the stats, since the CUDA kernels tile by their own CTA
    shape.

    The epilogue (bfloat16 operands and a compact launch only): with
    ``out``, ONE bfloat16 buffer of (sum T_i, N'), the outputs are its
    rows, tenant i's after tenant i - 1's, returned as views of it; each
    value is worked out in f32 and rounded once.  ``epilogue="swiglu"``:
    every w_i is (K_i, 2 N'), gate then up, and the output is
    ``silu(x w[:, :N']) * (x w[:, N':])``; else N' = N_i.  ``row_scale``: a
    float32 (sum T_i,) tensor, row j of the buffer multiplied by
    ``row_scale[j]``.  The CPU computes the same from the plain version's
    f32 outputs.

    With tracing armed (``tracing.set_tracing``), a card call times its
    four host phases and, under a profiler, marks them as spans.
    """
    on_card = bool(xs) and xs[0].device.type == "cuda"
    clock = tracing.Clock() if tracing.armed and on_card else None
    if len(xs) != len(ws) or not xs:
        raise ValueError("need one (x, w) pair per tenant")
    for i, (xsh, wsh) in enumerate(zip([x.shape for x in xs], [w.shape for w in ws])):
        if len(xsh) != 2 or len(wsh) != 2 or xsh[1] != wsh[0]:
            raise ValueError(f"tenant {i}: bad shapes {tuple(xsh)} @ {tuple(wsh)}")
    if grid_mode not in ("auto", "dense", "compact"):
        raise ValueError(
            f"grid_mode must be 'auto', 'dense' or 'compact', got {grid_mode!r}"
        )
    shapes = tuple((x.shape[0], x.shape[1], w.shape[1]) for x, w in zip(xs, ws))
    x_dt, w_dt = _operand_dtypes(xs, ws)
    x_dtype, w_dtype = _dtype_name(x_dt), _dtype_name(w_dt)
    finish = epilogue is not None or row_scale is not None or out is not None
    if finish:
        _check_epilogue(xs, shapes, x_dt, grid_mode, epilogue, row_scale, out)
        grid_mode = "compact"
    if (not on_card or return_stats) and None in (block_t, block_k, block_n):
        tuned = autotune_blocks(
            shapes,
            x_dtype,
            w_dtype,
            grid_mode="compact" if grid_mode == "auto" else grid_mode,
        )
        block_t = block_t if block_t is not None else tuned[0]
        block_k = block_k if block_k is not None else tuned[1]
        block_n = block_n if block_n is not None else tuned[2]

    if on_card:
        if grid_mode == "auto":
            grid_mode = "dense" if _dense_fits(shapes) else "compact"
        if finish:
            outs = _tenant_matmul_into(
                xs, ws, shapes, out, epilogue == "swiglu", row_scale, clock
            )
        else:
            outs = _tenant_matmul(
                [x if x.dtype == x_dt else x.to(x_dt) for x in xs],
                [w if w.dtype == w_dt else w.to(w_dt) for w in ws],
                shapes,
                grid_mode == "dense",
                clock,
            )
    else:
        if grid_mode == "auto":
            probe = _geometry_accounting(
                shapes, block_t, block_k, block_n, x_dtype, w_dtype, "dense"
            )
            grid_mode = "compact" if probe.blocks_live < probe.blocks_total else "dense"
        plain = partitioned_matmul(
            *pad_operands(xs, ws, block_t=block_t, block_k=block_k, block_n=block_n),
            block_t=block_t,
            block_k=block_k,
            block_n=block_n,
            grid_mode=grid_mode,
        )
        outs, col = [], 0
        for t, _, n in shapes:
            outs.append(plain[:t, col : col + n])
            col += _round_up(n, block_n)
        if finish:
            outs = _finish_plain(outs, epilogue, row_scale, out)

    if not return_stats:
        return outs
    acc = _geometry_accounting(
        shapes, block_t, block_k, block_n, x_dtype, w_dtype, grid_mode
    )
    return outs, FusedGemmStats(grid_mode, block_t, block_k, block_n, acc)


def _check_epilogue(xs, shapes, dtype, grid_mode, epilogue, row_scale, out) -> None:
    """The epilogue's arguments checked against the call."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    if dtype != torch.bfloat16:
        raise TypeError(f"the epilogue runs on bfloat16 operands only, not {dtype}")
    if grid_mode == "dense":
        raise ValueError("the epilogue runs in compact launches only")
    widths = {n for _, _, n in shapes}
    if len(widths) != 1:
        raise ValueError(f"one output buffer needs one output width, got {widths}")
    (n,) = widths
    if epilogue == "swiglu":
        if n % 2:
            raise ValueError(f"swiglu needs w of gate and up halves, got {n} columns")
        n //= 2
    rows = sum(t for t, _, _ in shapes)
    device = xs[0].device
    if out is None:
        raise ValueError("the epilogue writes into a buffer: pass out")
    if out.shape != (rows, n) or out.dtype != torch.bfloat16:
        raise ValueError(
            f"out must be ({rows}, {n}) bfloat16, got {tuple(out.shape)} {out.dtype}"
        )
    if out.device != device or (rows and n and out.stride(1) != 1):
        raise ValueError(f"out must be on {device} with unit-stride rows")
    if row_scale is not None:
        if row_scale.shape != (rows,) or row_scale.dtype != torch.float32:
            raise ValueError(f"row_scale must be ({rows},) float32")
        if row_scale.device != device or (rows and row_scale.stride(0) != 1):
            raise ValueError(f"row_scale must be contiguous on {device}")


def _finish_plain(outs, epilogue, row_scale, out) -> list[torch.Tensor]:
    """The epilogue on the plain version's f32 outputs: gated and scaled in
    f32, rounded once into the rows of ``out``; returns the rows as views
    of it."""
    n = out.shape[1]
    views = list(out.split([o.shape[0] for o in outs]))
    row = 0
    for o, v in zip(outs, views):
        if epilogue == "swiglu":
            o = F.silu(o[:, :n]) * o[:, n:]
        if row_scale is not None:
            o = o * row_scale[row : row + o.shape[0], None]
        v.copy_(o)
        row += o.shape[0]
    return views


def sequential_tenant_gemm(
    xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor]
) -> list[torch.Tensor]:
    """Single-tenancy baseline: one dense GEMM per tenant, run back-to-back
    (what a non-partitioned accelerator does — the Fig. 9 baseline).  Plain
    ``torch.matmul``, as the JAX package leaves it to XLA."""
    return [x.float() @ w.float() for x, w in zip(xs, ws)]
