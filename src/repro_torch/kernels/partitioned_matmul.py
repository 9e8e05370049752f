"""Multi-tenant partitioned weight-stationary GEMM — the paper's kernel on Hopper.

Counterpart of ``repro.kernels.partitioned_matmul``.  The paper partitions
a systolic array *vertically*: every tenant owns a contiguous range of PE
columns, and a one-gate PE change (``Mul_En``) keeps the multipliers of a
tenant's idle rows and depth from firing.  Here, as in the JAX package:

* PE columns        →  the GEMM **N dimension**;
* vertical slices   →  disjoint contiguous **N-block ranges**, one per tenant
  (the ``owner`` map — the partition table of Algorithm 1);
* ``Mul_En`` gating →  ``grid_mode="dense"`` launches every output tile and
  gates the dead ones (past a tenant's valid rows, or a tenant with no
  depth); ``grid_mode="compact"`` launches only the live tiles, so dead work
  is neither scheduled nor fetched.

All tenants share ONE kernel launch.  The kernels are hand-written CUDA C++
(``csrc/partitioned_matmul.cu``), built at first use by ``_build.py``, and
read a launch table (:class:`LaunchTable`) passed by value: per tenant its
x and live extents, per column segment its tenant, w and output.  Operands
are read in place, so the stacked API (:func:`partitioned_matmul`) and the
per-tenant form (:func:`tenant_matmul`, ``ops.fused_tenant_gemm``'s card
path) run the same kernels.  On CPU tensors
:func:`partitioned_matmul` computes the plain version
(``ref.partitioned_matmul_ref``); on CUDA tensors it launches a kernel or
raises.

The host side (dtype contract, live-block tables, accounting, the launch
table) is NumPy and plain Python, as the JAX package's host side is;
``grid_accounting`` counts in the partition blocks ``(block_t, block_k,
block_n)``, which decide ownership and which blocks are dead.  The kernels
mask rows and depth exactly at the tenant's valid extents, in their own CTA
tiles (``tile_shape``; see the CUDA source): under the zero-padding
contract the result is the same.
"""

from __future__ import annotations

import dataclasses
import functools
import struct
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build, tracing
from repro_torch.kernels.ref import partitioned_matmul_ref
from repro_torch.kernels.tracing import TableCounts

DEFAULT_BLOCK_T = 128
DEFAULT_BLOCK_K = 128
DEFAULT_BLOCK_N = 128

_ALLOWED_DTYPES = (torch.bfloat16, torch.float32)

GRID_MODES = ("dense", "compact")

def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _itemsize(dtype) -> int:
    """Bytes per element of a ``torch.dtype`` or its name (``"float32"``)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype.removeprefix("torch."))
    return dtype.itemsize


def _validate_promote(
    xs: torch.Tensor, w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Enforce the bf16/f32 operand contract; promote mixed pairs to f32."""
    for name, arr in (("xs", xs), ("w", w)):
        if arr.dtype not in _ALLOWED_DTYPES:
            raise TypeError(
                f"{name} dtype {arr.dtype} unsupported: the partitioned-WS "
                "kernel accepts bfloat16 or float32 operands (cast ints / "
                "f16 / f64 on the host first)"
            )
    if xs.dtype != w.dtype:  # bf16 × f32 → promote both to f32
        common = torch.promote_types(xs.dtype, w.dtype)
        xs, w = xs.to(common), w.to(common)
    return xs, w


def _host_ints(a) -> np.ndarray:
    """Partition state as a host int64 array (it is host state by design:
    Algorithm 1 recomputes it per scheduling round)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.int64)


# ---------------------------------------------------------------------------
# live-block enumeration + accounting (host side, concrete partition state)
# ---------------------------------------------------------------------------


def _live_extents(
    owner: np.ndarray,
    valid_t: np.ndarray,
    valid_k: np.ndarray,
    *,
    T: int,
    K: int,
    block_t: int,
    block_k: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Per N-block live extents: (t_blocks_live, k_blocks_live) arrays.

    A block column owned by tenant ``e`` has ``ceil(valid_t[e]/block_t)``
    live T-blocks and ``ceil(valid_k[e]/block_k)`` live K-blocks — live
    blocks always form a contiguous prefix.
    """
    vt = np.clip(valid_t[owner], 0, T)
    vk = np.clip(valid_k[owner], 0, K)
    tl = -(-vt // block_t)
    kl = -(-vk // block_k)
    tl = np.where(kl > 0, tl, 0)  # a zero-depth reduction has no live tiles
    return tl.astype(np.int64), kl.astype(np.int64)


def _tables_from_extents(
    tl: np.ndarray, kl: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    nidx, tidx, kidx, last = [], [], [], []
    for n in range(tl.shape[0]):
        kn = int(kl[n])
        for t in range(int(tl[n])):
            for k in range(kn):
                nidx.append(n)
                tidx.append(t)
                kidx.append(k)
                last.append(1 if k == kn - 1 else 0)
    return (
        np.asarray(nidx, np.int32),
        np.asarray(tidx, np.int32),
        np.asarray(kidx, np.int32),
        np.asarray(last, np.int32),
    )


def live_block_tables(
    owner,
    valid_t,
    valid_k,
    *,
    T: int,
    K: int,
    block_t: int = DEFAULT_BLOCK_T,
    block_k: int = DEFAULT_BLOCK_K,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Flattened live-block index tables ``(nidx, tidx, kidx, last_k)``.

    Entry ``i`` names the ``i``-th live ``(n, t, k)`` block in the order the
    compact schedule walks them; ``last_k[i]`` flags the final step of its
    K-run.  K is innermost and every K-run is contiguous.
    """
    tl, kl = _live_extents(
        _host_ints(owner),
        _host_ints(valid_t),
        _host_ints(valid_k),
        T=T,
        K=K,
        block_t=block_t,
        block_k=block_k,
    )
    return _tables_from_extents(tl, kl)


@dataclasses.dataclass(frozen=True)
class BlockAccounting:
    """Per-call grid/traffic accounting of one ``partitioned_matmul``.

    ``blocks_total`` is the dense iteration space ``n·t·k``;
    ``blocks_scheduled`` is what the chosen grid mode walks (dense: all of
    it; compact: live blocks only); ``blocks_live`` is the MAC-firing
    subset; ``blocks_skipped`` are scheduled-but-gated steps.  Byte counts
    follow a one-fetch-per-scheduled-block model (x and w blocks in, one f32
    out block per drained (n, t) run) — the same model as the JAX package,
    so the two count the same numbers.
    """

    grid_mode: str
    block_t: int
    block_k: int
    block_n: int
    blocks_total: int
    blocks_scheduled: int
    blocks_live: int
    blocks_skipped: int
    x_bytes_fetched: int
    w_bytes_fetched: int
    out_bytes_written: int

    @property
    def bytes_fetched(self) -> int:
        return self.x_bytes_fetched + self.w_bytes_fetched

    @property
    def schedule_efficiency(self) -> float:
        """Live fraction of scheduled steps (1.0 = zero dead work)."""
        if not self.blocks_scheduled:
            return 1.0
        return self.blocks_live / self.blocks_scheduled

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)} | {
            "bytes_fetched": self.bytes_fetched,
            "schedule_efficiency": self.schedule_efficiency,
        }


def grid_accounting(
    *,
    T: int,
    K: int,
    N: int,
    owner,
    valid_t,
    valid_k=None,
    block_t: int = DEFAULT_BLOCK_T,
    block_k: int = DEFAULT_BLOCK_K,
    block_n: int = DEFAULT_BLOCK_N,
    x_dtype=torch.float32,
    w_dtype=torch.float32,
    grid_mode: str = "dense",
) -> BlockAccounting:
    """Predict the grid/traffic accounting of a ``partitioned_matmul`` call.

    Pure host arithmetic over the concrete partition state (the block-size
    autotuner ranks candidates with it).
    """
    if grid_mode not in GRID_MODES:
        raise ValueError(f"grid_mode must be one of {GRID_MODES}, got {grid_mode!r}")
    owner = _host_ints(owner)
    valid_t = _host_ints(valid_t)
    valid_k = (
        np.full(valid_t.shape, K, np.int64) if valid_k is None else _host_ints(valid_k)
    )
    n_blocks = _ceil_div(N, block_n)
    t_blocks = _ceil_div(T, block_t)
    k_blocks = _ceil_div(K, block_k)
    tl, kl = _live_extents(
        owner, valid_t, valid_k, T=T, K=K, block_t=block_t, block_k=block_k
    )
    live = int((tl * kl).sum())
    live_runs = int(tl.sum())  # drained (n, t) tiles
    total = n_blocks * t_blocks * k_blocks
    if grid_mode == "dense":
        scheduled, runs = total, n_blocks * t_blocks
    else:
        scheduled, runs = live, live_runs
    return BlockAccounting(
        grid_mode=grid_mode,
        block_t=block_t,
        block_k=block_k,
        block_n=block_n,
        blocks_total=total,
        blocks_scheduled=scheduled,
        blocks_live=live,
        blocks_skipped=scheduled - live,
        x_bytes_fetched=scheduled * block_t * block_k * _itemsize(x_dtype),
        w_bytes_fetched=scheduled * block_k * block_n * _itemsize(w_dtype),
        out_bytes_written=runs * block_t * block_n * 4,
    )


# ---------------------------------------------------------------------------
# the launch table (host side) and the launch
# ---------------------------------------------------------------------------

# CTA tile geometry and table capacity of csrc/partitioned_matmul.cu;
# ``_layout`` holds them against the built library.  float32: 64 x 64 tiles.
# bfloat16: a segment's tiles are 128 x 128, with NARROW rows where its
# tenant has at most NARROW live rows and NARROW columns where the segment
# has at most NARROW columns (``tile_shape``); a launch whose live tiles, cut
# NARROW x NARROW, are no more than the card's streaming multiprocessors
# takes those throughout: each then has an SM of its own, so no K loop gets
# longer and a deep one is cut across SMs.  Indexed by ``bf16``: the widest
# tile edge and the depth one K-loop step covers (Cfg<T>::BK)
TILE_ROWS = (64, 128)
TILE_COLS = (64, 128)
NARROW = 64
K_SLICES = (16, 64)
ZERO_ROWS = 256
MAX_TENANTS = 64
MAX_SEGMENTS = 256
MAX_MAPS = 24  # the tensor maps one bfloat16 launch holds


def tile_shape(
    rows: int, cols: int, bf16: bool, narrow: bool = False, glu: bool = False
) -> tuple[int, int]:
    """The CTA tile ``(rows, columns)`` of a segment of ``cols`` columns
    whose tenant has ``rows`` live rows, in a launch that takes narrow
    tiles throughout or not (``narrow``).  A gated segment's (``glu``)
    tiles are ``NARROW`` output columns wide: each multiplies ``2 NARROW``
    columns of w, gate and up."""
    if not bf16:
        return TILE_ROWS[0], TILE_COLS[0]
    if narrow:
        return NARROW, NARROW
    return (
        TILE_ROWS[1] if rows > NARROW else NARROW,
        TILE_COLS[1] if cols > NARROW and not glu else NARROW,
    )


class Tenant(NamedTuple):
    """A tenant's x: element ``x_off + r * ldx + k`` of buffer ``x`` is
    ``x[r][k]``.  ``rows``/``depth`` are its live rows and reduction depth,
    ``out_rows`` the rows of the caller's output its columns have."""

    x: int
    x_off: int
    ldx: int
    rows: int
    depth: int
    out_rows: int


class Segment(NamedTuple):
    """A run of ``cols`` columns owned by one tenant: ``w[k][c]`` is element
    ``w_off + k * ldw + c`` of buffer ``w`` and ``out[r][c]`` element
    ``out_off + r * ldo + c`` of buffer ``out`` (f32; bf16 in a table with
    the epilogue).  ``glu`` (the epilogue only): w has ``2 cols`` columns,
    gate then up, and ``out[r][c]`` is ``silu(x[r] . w[:, c]) * (x[r] .
    w[:, cols + c])``."""

    w: int
    w_off: int
    ldw: int
    out: int
    out_off: int
    ldo: int
    cols: int
    tenant: int
    glu: bool = False


@dataclasses.dataclass(frozen=True)
class LaunchTable:
    """One kernel launch, float32 or bfloat16 (``bf16``).  Segment ``i``
    owns tiles ``first[i]`` up to the next segment's first: its CTA tiles
    (``tile_shape``), row tile fastest (dense: the row tiles of
    ``grid_rows * NARROW`` rows per column tile, a dead one zeroed or
    skipped; compact: the live ones), then, compact only, its ``ZERO_ROWS``
    x tile-columns zero-fill tiles for the caller's rows below the live
    ones.  Segments are in launch order, the deepest tenant's first, so the
    longest K loops start first and the zero stores overlap the arithmetic.
    A float32 CTA runs one tile.  The bfloat16 kernel's persistent CTAs
    share the tiles in an order of their own: every segment's live tiles,
    then every segment's zero-writing ones (the dense grid's tiles past the
    caller's rows are never visited), so the live work is shared alike in
    either mode.  ``narrow``: the launch's bfloat16 tiles are all
    ``NARROW`` x ``NARROW``.  ``epilogue``: the compact bfloat16 kernel
    with the epilogue, whose outputs are bfloat16, each value rounded once
    after its segment's gating and the launch's row scale, if any."""

    dense: bool
    bf16: bool
    narrow: bool
    tenants: tuple[Tenant, ...]
    segments: tuple[Segment, ...]
    first: tuple[int, ...]
    grid_rows: int
    grid: int
    epilogue: bool = False

    @functools.cached_property
    def packed(self) -> np.ndarray:
        """The table as the kernel's ``Params`` bytes, buffer addresses left
        0: built once per table, so a launch only writes the addresses."""
        lay = _layout()
        blob = np.zeros(lay["params_bytes"], np.uint8)
        _HEAD.pack_into(blob, 0, len(self.segments), self.grid_rows)
        off = lay["tenants_offset"]
        for t in self.tenants:
            fields = (t.x_off, t.x, t.ldx, t.rows, t.depth, t.out_rows, 0)
            _TENANT.pack_into(blob, off, *fields)
            off += _TENANT.size
        off = lay["segments_offset"]
        for s, first in zip(self.segments, self.first):
            fields = (s.w_off, s.out_off, s.w, s.out, s.ldw, s.ldo, s.cols, s.tenant)
            rows = self.tenants[s.tenant].rows
            bm, bn = tile_shape(rows, s.cols, True, self.narrow, s.glu)
            shape = (bm == TILE_ROWS[1]) | (bn == TILE_COLS[1]) << 1 | s.glu << 2
            _SEGMENT.pack_into(blob, off, *fields, first, shape)
            off += _SEGMENT.size
        return blob

    @functools.cached_property
    def launched(self) -> list[int]:
        """The table's launches since the launch counters last summed them
        (``tracing``)."""
        return [0]

    @functools.cached_property
    def counts(self) -> TableCounts:
        """What one launch of the table does (:class:`TableCounts`), from
        the walk the kernel makes: a tile at or past the tenant's live rows
        writes zeros, unless it is past the caller's rows (dense), where it
        is skipped.  A live tile whose x or w row pitch is not a 16-byte
        multiple counts as staged (``TableCounts``).  A gated segment's
        tiles multiply gate and up columns both: twice their output
        columns, issued and useful."""
        mac = fill = issued = useful = staged = 0
        bk, item = K_SLICES[self.bf16], 2 if self.bf16 else 4
        for s in self.segments:
            t = self.tenants[s.tenant]
            bm, bn = tile_shape(t.rows, s.cols, self.bf16, self.narrow, s.glu)
            col_tiles = _ceil_div(s.cols, bn)
            live = _ceil_div(t.rows, bm)
            if self.dense:
                dead = _ceil_div(t.out_rows, bm) - live
            else:
                dead = max(0, _ceil_div(t.out_rows - live * bm, ZERO_ROWS))
            w_cols = 2 if s.glu else 1
            macs = col_tiles * live * bm * bn * _ceil_div(t.depth, bk) * bk * w_cols
            mac += col_tiles * live
            fill += col_tiles * dead
            issued += macs
            useful += t.rows * t.depth * s.cols * w_cols
            if (t.ldx * item) % 16 or (s.ldw * item) % 16:
                staged += macs
        return TableCounts(
            int(self.dense), self.grid, mac, fill, issued, useful, staged
        )


def launch_table(
    tenants, segments, *, dense: bool, bf16: bool, sms: int = 0,
    epilogue: bool = False,
) -> LaunchTable:
    """Schedule ``segments`` (each naming a tenant of ``tenants``) as one
    launch of the dense or the compact kernel in float32 or bfloat16, on a
    card of ``sms`` streaming multiprocessors (0: none is assumed, so a
    bfloat16 launch never takes narrow tiles throughout); ``epilogue``: the
    compact bfloat16 kernel with the epilogue, the only one that takes
    gated segments.  A tenant with no depth has no live rows.  Raises
    ``ValueError`` past the table's capacity."""
    gated = any(s.glu for s in segments)
    if (gated and not epilogue) or (epilogue and (dense or not bf16)):
        raise ValueError(
            "the epilogue (gated segments, bfloat16 outputs) runs in compact "
            "bfloat16 launches only"
        )
    if len(tenants) > MAX_TENANTS:
        raise ValueError(
            f"{len(tenants)} tenants exceed the launch table's capacity "
            f"(MAX_TENANTS = {MAX_TENANTS})"
        )
    if len(segments) > MAX_SEGMENTS:
        raise ValueError(
            f"{len(segments)} column segments exceed the launch table's "
            f"capacity (MAX_SEGMENTS = {MAX_SEGMENTS})"
        )
    tenants = tuple(
        t._replace(rows=min(max(t.rows, 0), t.out_rows) if t.depth > 0 else 0)
        for t in tenants
    )
    segments = tuple(sorted(segments, key=lambda s: -tenants[s.tenant].depth))
    narrow_tiles = sum(
        _ceil_div(s.cols, NARROW) * _ceil_div(tenants[s.tenant].rows, NARROW)
        for s in segments
    )
    narrow = bf16 and sms > 0 and narrow_tiles <= sms
    grid_rows = 0
    if dense and segments:
        out_rows = [tenants[s.tenant].out_rows for s in segments]
        grid_rows = _ceil_div(max(out_rows), NARROW)
    first, grid = [], 0
    for s in segments:
        t = tenants[s.tenant]
        bm, bn = tile_shape(t.rows, s.cols, bf16, narrow, s.glu)
        col_tiles = _ceil_div(s.cols, bn)
        live = _ceil_div(t.rows, bm)
        first.append(grid)
        grid += col_tiles * (_ceil_div(grid_rows * NARROW, bm) if dense else live)
        if not dense:
            dead = t.out_rows - live * bm
            grid += col_tiles * max(0, _ceil_div(dead, ZERO_ROWS))
    return LaunchTable(
        dense, bf16, narrow, tenants, segments, tuple(first), grid_rows, grid,
        epilogue,
    )


@functools.lru_cache(maxsize=256)
def stacked_table(
    xs_shape, N, owner, valid_t, valid_k, block_n, dense, bf16=True, sms=0
):
    """The table of ``partitioned_matmul``'s stacked operands (all arguments
    ints, bools or tuples of ints; cached per geometry, dtype and card's
    streaming multiprocessors, as :func:`launch_table` takes them): buffer 0
    is ``xs`` (E, T, K), 1 is ``w`` (K, N), 2 the (T, N) output.  Adjacent
    column blocks of one owner form one segment."""
    tracing.count_table_build()
    E, T, K = xs_shape
    tenants = [
        Tenant(0, e * T * K, K, min(max(vt, 0), T), min(max(vk, 0), K), T)
        for e, (vt, vk) in enumerate(zip(valid_t, valid_k))
    ]
    segments, start = [], 0
    for j in range(1, len(owner) + 1):
        if j == len(owner) or owner[j] != owner[start]:
            c0 = start * block_n
            cols = (j - start) * block_n
            segments.append(Segment(1, c0, N, 2, c0, N, cols, owner[start]))
            start = j
    return launch_table(tenants, segments, dense=dense, bf16=bf16, sms=sms)


@functools.lru_cache(maxsize=256)
def tenant_table(shapes, ldx, ldw, dense, bf16=True, sms=0):
    """The table of the per-tenant form (cached per geometry, dtype and
    card's streaming multiprocessors, as :func:`launch_table` takes them): for
    E tenants of ``(T_i, K_i, N_i)`` shapes, buffer ``i`` is
    x_i (row stride ``ldx[i]``), ``E + i`` is w_i (row stride ``ldw[i]``)
    and ``2 E + i`` the contiguous ``(T_i, N_i)`` output.  Only the tenants'
    own rows are scheduled."""
    tracing.count_table_build()
    E = len(shapes)
    tenants = [Tenant(i, 0, ldx[i], t, k, t) for i, (t, k, _) in enumerate(shapes)]
    segments = [
        Segment(E + i, 0, ldw[i], 2 * E + i, 0, n, n, i)
        for i, (t, _, n) in enumerate(shapes)
        if t > 0 and n > 0
    ]
    return launch_table(tenants, segments, dense=dense, bf16=bf16, sms=sms)


def _dense_fits(shapes) -> bool:
    """Whether an ``"auto"`` call of the per-tenant form takes the dense
    kernel: exactly when every tenant of the ``(T_i, K_i, N_i)`` shapes has
    the same rows and depth, so the dense grid has no dead tile to gate."""
    return len({(t, k) for t, k, _ in shapes}) == 1


@functools.lru_cache(maxsize=256)
def epilogue_table(shapes, ldx, ldw, ldo, glu, sms=0):
    """The table of the per-tenant form with the epilogue (cached as
    :func:`tenant_table`): for E tenants of ``(T_i, K_i, N_i)`` shapes,
    buffer ``i`` is x_i (row stride ``ldx[i]``), ``E + i`` is w_i (row
    stride ``ldw[i]``) and ``2 E`` the one bfloat16 output, row stride
    ``ldo``, tenant i's rows following tenant i - 1's.  Its columns are
    ``N_i``, or ``N_i / 2`` where ``glu`` (every segment gated)."""
    tracing.count_table_build()
    E = len(shapes)
    tenants = [Tenant(i, 0, ldx[i], t, k, t) for i, (t, k, _) in enumerate(shapes)]
    segments, row = [], 0
    for i, (t, _, n) in enumerate(shapes):
        cols = n // 2 if glu else n
        if t > 0 and cols > 0:
            segments.append(Segment(E + i, 0, ldw[i], 2 * E, row * ldo, ldo, cols, i,
                                    glu))
        row += t
    return launch_table(tenants, segments, dense=False, bf16=True, sms=sms,
                        epilogue=True)


@functools.cache
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


_HEAD = struct.Struct("<2i")
_TENANT = struct.Struct("<q6i")
_SEGMENT = struct.Struct("<2q8i")


@functools.cache
def _addresses(n: int) -> struct.Struct:
    return struct.Struct(f"<{n}q")


@functools.cache
def _layout() -> dict[str, int]:
    """The built library's table layout, held against this module's."""
    lay = _build.layout()
    want = {
        "buffers_offset": _HEAD.size,
        "tenant_bytes": _TENANT.size,
        "segment_bytes": _SEGMENT.size,
        "max_buffers": 3 * MAX_TENANTS,
        "max_tenants": MAX_TENANTS,
        "max_segments": MAX_SEGMENTS,
        "tile_rows_float32": TILE_ROWS[0],
        "tile_cols_float32": TILE_COLS[0],
        "tile_rows_bfloat16": TILE_ROWS[1],
        "tile_cols_bfloat16": TILE_COLS[1],
        "tile_narrow": NARROW,
        "zero_rows": ZERO_ROWS,
        "k_slice_float32": K_SLICES[0],
        "k_slice_bfloat16": K_SLICES[1],
        "max_maps": MAX_MAPS,
    }
    bad = {k: (lay[k], v) for k, v in want.items() if lay[k] != v}
    if bad:
        raise RuntimeError(f"launch table layout differs from the library: {bad}")
    return lay


def _pack(table: LaunchTable, bufs) -> np.ndarray:
    """The table as the kernel's ``Params`` bytes, with the buffers'
    device addresses."""
    blob = table.packed.copy()
    _addresses(len(bufs)).pack_into(
        blob, _HEAD.size, *[b.data_ptr() for b in bufs]
    )
    return blob


def operand_feeds(table: LaunchTable, bufs) -> list[tuple[str, int, int, str]]:
    """How a bfloat16 launch of ``table`` over the tensors ``bufs`` feeds
    its live operands, as the launcher decides (``encode_maps`` in the CUDA
    source, which counts the same in ``launch_stats()["feed"]``), its
    driver's encoder taken to accept every map: ``(kind, index, map,
    feed)`` for the x of each live tenant (``"x"``, its tenant) and the w
    of each live segment (``"w"``, its segment), in launch order: the
    launch's map it reads (-1: none) and its feed, one of
    ``tracing.FEEDS``.

    An operand whose origin or row pitch is off 16 bytes is staged.  The
    others take tensor maps in order of first appearance, until
    ``MAX_MAPS`` are used, the rest staged: one map for every operand of one
    storage, row pitch, live width (x: its depth; w: its columns, gate and
    up), box and column offset in a row (so that their origins lie whole
    rows apart); a w of a depth that is not a whole number of K slices
    takes a map of its own."""
    spans = []  # (kind, index, buffer, element offset, live width, ld, box, alone)
    seen = set()
    for i, s in enumerate(table.segments):
        t = table.tenants[s.tenant]
        if t.rows <= 0:
            continue
        if s.tenant not in seen:
            seen.add(s.tenant)
            spans.append(("x", s.tenant, t.x, t.x_off, t.depth, t.ldx, TILE_ROWS[1],
                          False))
        cols = 2 * s.cols if s.glu else s.cols
        spans.append(("w", i, s.w, s.w_off, cols, s.ldw, NARROW,
                      t.depth % K_SLICES[1] != 0))
    members: dict = {}  # the groups' operands, in order of first appearance
    placed = []
    for kind, index, buf, off, cols, ld, box, alone in spans:
        g = bufs[buf].data_ptr() + 2 * off
        store = bufs[buf].untyped_storage().data_ptr()
        key = None
        if not (g % 16 or (2 * ld) % 16):
            key = (len(placed),) if alone else (store, ld, cols, box, (g - store) % (2 * ld))
            members[key] = members.get(key, 0) + 1
        placed.append((kind, index, key))
    slots = {key: i for i, key in enumerate(list(members)[:MAX_MAPS])}
    feeds = []
    for kind, index, key in placed:
        slot = slots.get(key, -1)
        feed = "staged" if slot < 0 else "shared_map" if members[key] > 1 else "own_map"
        feeds.append((kind, index, slot, feed))
    return feeds


# the current stream's handle without building a Stream object (the binding
# PyTorch's own generated code uses); absent from CPU-only builds
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _launch(
    table: LaunchTable, bufs, device: torch.device, clock, scale: int = 0
) -> None:
    """Launch ``table`` on ``device``'s current stream (no launch when it
    schedules no tile) and count it; ``clock`` (armed calls only) marks the
    end of the table phase and of the launch phase; ``scale``: the address
    of the epilogue's row scale (0: none).  The library checks the
    kernels' shared memory against the device's limit at its first launch
    there, and an error it returns raises."""
    if table.grid == 0:
        if clock is not None:
            clock.finish()
        return
    blob = _pack(table, bufs)
    # where each buffer's storage starts: the launcher lets operands of one
    # storage share a tensor map
    stores = (
        _addresses(len(bufs)).pack(*[b.untyped_storage().data_ptr() for b in bufs])
        if table.bf16
        else None
    )
    if clock is not None:
        clock.mark()
    if _raw_stream is not None:
        stream = _raw_stream(device.index)
    else:
        stream = torch.cuda.current_stream(device).cuda_stream
    lib = _build.load()
    if table.epilogue:
        fn = lib.pm_launch_epilogue
        args = (blob.ctypes.data, table.grid, scale, stream, stores)
    else:
        fn = lib.pm_launch
        args = (int(table.dense), int(table.bf16), blob.ctypes.data, table.grid,
                stream, stores)
    if device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err:
        name = "dense" if table.dense else "compact"
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launched = table.launched
    launched[0] += 1
    if launched[0] == 1:
        tracing.watch(table.counts, launched, 0)
    if clock is not None:
        clock.mark()


def tenant_matmul(xs, ws, shapes, dense: bool) -> list[torch.Tensor]:
    """The per-tenant form on the card (``fused_tenant_gemm``'s card path):
    ``xs[i] @ ws[i]`` as a contiguous ``(T_i, N_i)`` f32 tensor for every
    tenant, all in one launch, each operand read in place (its row stride
    taken as it is; a tensor whose rows are not unit-stride is made
    contiguous first).  ``shapes`` are the ``(T_i, K_i, N_i)``; the operands
    are CUDA tensors on one device, all of one dtype (the caller's check),
    bfloat16 or float32."""
    clock = tracing.Clock() if tracing.armed else None
    return _tenant_matmul(xs, ws, shapes, dense, clock)


def _in_place(xs, ws) -> tuple[list[torch.Tensor], list[int]]:
    """The operands as the kernels read them, each on the device of
    ``xs[0]`` with unit-stride rows (made contiguous where not), and their
    row strides."""
    index = xs[0].device.index
    operands, lds = [], []
    for a in (*xs, *ws):
        if a.get_device() != index:
            raise ValueError(f"every operand must be on {xs[0].device}, got {a.device}")
        stride = a.stride()
        if stride[-1] != 1:
            a = a.contiguous()
            stride = a.stride()
        operands.append(a)
        lds.append(stride[0])
    return operands, lds


def _tenant_matmul(xs, ws, shapes, dense, clock) -> list[torch.Tensor]:
    """:func:`tenant_matmul`, in the phases of ``clock`` where armed."""
    device, dtype = xs[0].device, xs[0].dtype
    if dtype not in _ALLOWED_DTYPES:
        raise TypeError(f"operand dtype {dtype} unsupported: bfloat16 or float32")
    index = device.index
    operands, lds = _in_place(xs, ws)
    E = len(xs)
    if clock is not None:
        clock.mark()
    outs = [
        torch.empty((t, n), dtype=torch.float32, device=device) for t, _, n in shapes
    ]
    if clock is not None:
        clock.mark()
    bf16 = dtype == torch.bfloat16
    sms = sm_count(index)
    table = tenant_table(shapes, tuple(lds[:E]), tuple(lds[E:]), dense, bf16, sms)
    _launch(table, (*operands, *outs), device, clock)
    return outs


def _tenant_matmul_into(xs, ws, shapes, out, glu, scale, clock) -> list[torch.Tensor]:
    """The per-tenant form with the epilogue on the card: every tenant's
    ``xs[i] @ ws[i]``, gated where ``glu`` and times ``scale`` (a float32
    per row of ``out``, or None) rounded once into its rows of ``out``
    (bfloat16, unit-stride rows, tenant i's rows after tenant i - 1's), in
    one launch of the compact kernel; returns those rows as views of
    ``out``.  The operands are bfloat16 CUDA tensors on ``out``'s device
    (the caller's check).  Nothing is allocated: the alloc phase is
    empty."""
    operands, lds = _in_place(xs, ws)
    E = len(xs)
    if clock is not None:
        clock.mark()
        clock.mark()
    sms = sm_count(xs[0].device.index)
    table = epilogue_table(
        shapes, tuple(lds[:E]), tuple(lds[E:]), out.stride(0), glu, sms
    )
    addr = 0 if scale is None else scale.data_ptr()
    _launch(table, (*operands, out), xs[0].device, clock, addr)
    return list(out.split([t for t, _, _ in shapes]))


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------


def partitioned_matmul(
    xs: torch.Tensor,
    w: torch.Tensor,
    owner,
    valid_t,
    valid_k=None,
    *,
    block_t: int = DEFAULT_BLOCK_T,
    block_k: int = DEFAULT_BLOCK_K,
    block_n: int = DEFAULT_BLOCK_N,
    grid_mode: str = "dense",
) -> torch.Tensor:
    """Fused multi-tenant GEMM.  See ``ref.partitioned_matmul_ref``.

    xs:      (E, T, K) — per-tenant activations, zero-padded to shared T/K.
    w:       (K, N)    — tenant weights concatenated along N.
    owner:   (N // block_n,) ints — column-block → tenant (partition map).
    valid_t: (E,) ints — valid streamed rows per tenant.
    valid_k: (E,) ints — valid reduction depth per tenant (default: K).
    Returns  (T, N) f32 on xs's device.

    The partition state (``owner``/``valid_t``/``valid_k``: tensors, arrays
    or lists) is read on the host.  The JAX version must reject traced
    partition state in compact mode; eager PyTorch has no tracers, so that
    check has no counterpart here.

    On CPU tensors the result is the plain version; on CUDA tensors
    ``grid_mode="dense"`` launches every output tile and gates the dead ones,
    ``"compact"`` launches only the live tiles (and zero-fill tiles for the
    dead rows, in the same launch) — identical results.
    Operands must be bfloat16 or float32 (mixed pairs promote to float32).
    """
    clock = tracing.Clock() if tracing.armed and xs.device.type == "cuda" else None
    xs, w = _validate_promote(xs, w)
    E, T, K = xs.shape
    K2, N = w.shape
    if K2 != K:
        raise ValueError(f"K mismatch: xs {K} vs w {K2}")
    for name, dim, blk in (("T", T, block_t), ("K", K, block_k), ("N", N, block_n)):
        if dim % blk:
            raise ValueError(
                f"{name}={dim} not divisible by block {blk}; "
                "pad in ops.fused_tenant_gemm"
            )
    n_blocks = N // block_n
    owner = _host_ints(owner)
    if owner.shape != (n_blocks,):
        raise ValueError(f"owner must be ({n_blocks},), got {owner.shape}")
    own = tuple(owner.tolist())
    if own and (min(own) < 0 or max(own) >= E):
        raise ValueError(f"owner entries must lie in [0, {E})")
    valid_t = _host_ints(valid_t)
    valid_k = np.full((E,), K, np.int64) if valid_k is None else _host_ints(valid_k)
    if valid_t.shape != (E,) or valid_k.shape != (E,):
        raise ValueError(
            f"valid_t and valid_k must be ({E},), got {valid_t.shape} and "
            f"{valid_k.shape}"
        )
    if grid_mode not in GRID_MODES:
        raise ValueError(f"grid_mode must be one of {GRID_MODES}, got {grid_mode!r}")
    if xs.device.type == "cpu":
        return partitioned_matmul_ref(
            xs, w, torch.from_numpy(owner), torch.from_numpy(valid_t), block_n
        )
    if xs.device.type != "cuda":
        raise ValueError(f"no kernel for device {xs.device}")
    if w.device != xs.device:
        raise ValueError(f"xs is on {xs.device} but w is on {w.device}")
    if not (xs.is_contiguous() and w.is_contiguous()):
        raise ValueError("the CUDA kernels need contiguous xs and w")
    if clock is not None:
        clock.mark()
    out = torch.empty((T, N), dtype=torch.float32, device=xs.device)
    if clock is not None:
        clock.mark()
    table = stacked_table(
        (E, T, K),
        N,
        own,
        tuple(valid_t.tolist()),
        tuple(valid_k.tolist()),
        block_n,
        grid_mode == "dense",
        xs.dtype == torch.bfloat16,
        sm_count(xs.device.index),
    )
    _launch(table, (xs, w, out), xs.device, clock)
    return out

