"""The port's partitioned GEMM (``repro_torch.kernels``) against the JAX
package's, on the same NumPy inputs.

On the CPU the port's wrapper computes the kernels' plain version; the JAX
side runs its Pallas kernels in interpret mode, as ``tests/test_kernels.py``
does.  The CUDA kernels themselves run only on a card (``chip_smoke.py``
holds them against the plain version there).
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels import fused_tenant_gemm as jax_fused
from repro.kernels import grid_accounting as jax_grid_accounting
from repro.kernels import live_block_tables as jax_live_block_tables
from repro.kernels import partitioned_matmul as jax_pm
from repro.kernels import partitioned_matmul_ref as jax_ref
from repro.kernels.ops import record_gemm_stats as jax_record
from repro.kernels.ops import sequential_tenant_gemm as jax_sequential
from repro.sim import workloads as jax_workloads
from repro_torch.kernels import (
    autotune_blocks,
    build_owner_map,
    fused_tenant_gemm,
    grid_accounting,
    live_block_tables,
    partitioned_matmul,
    partitioned_matmul_ref,
    record_gemm_stats,
    sequential_tenant_gemm,
    stacked_table,
    tenant_table,
)
from repro_torch.kernels.ops import _geometry_accounting
from repro_torch.kernels.partitioned_matmul import (
    MAX_SEGMENTS,
    MAX_TENANTS,
    NARROW,
    ZERO_ROWS,
    tile_shape,
)
from repro_torch.sim import workloads

# tests/test_kernels.py's TOL: f32 sums reorder (rtol 1e-4 at K=1024); bf16
# operands carry 8 mantissa bits, so the JAX side's bf16 MXU path may round
# where the f32 plain version does not
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype`` (both
    round f32 to bf16 to nearest even, so they hold the same bits)."""
    return (
        jnp.asarray(a).astype(getattr(jnp, dtype)),
        torch.from_numpy(a).to(getattr(torch, dtype)),
    )


def _mk(seed, E, T, K, N, n_blocks, valid_t=None):
    """tests/test_kernels.py's ``_mk`` in NumPy: rows past valid_t zeroed."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((E, T, K), dtype=np.float32)
    valid_t = np.full(E, T) if valid_t is None else np.asarray(valid_t)
    xs[np.arange(T)[None, :] >= valid_t[:, None]] = 0.0
    w = rng.standard_normal((K, N), dtype=np.float32)
    owner = rng.integers(0, E, n_blocks).astype(np.int32)
    return xs, w, owner, valid_t.astype(np.int32)


def _mk_int(seed, E, T, K, N, n_blocks, valid_t, valid_k):
    """Integer-valued operands honouring the zero-padding contract: every
    product and partial sum is exact in f32, so results agree bit for bit
    whatever the accumulation order."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(-4, 5, (E, T, K)).astype(np.float32)
    for e in range(E):
        xs[e, valid_t[e] :, :] = 0.0
        xs[e, :, valid_k[e] :] = 0.0
    w = rng.integers(-4, 5, (K, N)).astype(np.float32)
    owner = rng.integers(0, E, n_blocks).astype(np.int32)
    return xs, w, owner, np.asarray(valid_t, np.int32), np.asarray(valid_k, np.int32)


class TestPartitionedMatmul:
    @pytest.mark.parametrize("grid_mode", ["dense", "compact"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize(
        "shape",
        [
            (1, 128, 128, 128),  # single tenant, single block
            (2, 128, 256, 512),  # multi-block N
            (3, 256, 128, 384),  # 3 tenants
            (4, 128, 384, 1024),  # K folds
        ],
    )
    def test_matches_jax_kernel_and_oracle(self, shape, dtype, grid_mode):
        E, T, K, N = shape
        xs, w, owner, valid_t = _mk(0, E, T, K, N, N // 128)
        jxs, txs = _both(xs, dtype)
        jw, tw = _both(w, dtype)
        out = partitioned_matmul(txs, tw, owner, valid_t, grid_mode=grid_mode)
        assert out.dtype == torch.float32 and out.shape == (T, N)
        jax_out = jax_pm(
            jxs,
            jw,
            jnp.asarray(owner),
            jnp.asarray(valid_t),
            grid_mode=grid_mode,
            interpret=True,
        )
        ref = jax_ref(jxs, jw, jnp.asarray(owner), jnp.asarray(valid_t), 128)
        np.testing.assert_allclose(out.numpy(), np.asarray(jax_out), **TOL[dtype])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL[dtype])

    @pytest.mark.parametrize("seed", range(4))
    def test_integer_operands_bit_exact(self, seed):
        rng = np.random.default_rng(100 + seed)
        E, tb, kb, nb = (int(v) for v in rng.integers(1, 4, 4))
        B = 64
        T, K, N = tb * B, kb * B, nb * B
        vt = rng.integers(0, T + 1, E)
        vk = rng.integers(0, K + 1, E)
        xs, w, owner, vt, vk = _mk_int(seed, E, T, K, N, nb, vt, vk)
        kw = dict(block_t=B, block_k=B, block_n=B)
        tx, tw = torch.from_numpy(xs), torch.from_numpy(w)
        dense = partitioned_matmul(tx, tw, owner, vt, vk, grid_mode="dense", **kw)
        compact = partitioned_matmul(tx, tw, owner, vt, vk, grid_mode="compact", **kw)
        jargs = [jnp.asarray(a) for a in (xs, w, owner, vt, vk)]
        for mode in ("dense", "compact"):
            jax_out = jax_pm(*jargs, grid_mode=mode, interpret=True, **kw)
            np.testing.assert_array_equal(dense.numpy(), np.asarray(jax_out))
        np.testing.assert_array_equal(compact.numpy(), dense.numpy())

    def test_ragged_valid_t_masks_rows(self):
        xs, w, _, valid_t = _mk(1, 2, 256, 128, 256, 2, valid_t=[100, 256])
        out = partitioned_matmul(
            torch.from_numpy(xs), torch.from_numpy(w), [0, 1], valid_t
        )
        np.testing.assert_array_equal(out[128:, :128].numpy(), 0.0)
        assert out[200:, 128:].abs().sum() > 0

    def test_zero_live_blocks_returns_zeros(self):
        out = partitioned_matmul(
            torch.ones((1, 128, 128)),
            torch.ones((128, 128)),
            [0],
            [0],
            grid_mode="compact",
        )
        np.testing.assert_array_equal(out.numpy(), 0.0)

    def test_plain_versions_match_jax(self):
        xs, w, owner, valid_t = _mk(2, 3, 128, 64, 192, 3, valid_t=[5, 128, 70])
        out = partitioned_matmul_ref(
            torch.from_numpy(xs),
            torch.from_numpy(w),
            torch.from_numpy(owner),
            torch.from_numpy(valid_t),
            64,
        )
        ref = jax_ref(*(jnp.asarray(a) for a in (xs, w, owner, valid_t)), 64)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL["float32"])


class TestHostTables:
    @staticmethod
    def _layout(seed):
        rng = np.random.default_rng(seed)
        E = int(rng.integers(1, 5))
        T, K = int(rng.integers(1, 5)) * 128, int(rng.integers(1, 5)) * 128
        owner = rng.integers(0, E, int(rng.integers(1, 7)))
        vt = rng.integers(0, T + 1, E)
        vk = rng.integers(0, K + 1, E)
        return owner, vt, vk, T, K

    @pytest.mark.parametrize("seed", range(6))
    def test_live_block_tables_match_jax(self, seed):
        owner, vt, vk, T, K = self._layout(seed)
        for bt, bk in ((128, 128), (64, 128), (128, 64)):
            kw = dict(T=T, K=K, block_t=bt, block_k=bk)
            mine = live_block_tables(owner, vt, vk, **kw)
            theirs = jax_live_block_tables(owner, vt, vk, **kw)
            for a, b in zip(mine, theirs):
                np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("seed", range(6))
    def test_grid_accounting_matches_jax(self, seed):
        owner, vt, vk, T, K = self._layout(seed)
        N = owner.size * 128
        for mode in ("dense", "compact"):
            for dt in ("float32", "bfloat16"):
                kw = dict(T=T, K=K, N=N, owner=owner, valid_t=vt, valid_k=vk)
                mine = grid_accounting(x_dtype=dt, w_dtype=dt, grid_mode=mode, **kw)
                theirs = jax_grid_accounting(
                    x_dtype=dt, w_dtype=dt, grid_mode=mode, **kw
                )
                assert mine.as_dict() == theirs.as_dict()

    # bfloat16-narrow: on a card with more multiprocessors than the launch
    # has tiles, so it takes 64 x 64 tiles throughout
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "bfloat16-narrow"])
    @pytest.mark.parametrize("grid_mode", ["dense", "compact"])
    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("blocks", [(128, 128, 128), (32, 64, 96), (192, 32, 64)])
    def test_launch_table_covers_the_output_once(self, seed, blocks, grid_mode, dtype):
        bt, bk, bn = blocks
        bf16 = dtype != "float32"
        sms = 10**6 if dtype == "bfloat16-narrow" else 0
        owner, vt, vk, T, K = self._layout(seed)
        T, K = T // 128 * 3 * bt, K // 128 * 3 * bk
        vt, vk = vt * 3 * bt // 128, vk * 3 * bk // 128
        N = owner.size * bn
        table = stacked_table(
            (vt.size, T, K), N, *_ints(owner, vt, vk), bn, grid_mode == "dense", bf16,
            sms,
        )
        assert table.narrow == (sms > 0)
        writes = np.zeros((T, N), np.int64)
        by_live = np.zeros((T, N), bool)
        n_live = 0
        for kind, s, t, row0, col0, r_end, c_end in _walk(table):
            assert kind != "exit" or grid_mode == "dense"
            if kind == "exit":
                continue
            c0 = s.out_off + col0
            writes[row0 : row0 + r_end, c0 : c0 + c_end] += 1
            if kind == "live":
                n_live += 1
                by_live[row0 : row0 + r_end, c0 : c0 + c_end] = True
        np.testing.assert_array_equal(writes, 1)  # every byte once
        e = owner[np.arange(N) // bn]
        live = (np.arange(T)[:, None] < vt[e][None, :]) & (vk[e] > 0)[None, :]
        assert not (live & ~by_live).any()  # every live value is computed
        shapes = [_tile(table, s) for s in table.segments]
        col_tiles = [-(-s.cols // bn) for s, (_, bn) in zip(table.segments, shapes)]
        rows = [table.tenants[s.tenant].rows for s in table.segments]
        want = sum(
            c * -(-r // bm) for c, r, (bm, _) in zip(col_tiles, rows, shapes)
        )
        assert n_live == want  # no tile computes without live rows
        if grid_mode == "dense":
            rows_of_grid = -(-T // NARROW) * NARROW
            assert table.grid == sum(
                c * -(-rows_of_grid // bm) for c, (bm, _) in zip(col_tiles, shapes)
            )


def _ints(*arrays):
    """NumPy int arrays as the tuples that the cached table functions take."""
    return [tuple(np.asarray(a).tolist()) for a in arrays]


def _tile(table, s):
    """The tile shape of segment ``s`` of ``table``."""
    rows = table.tenants[s.tenant].rows
    return tile_shape(rows, s.cols, table.bf16, table.narrow)


def _search(starts, b):
    """The last index whose start is at or before ``b`` (the kernels' binary
    search over range starts)."""
    lo, hi = 0, len(starts) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if starts[mid] <= b:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _walk_bf16(table):
    """``_walk`` for a bfloat16 table, as ``wide_tile`` walks it: every
    segment's live tiles (row tile fastest), then every segment's dead
    ones; the dense grid's tiles past the caller's rows are not walked."""
    shapes, live_first, dead_first, live, dead = [], [], [], 0, 0
    for s in table.segments:
        t = table.tenants[s.tenant]
        bm, bn = _tile(table, s)
        col_tiles = -(-s.cols // bn)
        live_rows = -(-t.rows // bm)
        tile_rows = bm if table.dense else ZERO_ROWS
        dead_rows = max(0, -(-(t.out_rows - live_rows * bm) // tile_rows))
        shapes.append((bm, bn, live_rows, tile_rows, dead_rows))
        live_first.append(live)
        dead_first.append(dead)
        live += live_rows * col_tiles
        dead += dead_rows * col_tiles
    for b in range(live + dead):
        starts = live_first if b < live else [live + d for d in dead_first]
        i = _search(starts, b)
        s = table.segments[i]
        t = table.tenants[s.tenant]
        bm, bn, live_rows, tile_rows, dead_rows = shapes[i]
        local = b - starts[i]
        if b < live:
            row0, col0, tile_rows = local % live_rows * bm, local // live_rows * bn, bm
        else:
            row0 = live_rows * bm + local % dead_rows * tile_rows
            col0 = local // dead_rows * bn
        r_end = min(tile_rows, t.out_rows - row0)
        c_end = min(bn, s.cols - col0)
        yield ("live" if b < live else "zero"), s, t, row0, col0, r_end, c_end


def _walk(table):
    """Every tile of ``table`` as ``(kind, segment, tenant, row0, col0,
    r_end, c_end)``, found exactly as the CUDA source finds it: float32 as
    ``run_cta`` does, the segment by binary search over the range starts,
    the tile from the offset in the segment's range (its main tiles, row
    tile fastest, then its zero-fill tiles); bfloat16 by ``_walk_bf16``.
    ``kind`` is "live" (computes), "zero" (writes zeros) or "exit" (no tile
    of the output)."""
    if table.bf16:
        yield from _walk_bf16(table)
        return
    for b in range(table.grid):
        lo = _search(table.first, b)
        s = table.segments[lo]
        t = table.tenants[s.tenant]
        bm, bn = _tile(table, s)
        live_tiles = -(-t.rows // bm)
        row_tiles = -(-table.grid_rows * NARROW // bm) if table.dense else live_tiles
        col_tiles = -(-s.cols // bn)
        local = b - table.first[lo]
        if local < row_tiles * col_tiles:
            row0 = local % row_tiles * bm
            col0 = local // row_tiles * bn
            tile_rows = bm
        else:
            local -= row_tiles * col_tiles
            fill_tiles = -(-(t.out_rows - live_tiles * bm) // ZERO_ROWS)
            row0 = live_tiles * bm + local % fill_tiles * ZERO_ROWS
            col0 = local // fill_tiles * bn
            tile_rows = ZERO_ROWS
        if row0 >= t.out_rows:
            yield "exit", s, t, row0, col0, 0, 0
            continue
        r_end = min(tile_rows, t.out_rows - row0)
        c_end = min(bn, s.cols - col0)
        yield ("zero" if row0 >= t.rows else "live"), s, t, row0, col0, r_end, c_end


def _interpret(table, bufs):
    """Run ``table`` on flat float32 NumPy buffers as the kernels would: a
    live CTA sums its tenant's x rows times its segment's w columns over the
    live depth and writes zeros in its rows past the live rows; a zero CTA
    writes zeros.  Returns the number of writes of every element."""
    writes = [np.zeros(b.shape, np.int64) for b in bufs]
    for kind, s, t, row0, col0, r_end, c_end in _walk(table):
        if kind == "exit":
            continue
        r = row0 + np.arange(r_end)
        c = col0 + np.arange(c_end)
        val = np.zeros((r_end, c_end), np.float32)
        if kind == "live":
            k = np.arange(t.depth)
            rr = np.minimum(r, t.rows - 1)
            x = bufs[t.x][t.x_off + rr[:, None] * t.ldx + k[None, :]]
            w = bufs[s.w][s.w_off + k[:, None] * s.ldw + c[None, :]]
            val = np.where((r < t.rows)[:, None], x @ w, 0.0)
        idx = s.out_off + r[:, None] * s.ldo + c[None, :]
        bufs[s.out][idx] = val
        writes[s.out][idx] += 1
    return writes


def _flat(a: np.ndarray, dtype: str) -> np.ndarray:
    """``a`` rounded to ``dtype`` as the kernel reads it, as flat float32."""
    return torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy().ravel()


class TestLaunchTable:
    @pytest.mark.parametrize("grid_mode", ["dense", "compact"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize(
        "shape, blocks",
        [((3, 256, 384, 384), (128, 128, 128)), ((4, 192, 96, 288), (64, 32, 96))],
    )
    def test_stacked_table_matches_jax(self, shape, blocks, dtype, grid_mode):
        E, T, K, N = shape
        bt, bk, bn = blocks
        rng = np.random.default_rng(E)
        vt = rng.integers(0, T + 1, E)
        vk = rng.integers(0, K + 1, E)
        vt[0], vk[0] = T, K  # one tenant whose blocks are all live
        xs, w, owner, vt, vk = _mk_int(E, E, T, K, N, N // bn, vt, vk)
        xs += rng.standard_normal(xs.shape, dtype=np.float32) * (xs != 0)
        kw = dict(block_t=bt, block_k=bk, block_n=bn)
        table = stacked_table(
            (E, T, K),
            N,
            *_ints(owner, vt, vk),
            bn,
            grid_mode == "dense",
            dtype == "bfloat16",
        )
        bufs = [_flat(xs, dtype), _flat(w, dtype), np.full(T * N, np.nan, np.float32)]
        writes = _interpret(table, bufs)
        np.testing.assert_array_equal(writes[2], 1)
        jxs, _ = _both(xs, dtype)
        jw, _ = _both(w, dtype)
        jargs = [jnp.asarray(a) for a in (owner, vt, vk)]
        want = jax_pm(jxs, jw, *jargs, grid_mode=grid_mode, interpret=True, **kw)
        got = bufs[2].reshape(T, N)
        np.testing.assert_allclose(got, np.asarray(want), **TOL[dtype])

    # the heavy workload's unaligned depths (363, 147, 153) and N = 100
    SHAPES = [(70, 363, 100), (130, 147, 64), (20, 153, 100), (1, 9, 7)]

    @pytest.mark.parametrize("grid_mode", ["dense", "compact"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_tenant_table_matches_jax(self, dtype, grid_mode):
        xs, ws = _ragged_operands(11, self.SHAPES)
        E = len(xs)
        table = tenant_table(
            tuple(self.SHAPES),
            tuple(k for _, k, _ in self.SHAPES),
            tuple(n for _, _, n in self.SHAPES),
            grid_mode == "dense",
            dtype == "bfloat16",
        )
        outs = [np.full(t * n, np.nan, np.float32) for t, _, n in self.SHAPES]
        bufs = [_flat(x, dtype) for x in xs] + [_flat(w, dtype) for w in ws] + outs
        writes = _interpret(table, bufs)
        jouts = jax_fused(
            [jnp.asarray(x).astype(getattr(jnp, dtype)) for x in xs],
            [jnp.asarray(w).astype(getattr(jnp, dtype)) for w in ws],
            block_t=64,
            block_k=64,
            block_n=64,
            grid_mode=grid_mode,
            interpret=True,
        )
        for i, ((t, _, n), jo) in enumerate(zip(self.SHAPES, jouts)):
            np.testing.assert_array_equal(writes[2 * E + i], 1)
            got = bufs[2 * E + i].reshape(t, n)
            np.testing.assert_allclose(got, np.asarray(jo), **TOL[dtype])
        assert all(not w.any() for w in writes[: 2 * E])  # inputs never written

    def test_zero_depth_tenant_gets_zeros_and_no_live_tile(self):
        shapes = ((100, 0, 70), (64, 8, 64))
        table = tenant_table(shapes, (0, 8), (70, 64), False, True)
        kinds = [(kind, s.tenant) for kind, s, *_ in _walk(table)]
        assert ("live", 0) not in kinds and ("zero", 0) in kinds
        x1 = np.ones(64 * 8, np.float32)
        w1 = np.ones(8 * 64, np.float32)
        bufs = [np.zeros(0, np.float32), x1, np.zeros(0, np.float32), w1]
        bufs += [np.full(100 * 70, np.nan, np.float32), np.zeros(64 * 64, np.float32)]
        writes = _interpret(table, bufs)
        np.testing.assert_array_equal(writes[4], 1)
        np.testing.assert_array_equal(bufs[4], 0.0)
        np.testing.assert_array_equal(bufs[5], 8.0)

    def test_segments_run_deepest_tenant_first(self):
        shapes = ((64, 10, 64), (64, 500, 64), (64, 90, 64))
        table = tenant_table(shapes, (10, 500, 90), (64,) * 3, False, True)
        assert [s.tenant for s in table.segments] == [1, 2, 0]
        assert table.first == (0, 1, 2) and table.grid == 3

    @pytest.mark.parametrize("what", ["tenants", "segments"])
    def test_capacity_is_checked(self, what):
        n = (MAX_TENANTS if what == "tenants" else MAX_SEGMENTS) + 1
        if what == "tenants":
            with pytest.raises(ValueError, match="MAX_TENANTS"):
                tenant_table(((1, 1, 1),) * n, (1,) * n, (1,) * n, False, True)
        else:
            owner = tuple(i % 2 for i in range(n))  # one segment a block
            with pytest.raises(ValueError, match="MAX_SEGMENTS"):
                stacked_table(
                    (2, 64, 64), 64 * n, owner, (64, 64), (64, 64), 64, True, True
                )


def _bench_mixes():
    """benchmarks/kernel_bench.py's three mixes, from the port's workloads."""
    heavy = [
        (min(g.layers[0].gemm_m, 512), min(g.layers[0].gemm_k, 512))
        + (min(g.layers[0].gemm_n, 512),)
        for g in workloads.heavy_workload()
    ]
    return {
        "uniform": [(256, 256, 256)] * 4,
        "ragged": heavy[:4],
        "ragged_heavy": heavy,
    }


class TestBenchAnchors:
    @pytest.mark.parametrize("mix", ["uniform", "ragged", "ragged_heavy"])
    def test_block_counts_match_bench_kernel_record(self, mix):
        with open(os.path.join(ROOT, "BENCH_kernel.json")) as f:
            row = next(r for r in json.load(f)["results"] if r["mix"] == mix)
        shapes = tuple(_bench_mixes()[mix])
        assert [f"{t}x{k}x{n}" for t, k, n in shapes] == row["tenants"]
        for mode in ("dense", "compact"):
            acc = _geometry_accounting(
                shapes, 128, 128, 128, "float32", "float32", mode
            ).as_dict()
            assert acc == row[mode]

    def test_issue_anchor_numbers(self):
        mixes = _bench_mixes()
        want = {"uniform": (32, 32), "ragged": (64, 32), "ragged_heavy": (208, 72)}
        for mix, (dense, compact) in want.items():
            shapes = tuple(mixes[mix])
            acc = [
                _geometry_accounting(shapes, 128, 128, 128, "float32", "float32", m)
                for m in ("dense", "compact")
            ]
            assert (acc[0].blocks_scheduled, acc[1].blocks_scheduled) == (
                dense,
                compact,
            )
            if mix == "ragged_heavy":
                assert acc[0].bytes_fetched == 27_262_976
                assert acc[1].bytes_fetched == 9_437_184


def _ragged_operands(seed, shapes):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((t, k), dtype=np.float32) for t, k, _ in shapes]
    ws = [rng.standard_normal((k, n), dtype=np.float32) for _, k, n in shapes]
    return xs, ws


class TestFusedTenantGemm:
    SHAPES = [(150, 70, 40), (40, 150, 130), (64, 64, 64), (1, 9, 200)]

    @pytest.mark.parametrize("grid_mode", ["auto", "dense", "compact"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_jax(self, grid_mode, dtype):
        xs, ws = _ragged_operands(3, self.SHAPES)
        pairs = [(_both(x, dtype), _both(w, dtype)) for x, w in zip(xs, ws)]
        kw = dict(block_t=64, block_k=64, block_n=64, grid_mode=grid_mode)
        outs, stats = fused_tenant_gemm(
            [x[1] for x, _ in pairs], [w[1] for _, w in pairs], return_stats=True, **kw
        )
        jouts, jstats = jax_fused(
            [x[0] for x, _ in pairs],
            [w[0] for _, w in pairs],
            interpret=True,
            return_stats=True,
            **kw,
        )
        assert stats.as_dict() == jstats.as_dict()
        for o, jo in zip(outs, jouts):
            assert o.shape == jo.shape
            np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL[dtype])

    def test_auto_picks_compact_iff_ragged(self):
        xs, ws = _ragged_operands(4, [(256, 256, 128), (40, 60, 128)])
        kw = dict(block_t=128, block_k=128, block_n=128, return_stats=True)
        tx = [torch.from_numpy(x) for x in xs]
        tw = [torch.from_numpy(w) for w in ws]
        _, stats = fused_tenant_gemm(tx, tw, **kw)
        assert stats.grid_mode == "compact" and stats.accounting.blocks_skipped == 0
        xs, ws = _ragged_operands(5, [(128, 128, 128)] * 2)
        tx = [torch.from_numpy(x) for x in xs]
        tw = [torch.from_numpy(w) for w in ws]
        _, stats = fused_tenant_gemm(tx, tw, **kw)
        assert stats.grid_mode == "dense"
        assert stats.accounting.schedule_efficiency == 1.0

    def test_mixed_bf16_f32_promotes_like_jax(self):
        (x,), (w,) = _ragged_operands(6, [(64, 64, 64)])
        jx, tx = _both(x, "bfloat16")
        kw = dict(block_t=64, block_k=64, block_n=64, return_stats=True)
        (out,), stats = fused_tenant_gemm([tx], [torch.from_numpy(w)], **kw)
        (jout,), jstats = jax_fused([jx], [jnp.asarray(w)], interpret=True, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
        assert stats.as_dict() == jstats.as_dict()
        assert stats.accounting.x_bytes_fetched == stats.accounting.blocks_scheduled * (
            64 * 64 * 4
        )

    def test_autotune_ranks_like_jax_and_caches(self):
        # tiny tenants: any block over 128 only adds padding fetch traffic
        assert autotune_blocks(((64, 64, 64), (32, 48, 64))) == (128, 128, 128)
        shapes = ((512, 363, 96), (512, 147, 64), (54, 512, 100))
        before = autotune_blocks.cache_info().hits
        assert autotune_blocks(shapes) == autotune_blocks(shapes)
        assert autotune_blocks.cache_info().hits == before + 1

    def test_owner_map_is_vertical_partitioning(self):
        assert build_owner_map([100, 300, 128], 128).tolist() == [0, 1, 1, 1, 2]

    def test_sequential_matches_jax(self):
        xs, ws = _ragged_operands(7, self.SHAPES)
        outs = sequential_tenant_gemm(
            [torch.from_numpy(x) for x in xs], [torch.from_numpy(w) for w in ws]
        )
        jouts = jax_sequential([jnp.asarray(x) for x in xs], list(map(jnp.asarray, ws)))
        for o, jo in zip(outs, jouts):
            np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL["float32"])

    def test_record_gemm_stats_names_match_jax(self):
        """Both packages' stats land in their own ``MetricsRegistry`` under
        the same names and values."""
        from repro.obs import MetricsRegistry as JaxRegistry
        from repro_torch.obs import MetricsRegistry

        xs, ws = _ragged_operands(8, self.SHAPES)
        kw = dict(block_t=64, block_k=64, block_n=64, return_stats=True)
        mine, theirs = MetricsRegistry(), JaxRegistry()
        for mode in ("dense", "compact"):
            _, stats = fused_tenant_gemm(
                [torch.from_numpy(x) for x in xs],
                [torch.from_numpy(w) for w in ws],
                grid_mode=mode,
                **kw,
            )
            _, jstats = jax_fused(
                [jnp.asarray(x) for x in xs],
                [jnp.asarray(w) for w in ws],
                interpret=True,
                grid_mode=mode,
                **kw,
            )
            record_gemm_stats(mine, stats)
            jax_record(theirs, jstats)
        assert json.dumps(mine.as_dict()) == json.dumps(theirs.as_dict())
        assert mine.counters["kernel.gemm.calls"].value == 2
        assert "kernel.gemm.blocks_live" in mine.counters


def _int_dtype(pm, fused, z):
    return pm(z((1, 128, 128), "int32"), z((128, 128)), [0], [128])


def _f16_weights(pm, fused, z):
    return pm(z((1, 128, 128)), z((128, 128), "float16"), [0], [128])


def _indivisible(pm, fused, z):
    return pm(z((1, 100, 128)), z((128, 128)), [0], [100])


def _owner_shape(pm, fused, z):
    return pm(z((1, 128, 128)), z((128, 256)), [0] * 5, [128])


def _grid_mode(pm, fused, z):
    return pm(z((1, 128, 128)), z((128, 128)), [0], [128], grid_mode="sparse")


def _fused_grid_mode(pm, fused, z):
    return fused([z((4, 8))], [z((8, 4))], grid_mode="sparse")


def _empty(pm, fused, z):
    return fused([], [])


def _unpaired(pm, fused, z):
    return fused([z((4, 8))], [z((9, 4))])


def _torch_zeros(shape, dtype="float32"):
    return torch.zeros(shape, dtype=getattr(torch, dtype))


def _jax_zeros(shape, dtype="float32"):
    return jnp.zeros(shape, getattr(jnp, dtype))


def _jax_pm(xs, w, owner, vt, **kw):
    return jax_pm(xs, w, jnp.asarray(owner), jnp.asarray(vt), interpret=True, **kw)


def _jax_fused(xs, ws, **kw):
    return jax_fused(xs, ws, interpret=True, **kw)


@pytest.mark.parametrize(
    "call, exc",
    [
        (_int_dtype, TypeError),
        (_f16_weights, TypeError),
        (_indivisible, ValueError),
        (_owner_shape, ValueError),
        (_grid_mode, ValueError),
        (_fused_grid_mode, ValueError),
        (_empty, ValueError),
        (_unpaired, ValueError),
    ],
)
def test_same_exceptions_as_jax(call, exc):
    with pytest.raises(exc):
        call(_jax_pm, _jax_fused, _jax_zeros)
    with pytest.raises(exc):
        call(partitioned_matmul, fused_tenant_gemm, _torch_zeros)


@pytest.mark.parametrize("group", ["heavy_workload", "light_workload"])
def test_workload_gemm_shapes_match_jax(group):
    mine = getattr(workloads, group)()
    theirs = getattr(jax_workloads, group)()
    assert [g.name for g in mine] == [g.name for g in theirs]
    for a, b in zip(mine, theirs):
        assert a.arrival_time == b.arrival_time
        assert [(x.name, x.gemm_m, x.gemm_k, x.gemm_n, x.macs) for x in a] == [
            (y.name, y.gemm_m, y.gemm_k, y.gemm_n, y.macs) for y in b
        ]
