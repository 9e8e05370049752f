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
    compact_run_list,
    fused_tenant_gemm,
    grid_accounting,
    live_block_tables,
    partitioned_matmul,
    partitioned_matmul_ref,
    record_gemm_stats,
    sequential_tenant_gemm,
)
from repro_torch.kernels.ops import _geometry_accounting
from repro_torch.kernels.partitioned_matmul import _live_extents
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

    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("blocks", [(128, 128, 128), (32, 64, 96), (192, 32, 64)])
    def test_compact_run_list_covers_exactly_the_live_tiles(self, seed, blocks):
        bt, bk, bn = blocks
        owner, vt, vk, T, K = self._layout(seed)
        T, K = T // 128 * 3 * bt, K // 128 * 3 * bk
        vt, vk = vt * 3 * bt // 128, vk * 3 * bk // 128
        tl, kl = _live_extents(owner, vt, vk, T=T, K=K, block_t=bt, block_k=bk)
        runs = compact_run_list(
            tl, kl, block_t=bt, block_k=bk, block_n=bn, tile_rows=64, tile_cols=64
        )
        sub = -(-bn // 64)
        covered = np.zeros((T, owner.size * bn), bool)
        for ct, tt, k_end, row_end in runs:
            n, j = divmod(int(ct), sub)
            c0 = n * bn + j * 64
            c1 = min(c0 + 64, (n + 1) * bn)
            r0 = int(tt) * 64
            assert r0 < row_end and k_end == kl[n] * bk and row_end == tl[n] * bt
            assert not covered[r0:row_end, c0:c1].any()  # no tile launched twice
            covered[r0 : min(r0 + 64, row_end), c0:c1] = True
        live = np.arange(T)[:, None] < np.repeat(tl * bt, bn)[None, :]
        np.testing.assert_array_equal(covered, live)


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
        class Registry:
            def __init__(self):
                self.seen = {}

            def _metric(self, name):
                reg = self

                class M:
                    def inc(self, n=1):
                        reg.seen[name] = reg.seen.get(name, 0) + n

                    def set(self, v):
                        reg.seen[name] = v

                    def observe(self, v):
                        reg.seen.setdefault(name, []).append(v)

                return M()

            counter = gauge = histogram = _metric

        xs, ws = _ragged_operands(8, self.SHAPES)
        kw = dict(block_t=64, block_k=64, block_n=64, return_stats=True)
        _, stats = fused_tenant_gemm(
            [torch.from_numpy(x) for x in xs], [torch.from_numpy(w) for w in ws], **kw
        )
        _, jstats = jax_fused(
            [jnp.asarray(x) for x in xs],
            [jnp.asarray(w) for w in ws],
            interpret=True,
            **kw,
        )
        mine, theirs = Registry(), Registry()
        record_gemm_stats(mine, stats)
        jax_record(theirs, jstats)
        assert mine.seen == theirs.seen and "kernel.gemm.blocks_live" in mine.seen


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
