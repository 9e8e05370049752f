"""The fused GEMM's launch counters and host-phase spans
(``repro_torch.kernels.tracing``).

The counters are worked out from each launch table on the host, so they
are held here against hand counts and against a walk of the CTAs made as
``run_cta`` in the CUDA source makes it, and the benchmark's two plans are
counted with no card.  The one test that launches is marked ``cuda``:

    python -m pytest -q -m cuda tests/test_torch_gemm_trace.py

The file imports no JAX: the card's machine has none.
"""

import importlib
import json
import random
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (  # noqa: E402
    TableCounts,
    autotune_blocks,
    fused_tenant_gemm,
    launch_counts,
    launch_stats,
    reset_launch_counts,
    reset_launch_stats,
    set_tracing,
    stacked_table,
    tenant_table,
)
from repro_torch.kernels import tracing  # noqa: E402
from repro_torch.kernels.ops import _geometry_accounting  # noqa: E402
from repro_torch.kernels.partitioned_matmul import (  # noqa: E402
    K_SLICES,
    ZERO_ROWS,
    _dense_fits,
    tile_shape,
)

ROOT = Path(__file__).resolve().parents[1]
# streaming multiprocessors of the H100 SXM the benchmark runs on
H100_SMS = 132
SPANS = [tracing.SPAN_PREFIX + p for p in tracing.PHASES]


@pytest.fixture
def clean_store():
    """A zeroed store and tracing off, and both as they were afterwards."""
    was = set_tracing(False)
    saved = tracing._store
    reset_launch_stats()
    yield
    tracing._store = saved
    set_tracing(was)


def _tiles(table):
    """Every tile of ``table`` as the kernel finds it, as ``(kind, tenant,
    segment, tile rows, tile columns)``, kind "live", "zero" or "exit".
    float32 as ``run_cta`` walks the grid: the segment whose range holds
    the tile, its 64 x 64 tiles row tile fastest (dense: ``grid_rows`` a
    column tile), then its zero-fill tiles.  bfloat16 as ``wide_tile`` walks
    it: every segment's live tiles, then every segment's dead ones (the
    dense grid's tiles past the caller's rows are not walked); each
    segment's tile shape from its tenant's live rows and its columns, or 64
    x 64 throughout in a narrow launch."""
    if table.bf16:
        dead_tiles = []
        for s in table.segments:
            t = table.tenants[s.tenant]
            bm, bn = tile_shape(t.rows, s.cols, True, table.narrow)
            col_tiles, live = -(-s.cols // bn), -(-t.rows // bm)
            for _ in range(col_tiles * live):
                yield "live", t, s, bm, bn
            step = bm if table.dense else ZERO_ROWS
            dead = max(0, -(-(t.out_rows - live * bm) // step))
            dead_tiles += [(t, s, bm, bn)] * (col_tiles * dead)
        for t, s, bm, bn in dead_tiles:
            yield "zero", t, s, bm, bn
        return
    for b in range(table.grid):
        seg = max(i for i, f in enumerate(table.first) if f <= b)
        s = table.segments[seg]
        t = table.tenants[s.tenant]
        bm, bn = tile_shape(t.rows, s.cols, False)
        live = -(-t.rows // bm)
        row_tiles = table.grid_rows if table.dense else live
        local = b - table.first[seg]
        if local < row_tiles * -(-s.cols // bn):
            row0 = local % row_tiles * bm
        else:
            local -= row_tiles * -(-s.cols // bn)
            fill_tiles = -(-(t.out_rows - live * bm) // ZERO_ROWS)
            row0 = live * bm + local % fill_tiles * ZERO_ROWS
        kind = "exit" if row0 >= t.out_rows else "zero" if row0 >= t.rows else "live"
        yield kind, t, s, bm, bn


def _walked(table) -> TableCounts:
    """The table's counts from its tiles (``_tiles``): a live tile runs the
    K loop over the depth in whole K slices, on the staged feed where an x
    or w row is not a 16-byte multiple."""
    mac = fill = issued = staged = 0
    bk, item = K_SLICES[table.bf16], 2 if table.bf16 else 4
    for kind, t, s, bm, bn in _tiles(table):
        if kind == "zero":
            fill += 1
        elif kind == "live":
            mac += 1
            macs = bm * bn * -(-t.depth // bk) * bk
            issued += macs
            if (t.ldx * item) % 16 or (s.ldw * item) % 16:
                staged += macs
    useful = sum(table.tenants[s.tenant].rows * table.tenants[s.tenant].depth * s.cols
                 for s in table.segments)
    return TableCounts(int(table.dense), table.grid, mac, fill, issued, useful, staged)


# (100, 40, 70): float32 two row tiles and two column tiles, bfloat16 one
# 128 x 128 tile; (64, 8, 64): one tile (bfloat16 64 x 64); (5, 0, 9): no
# depth, so no live row
TENANTS = ((100, 40, 70), (64, 8, 64), (5, 0, 9))
TENANT_LDS = ((40, 8, 0), (70, 64, 9))
# per dtype (float32, bfloat16): float32 4 CTAs x 64 x 64 x 40 rounded up to
# the K slice (48) plus 1 x 64 x 64 x 8 rounded up (16); bfloat16 128 x 128
# x 64 plus 64 x 64 x 64
TENANT_ISSUED = (4096 * (4 * 48 + 16), 4096 * (4 * 64 + 64))
TENANT_USEFUL = 100 * 40 * 70 + 64 * 8 * 64
# tenant 0's w rows are 70 values: 280 bytes (float32), 140 (bfloat16), no
# 16-byte multiple, so its tiles take the staged feed
TENANT_STAGED = (4096 * 4 * 48, 4096 * 4 * 64)
# two tenants of a (2, 512, 128) stack, one 128-column block each: tenant 0
# 100 live rows at depth 100, tenant 1 no live row
STACK = ((2, 512, 128), 256, (0, 1), (100, 0), (100, 128), 128)
STACK_ISSUED = (4 * 4096 * 112, 4 * 4096 * 128)
STACK_USEFUL = 100 * 100 * 128

HAND = {
    # float32 compact: 2x2 + 1 live CTAs; the zero-depth tenant's 5 rows one
    # fill tile.  bfloat16: one 128 x 128 and one 64 x 64 live tile, one fill
    "tenant-compact": (
        lambda bf16: tenant_table(TENANTS, *TENANT_LDS, False, bf16),
        ((6, 5, 1), (3, 2, 1)),
        TENANT_ISSUED,
        TENANT_USEFUL,
        TENANT_STAGED,
    ),
    # dense: 128 rows of 64-row tiles a column tile (float32 grid 8, bfloat16
    # 5); tenant 1's second row tile and tenant 2's second are skipped,
    # tenant 2's first writes zeros
    "tenant-dense": (
        lambda bf16: tenant_table(TENANTS, *TENANT_LDS, True, bf16),
        ((8, 5, 1), (5, 2, 1)),
        TENANT_ISSUED,
        TENANT_USEFUL,
        TENANT_STAGED,
    ),
    # compact: tenant 0's live tiles (float32 2x2, bfloat16 one), then 384
    # dead rows in 2 fill tiles a column tile; tenant 1's 512 dead rows in 2
    # a column tile
    "stacked-compact": (
        lambda bf16: stacked_table(*STACK, False, bf16),
        ((12, 4, 8), (5, 1, 4)),
        STACK_ISSUED,
        STACK_USEFUL,
        (0, 0),
    ),
    # dense: float32 8 row tiles x 2 column tiles a segment, all but tenant
    # 0's 4 live ones zeroed; bfloat16 4 row tiles of 128 (one live) and 8 of
    # 64 for the tenant with no live row
    "stacked-dense": (
        lambda bf16: stacked_table(*STACK, True, bf16),
        ((32, 4, 28), (12, 1, 11)),
        STACK_ISSUED,
        STACK_USEFUL,
        (0, 0),
    ),
}


@pytest.mark.parametrize("case", sorted(HAND))
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_table_counts_match_hand_counts(case, bf16):
    make, ctas, issued, useful, staged = HAND[case]
    table = make(bf16)
    grid, mac, fill = ctas[bf16]
    want = TableCounts(
        int(table.dense), grid, mac, fill, issued[bf16], useful, staged[bf16]
    )
    assert table.grid == grid
    assert table.counts == want
    assert _walked(table) == want


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("dense", [False, True], ids=["compact", "dense"])
def test_table_counts_match_the_walk_of_the_grid(seed, dense):
    rng = random.Random(seed)
    E = rng.randint(1, 6)
    shapes = tuple(
        (rng.choice([0, 1, 63, 64, 65, 300, 700]), rng.choice([0, 1, 17, 33, 256]),
         rng.randint(1, 200))
        for _ in range(E)
    )
    lds = tuple(k for _, k, _ in shapes), tuple(n for _, _, n in shapes)
    n_blocks = rng.randint(1, 6)
    owner = tuple(rng.randrange(E) for _ in range(n_blocks))
    valid_t = tuple(rng.choice([0, 1, 64, 100, 512]) for _ in range(E))
    valid_k = tuple(rng.choice([0, 1, 31, 128]) for _ in range(E))
    # float32; bfloat16 with each segment's own tile; bfloat16 narrow
    # throughout, on a card with more multiprocessors than the launch has tiles
    for bf16, sms in ((False, 0), (True, 0), (True, 10**6)):
        table = tenant_table(shapes, *lds, dense, bf16, sms)
        stacked = stacked_table((E, 512, 128), 64 * n_blocks, owner, valid_t,
                                valid_k, 64, dense, bf16, sms)
        for t in (table, stacked):
            assert t.narrow == (sms > 0)
            assert t.counts == _walked(t)


# one tenant (T, K, N) a case: the bfloat16 tile follows its live rows (64
# up to 64, else 128) and its columns (likewise); the K loop covers the
# depth in slices of 64, a depth under 64 or off a multiple of 64 rounded up
TILE_CASES = {
    "batch-1": ((1, 64, 64), (64, 64), 1, 1),
    "rows-64": ((64, 128, 200), (64, 128), 2, 2),
    "rows-65": ((65, 128, 64), (128, 64), 2, 1),
    "cols-65": ((64, 128, 65), (64, 128), 2, 1),
    "both-wide": ((129, 64, 129), (128, 128), 1, 4),
    "k-under-a-slice": ((100, 1, 100), (128, 128), 1, 1),
    "k-off-a-slice": ((100, 65, 100), (128, 128), 2, 1),
    "k-1025": ((300, 1025, 513), (128, 128), 17, 15),
}


@pytest.mark.parametrize("case", sorted(TILE_CASES))
@pytest.mark.parametrize("dense", [False, True], ids=["compact", "dense"])
def test_the_bf16_tile_follows_the_input(case, dense):
    shape, tile, slices, tiles = TILE_CASES[case]
    t, k, n = shape
    table = tenant_table((shape,), (k,), (n,), dense, True)
    (tenant,), (seg,) = table.tenants, table.segments
    assert tile_shape(tenant.rows, seg.cols, True) == tile
    counts = table.counts
    assert counts.ctas == counts.mac_ctas == table.grid == tiles
    assert counts.macs_issued == tiles * tile[0] * tile[1] * slices * 64
    assert counts.macs_useful == t * k * n
    assert counts == _walked(table)
    # float32 keeps 64 x 64 tiles and slices of 16
    f32 = tenant_table((shape,), (k,), (n,), dense, False).counts
    assert f32.macs_issued == -(-t // 64) * -(-n // 64) * 4096 * -(-k // 16) * 16


# (T, K, N) and dtype: whether the tile's MACs take the staged feed, i.e.
# whether an x row (K values) or a w row (N values) is off a 16-byte multiple
STAGED_CASES = {
    "aligned": ((100, 64, 64), True, False),
    "odd-k": ((100, 147, 64), True, True),
    "odd-n": ((100, 64, 513), True, True),
    "n-100-4-byte-pitch": ((100, 64, 100), True, True),
    "k-8-n-8": ((100, 8, 8), True, False),
    "float32-n-100": ((100, 64, 100), False, False),
    "float32-n-70": ((100, 64, 70), False, True),
    "float32-odd-k": ((100, 147, 64), False, True),
}


@pytest.mark.parametrize("case", sorted(STAGED_CASES))
def test_feed_staged_macs_count_the_tiles_off_16_byte_rows(case):
    (t, k, n), bf16, staged = STAGED_CASES[case]
    counts = tenant_table(((t, k, n),), (k,), (n,), False, bf16).counts
    assert counts.feed_staged_macs == (counts.macs_issued if staged else 0)
    # beside an aligned tenant, only the unaligned tenant's MACs count
    shapes = ((t, k, n), (64, 64, 64))
    both = tenant_table(shapes, (k, 64), (n, 64), False, bf16).counts
    assert both.feed_staged_macs == counts.feed_staged_macs
    assert both.macs_issued > counts.macs_issued


def _plan_waves(config: str) -> list[tuple[tuple[int, int, int], ...]]:
    """Each wave's ``(T, K, N)`` shapes in one round of a Table-1
    configuration at the benchmark mix's batch."""
    sys.path.insert(0, str(ROOT))
    try:
        from cardbench import harness
    finally:
        sys.path.remove(str(ROOT))
    cfg = harness.config(config)
    waves = harness.module("drivers", "gemm_rounds").waves
    batch = harness.mix("rounds-b128")["batch"]
    return [tuple(s for _, s in wave) for wave in waves(cfg, batch)]


def _plan_counts(config: str) -> TableCounts:
    """CTAs and multiply-adds of one round of a benchmark configuration at
    the mix's batch, each wave's grid mode chosen as ``fused_tenant_gemm``'s
    auto mode chooses it on the card (dense exactly where every tenant has
    the same rows and depth), its launch table as the card path builds it
    for contiguous operands."""
    total = TableCounts(0, 0, 0, 0, 0, 0, 0)
    for shapes in _plan_waves(config):
        lds = tuple(k for _, k, _ in shapes), tuple(n for _, _, n in shapes)
        table = tenant_table(shapes, *lds, _dense_fits(shapes), True, H100_SMS)
        assert not table.narrow  # every wave has more tiles than the card SMs
        total = TableCounts(*(a + b for a, b in zip(total, table.counts)))
    return total


def _lfm2_calls(monkeypatch) -> set[tuple[tuple[int, int, int], ...]]:
    """The shapes of every GEMM call of one ``lfm2-24b-prefill-16k`` round
    but the expert calls (which take the epilogue, so are compact): the
    model's prefill of 4 x 4,096 tokens run on the meta device at the
    published widths, each expert given an even share of the rows."""
    from repro_torch.models import lfm2_moe
    from repro_torch.models import routed_experts as moe

    with open(ROOT / "cardbench" / "configs" / "lfm2-24b-a2b.json") as f:
        cfg = lfm2_moe.Lfm2MoeConfig.from_config(json.load(f))

    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [meta(v) for v in tree]
        return torch.empty(tree, dtype=torch.bfloat16, device="meta")

    class EvenCounts:
        def __init__(self, counts):
            self.experts = counts.shape[0]

        def get(self):
            rows = 4 * 4096 * cfg.num_experts_per_tok
            return [rows // self.experts] * self.experts

    calls = set()

    def gemm(xs, ws, **kw):
        shapes = tuple((x.shape[0], x.shape[1], w.shape[1]) for x, w in zip(xs, ws))
        if "out" in kw:
            return list(kw["out"].split([t for t, _, _ in shapes]))
        calls.add(shapes)
        return [torch.empty((t, n), device="meta") for t, _, n in shapes]

    monkeypatch.setattr(moe, "_CountRead", EvenCounts)
    ids = torch.zeros((4, 4096), dtype=torch.int64, device="meta")
    try:
        lfm2_moe.prefill(meta(lfm2_moe.param_shapes(cfg)), cfg, ids, gemm=gemm)
    finally:
        moe.reset_moe_stats()
    return calls


@pytest.mark.parametrize(
    "plan, dtype",
    [
        ("table1-heavy", "bfloat16"),
        ("table1-heavy", "float32"),
        ("table1-light", "bfloat16"),
        ("table1-light", "float32"),
        ("lfm2-24b-a2b", "bfloat16"),
    ],
)
def test_the_card_s_mode_rule_makes_the_partition_blocks_choice(plan, dtype,
                                                                monkeypatch):
    """On every call of the benchmark's cells (all Table-1 waves, every
    LFM2 call but the experts'), dense where every tenant has the same
    (T, K) is the choice the CPU path makes from the JAX package's
    autotuned partition blocks: dense exactly where they leave no dead
    block."""
    if plan == "lfm2-24b-a2b":
        calls = sorted(_lfm2_calls(monkeypatch))
        assert len(calls) == 7
    else:
        calls = _plan_waves(plan)
        assert len(calls) == {"table1-heavy": 60, "table1-light": 17}[plan]
    for shapes in calls:
        blocks = autotune_blocks(shapes, dtype, dtype, grid_mode="compact")
        probe = _geometry_accounting(shapes, *blocks, dtype, dtype, "dense")
        assert _dense_fits(shapes) == (probe.blocks_live == probe.blocks_total), shapes


# one launch a case, on a card of H100_SMS multiprocessors: (T, K, N) of
# each tenant, whether the launch takes 64 x 64 tiles throughout (its tiles
# cut so are no more than the SMs) and its live tiles
NARROW_CASES = {
    "deep-and-alone": (((54, 900, 100),), True, 2),
    "two-deep-tenants": (((54, 900, 100), (52, 1500, 100)), True, 4),
    "narrow-tiles-past-the-sms": (((12544, 147, 64),), False, 98),
    "at-the-sms": (((64 * H100_SMS, 64, 64),), True, H100_SMS),
    "one-past-the-sms": (((64 * H100_SMS + 1, 64, 64),), False, 67),
    "batch-1-light": (
        ((100, 1025, 2048), (20, 2048, 4096), (40, 512, 1024), (200, 160, 512)),
        False,
        64,
    ),
}


@pytest.mark.parametrize("case", sorted(NARROW_CASES))
@pytest.mark.parametrize("dense", [False, True], ids=["compact", "dense"])
def test_a_launch_no_larger_than_the_card_takes_narrow_tiles(case, dense):
    shapes, narrow, tiles = NARROW_CASES[case]
    lds = tuple(k for _, k, _ in shapes), tuple(n for _, _, n in shapes)
    table = tenant_table(shapes, *lds, dense, True, H100_SMS)
    assert table.narrow == narrow
    assert table.counts.mac_ctas == tiles
    assert table.counts == _walked(table)
    for s in table.segments:
        rows = table.tenants[s.tenant].rows
        bm, bn = tile_shape(rows, s.cols, True, table.narrow)
        assert (bm, bn) == ((64, 64) if narrow else tile_shape(rows, s.cols, True))
    # float32, and a card of no known size, keep each segment's own tiles
    assert not tenant_table(shapes, *lds, dense, False, H100_SMS).narrow
    assert not tenant_table(shapes, *lds, dense, True).narrow


@pytest.mark.parametrize(
    "config, dense_waves, waves, tiles, efficiency, staged",
    [
        ("table1-heavy", 2, 60, 245_669, 97.46, 2.45),
        ("table1-light", 11, 17, 53_600, 98.36, 10.49),
    ],
)
def test_the_benchmark_plans_count_as_predicted(config, dense_waves, waves, tiles,
                                                efficiency, staged):
    with open(ROOT / "cardbench" / "configs" / f"{config}.json") as f:
        assert max(len(t["layers"]) for t in json.load(f)["tenants"]) == waves
    counts = _plan_counts(config)
    assert counts.dense == dense_waves
    assert counts.ctas == counts.mac_ctas == tiles
    assert counts.fill_ctas == 0
    assert round(100 * counts.macs_useful / counts.macs_issued, 2) == efficiency
    assert round(100 * counts.feed_staged_macs / counts.macs_issued, 2) == staged


class _Library:
    """Stands in for the kernels' library: every launch succeeds."""

    @staticmethod
    def pm_launch(*args):
        return 0


@pytest.fixture
def launch(monkeypatch):
    """``_launch`` as the card path runs it, on the CPU: the library, the
    device check, the stream, the packed addresses and the current device
    stood in for, so the counters and the clock run as they do there."""
    pm = importlib.import_module("repro_torch.kernels.partitioned_matmul")
    monkeypatch.setattr(pm._build, "load", lambda: _Library)
    monkeypatch.setattr(pm, "_raw_stream", lambda index: 0)
    monkeypatch.setattr(pm, "_pack", lambda table, bufs: np.zeros(8, np.uint8))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def run(table, clock=None):
        pm._launch(table, (), torch.device("cuda", 0), clock)

    return run


def test_launch_counts_keep_their_shape_and_read_the_store(clean_store, launch):
    assert launch_counts() == {"dense": 0, "compact": 0}
    xs = [torch.ones(3, 4), torch.ones(5, 2)]
    ws = [torch.ones(4, 6), torch.ones(2, 3)]
    fused_tenant_gemm(xs, ws)  # the CPU path launches nothing
    assert launch_counts() == {"dense": 0, "compact": 0}
    compact = tenant_table(TENANTS, *TENANT_LDS, False, True)
    dense = tenant_table(TENANTS, *TENANT_LDS, True, False)
    launch(compact)
    launch(dense)
    assert launch_counts() == {"dense": 1, "compact": 1}
    stats = launch_stats()
    assert stats["launches"] == launch_counts()
    assert stats["ctas"] == compact.grid + dense.grid
    assert stats["fill_ctas"] == 2
    assert stats["macs_issued"] == sum(TENANT_ISSUED)
    assert stats["macs_useful"] == 2 * TENANT_USEFUL
    assert stats["feed_staged_macs"] == sum(TENANT_STAGED)
    reset_launch_counts()
    assert launch_counts() == {"dense": 0, "compact": 0}
    assert launch_stats()["ctas"] == 0


def test_each_launch_counts_once_across_reads_resets_and_folds(clean_store, launch):
    compact = tenant_table(TENANTS, *TENANT_LDS, False, True)
    compact32 = tenant_table(TENANTS, *TENANT_LDS, False, False)
    for _ in range(3):
        launch(compact)
    assert launch_counts()["compact"] == 3  # read: summed, the counter zeroed
    launch(compact)
    launch(compact32)
    assert launch_stats()["macs_issued"] == 4 * TENANT_ISSUED[1] + TENANT_ISSUED[0]
    launch(compact)
    reset_launch_stats()
    launch(compact)
    assert launch_stats()["ctas"] == compact.grid
    # more tables than the store watches between reads: summed as it goes
    tables = [tenant_table(((i + 1, 8, 8),), (8,), (8,), False, True)
              for i in range(2 * tracing.FOLD + 3)]
    for t in tables:
        launch(t)
        launch(t)
    assert len(tracing._store.watched) < tracing.FOLD
    assert launch_counts()["compact"] == 1 + 2 * len(tables)
    assert launch_stats()["ctas"] == compact.grid + 2 * sum(t.grid for t in tables)


def test_a_launch_ends_the_table_and_launch_phases(clean_store, launch):
    table = tenant_table(TENANTS, *TENANT_LDS, False, True)
    set_tracing(True)
    clock = tracing.Clock()
    clock.mark()  # prepare
    clock.mark()  # alloc
    launch(table, clock)
    empty = tenant_table(((0, 8, 8),), (8,), (8,), True, True)  # no tile, no launch
    clock = tracing.Clock()
    clock.mark()
    clock.mark()
    launch(empty, clock)
    stats = launch_stats()
    assert stats["phase_calls"] == dict.fromkeys(tracing.PHASES, 2)
    assert stats["launches"] == {"dense": 0, "compact": 1}


def test_table_builds_count_cache_misses(clean_store):
    shapes = ((7, 9, 11), (13, 3, 5))
    lds = (9, 3), (11, 5)
    tenant_table(shapes, *lds, False, True)
    tenant_table(shapes, *lds, False, True)
    tenant_table(shapes, *lds, False, False)  # keyed on the dtype too
    stacked_table((1, 64, 64), 64, (0,), (17,), (19,), 64, True, True)
    stacked_table((1, 64, 64), 64, (0,), (17,), (19,), 64, True, True)
    assert launch_stats()["table_builds"] == 3


def test_set_tracing_returns_the_previous_state(clean_store):
    assert set_tracing(True) is False
    assert tracing.armed is True
    assert set_tracing(False) is True
    assert tracing.armed is False


def _gemm_spans(prof) -> list:
    """The program's spans on the host (a span that launched a kernel is
    also mirrored on the device's timeline), in start order."""
    events = [
        e
        for e in prof.events()
        if e.name.startswith(tracing.SPAN_PREFIX)
        and e.device_type == torch.autograd.DeviceType.CPU
    ]
    return sorted(events, key=lambda e: e.time_range.start)


@pytest.mark.parametrize("armed", [False, True], ids=["off", "armed"])
def test_the_cpu_path_records_no_phase(clean_store, armed):
    from torch.profiler import ProfilerActivity, profile

    set_tracing(armed)
    xs = [torch.ones(3, 4), torch.ones(5, 2)]
    ws = [torch.ones(4, 6), torch.ones(2, 3)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fused_tenant_gemm(xs, ws)
    assert _gemm_spans(prof) == []
    stats = launch_stats()
    assert set(stats["phase_calls"].values()) == {0}
    assert set(stats["phase_ns"].values()) == {0}


def test_an_armed_clock_times_and_marks_the_four_phases_in_order(clean_store):
    from torch.profiler import ProfilerActivity, profile

    set_tracing(True)
    tracing.Clock().finish()  # no profiler: timed, no span
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            clock = tracing.Clock()
            for _ in tracing.PHASES:
                torch.empty(8)
                clock.mark()
    spans = _gemm_spans(prof)
    assert [e.name for e in spans] == SPANS
    for a, b in zip(spans, spans[1:]):
        assert a.time_range.end <= b.time_range.start
    (caller,) = [e for e in prof.events() if e.name == "caller"]
    assert all(
        caller.time_range.start <= e.time_range.start <= e.time_range.end
        <= caller.time_range.end
        for e in spans
    )
    stats = launch_stats()
    assert stats["phase_calls"] == dict.fromkeys(tracing.PHASES, 2)
    assert all(ns > 0 for ns in stats["phase_ns"].values())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_an_armed_card_call_marks_four_spans_and_counts_its_grid(cuda, clean_store):
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(0)
    shapes = ((300, 200, 100), (40, 70, 300), (1, 33, 7))
    xs = [torch.randn((t, k), generator=gen, device=cuda) for t, k, _ in shapes]
    ws = [torch.randn((k, n), generator=gen, device=cuda) for _, k, n in shapes]
    fused_tenant_gemm(xs, ws)  # builds the kernels and the table
    torch.cuda.synchronize()
    before = launch_stats()
    set_tracing(True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("caller"):
            outs = fused_tenant_gemm(xs, ws)
        torch.cuda.synchronize()
    set_tracing(False)
    after = launch_stats()
    spans = _gemm_spans(prof)
    assert [e.name for e in spans] == SPANS
    for a, b in zip(spans, spans[1:]):
        assert a.time_range.end <= b.time_range.start
    dense = after["launches"]["dense"] - before["launches"]["dense"]
    compact = after["launches"]["compact"] - before["launches"]["compact"]
    assert dense + compact == 1
    lds = tuple(k for _, k, _ in shapes), tuple(n for _, _, n in shapes)
    table = tenant_table(shapes, *lds, bool(dense), False)
    assert after["ctas"] - before["ctas"] == table.grid
    assert after["table_builds"] == before["table_builds"]
    for p in tracing.PHASES:
        assert after["phase_calls"][p] - before["phase_calls"][p] == 1
    for x, w, out in zip(xs, ws, outs):
        ref = x @ w
        assert ((out - ref).abs().max() / ref.abs().max()).item() < 1e-4


# chip_smoke.py's kernel time a call from a profile of 3 calls, one launch
# each: (name, ms a call, records) rows -> ms, or None with no record
KERNEL_TIME_CASES = {
    "every-record": ([("compact_kernel<bf16>", 0.03, 3), ("fill", 0.5, 3)], 0.03),
    "a-record-lost": ([("compact_kernel<bf16>", 0.02, 2)], 0.03),
    "no-record": ([("fill", 0.5, 3)], None),
    "the-other-kernel": ([("dense_kernel<bf16>", 0.02, 3)], None),
}


@pytest.mark.parametrize("case", sorted(KERNEL_TIME_CASES))
def test_chip_smoke_reads_no_kernel_time_without_a_record(case):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    rows, want = KERNEL_TIME_CASES[case]
    got = chip_smoke.kernel_time(rows, "compact", 3)
    assert got == (None if want is None else pytest.approx(want))
