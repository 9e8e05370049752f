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
    TILE_COLS,
    TILE_ROWS,
    ZERO_ROWS,
)

ROOT = Path(__file__).resolve().parents[1]
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


def _walked(table, bf16: bool) -> TableCounts:
    """The table's counts from its CTAs, each found as ``run_cta`` finds it:
    a tile past the caller's rows exits, one at or past the live rows writes
    zeros, any other runs the K loop over the depth in whole K slices."""
    mac = fill = issued = 0
    bk = K_SLICES[bf16]
    for b in range(table.grid):
        seg = max(i for i, f in enumerate(table.first) if f <= b)
        s = table.segments[seg]
        t = table.tenants[s.tenant]
        live = -(-t.rows // TILE_ROWS)
        row_tiles = table.grid_rows if table.dense else live
        local = b - table.first[seg]
        if local < row_tiles * -(-s.cols // TILE_COLS):
            row0 = local % row_tiles * TILE_ROWS
        else:
            local -= row_tiles * -(-s.cols // TILE_COLS)
            fill_tiles = -(-(t.out_rows - live * TILE_ROWS) // ZERO_ROWS)
            row0 = live * TILE_ROWS + local % fill_tiles * ZERO_ROWS
        if row0 >= t.out_rows:
            continue
        if row0 >= t.rows:
            fill += 1
        else:
            mac += 1
            issued += TILE_ROWS * TILE_COLS * -(-t.depth // bk) * bk
    useful = sum(table.tenants[s.tenant].rows * table.tenants[s.tenant].depth * s.cols
                 for s in table.segments)
    return TableCounts(int(table.dense), table.grid, mac, fill, issued, useful)


# (100, 40, 70): two row tiles, two column tiles; (64, 8, 64): one tile;
# (5, 0, 9): no depth, so no live row
TENANTS = ((100, 40, 70), (64, 8, 64), (5, 0, 9))
TENANT_LDS = ((40, 8, 0), (70, 64, 9))
# per dtype (float32, bfloat16): 4 CTAs x 64 x 64 x 40 rounded up to the K
# slice (48, 64), plus 1 x 64 x 64 x 8 rounded up (16, 32)
TENANT_ISSUED = (4096 * (4 * 48 + 16), 4096 * (4 * 64 + 32))
TENANT_USEFUL = 100 * 40 * 70 + 64 * 8 * 64
# two tenants of a (2, 512, 128) stack, one 128-column block each: tenant 0
# 100 live rows at depth 100, tenant 1 no live row
STACK = ((2, 512, 128), 256, (0, 1), (100, 0), (100, 128), 128)
STACK_ISSUED = (4 * 4096 * 112, 4 * 4096 * 128)
STACK_USEFUL = 100 * 100 * 128

HAND = {
    # compact: 2x2 + 1 live CTAs; the zero-depth tenant's 5 rows one fill CTA
    "tenant-compact": (
        lambda: tenant_table(TENANTS, *TENANT_LDS, False),
        (6, 5, 1),
        TENANT_ISSUED,
        TENANT_USEFUL,
    ),
    # dense: 2 row tiles a column tile (grid 8); tenant 1's second row tile
    # and tenant 2's second exit, tenant 2's first writes zeros
    "tenant-dense": (
        lambda: tenant_table(TENANTS, *TENANT_LDS, True),
        (8, 5, 1),
        TENANT_ISSUED,
        TENANT_USEFUL,
    ),
    # compact: tenant 0's 2x2 live CTAs, then 384 dead rows in 2 fill tiles a
    # column tile; tenant 1's 512 dead rows in 2 a column tile
    "stacked-compact": (
        lambda: stacked_table(*STACK, False),
        (12, 4, 8),
        STACK_ISSUED,
        STACK_USEFUL,
    ),
    # dense: 8 row tiles x 2 column tiles a segment, all but tenant 0's 4
    # live ones zeroed
    "stacked-dense": (
        lambda: stacked_table(*STACK, True),
        (32, 4, 28),
        STACK_ISSUED,
        STACK_USEFUL,
    ),
}


@pytest.mark.parametrize("case", sorted(HAND))
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_table_counts_match_hand_counts(case, bf16):
    make, (ctas, mac, fill), issued, useful = HAND[case]
    table = make()
    want = TableCounts(int(table.dense), ctas, mac, fill, issued[bf16], useful)
    assert table.grid == ctas
    assert table.counts[bf16] == want
    assert _walked(table, bf16) == want


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
    table = tenant_table(shapes, *lds, dense)
    n_blocks = rng.randint(1, 6)
    owner = tuple(rng.randrange(E) for _ in range(n_blocks))
    valid_t = tuple(rng.choice([0, 1, 64, 100, 512]) for _ in range(E))
    valid_k = tuple(rng.choice([0, 1, 31, 128]) for _ in range(E))
    stacked = stacked_table((E, 512, 128), 64 * n_blocks, owner, valid_t, valid_k,
                            64, dense)
    for t in (table, stacked):
        for bf16 in (False, True):
            assert t.counts[bf16] == _walked(t, bf16)


def _plan_counts(config: str) -> TableCounts:
    """CTAs and multiply-adds of one round of a benchmark configuration at
    the mix's batch, each wave's grid mode chosen as ``fused_tenant_gemm``'s
    auto mode chooses it (compact exactly where the partition blocks leave a
    dead block), its launch table as the card path builds it for contiguous
    operands."""
    sys.path.insert(0, str(ROOT))
    try:
        from cardbench import harness
    finally:
        sys.path.remove(str(ROOT))
    cfg = harness.config(config)
    waves = harness.module("drivers", "gemm_rounds").waves
    batch = harness.mix("rounds-b128")["batch"]
    total = TableCounts(0, 0, 0, 0, 0, 0)
    for wave in waves(cfg, batch):
        shapes = tuple(s for _, s in wave)
        blocks = autotune_blocks(shapes, "bfloat16", "bfloat16", grid_mode="compact")
        probe = _geometry_accounting(shapes, *blocks, "bfloat16", "bfloat16", "dense")
        dense = probe.blocks_live == probe.blocks_total
        lds = tuple(k for _, k, _ in shapes), tuple(n for _, _, n in shapes)
        counts = tenant_table(shapes, *lds, dense).counts[True]
        total = TableCounts(*(a + b for a, b in zip(total, counts)))
    return total


@pytest.mark.parametrize(
    "config, dense_waves, waves, ctas, efficiency",
    [("table1-heavy", 2, 60, 860_316, 99.01), ("table1-light", 11, 17, 211_200, 99.18)],
)
def test_the_benchmark_plans_count_as_predicted(config, dense_waves, waves, ctas,
                                                efficiency):
    with open(ROOT / "cardbench" / "configs" / f"{config}.json") as f:
        assert max(len(t["layers"]) for t in json.load(f)["tenants"]) == waves
    counts = _plan_counts(config)
    assert counts.dense == dense_waves
    assert counts.ctas == counts.mac_ctas == ctas
    assert counts.fill_ctas == 0
    assert round(100 * counts.macs_useful / counts.macs_issued, 2) == efficiency


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
    monkeypatch.setattr(pm, "_check_device", lambda index: None)
    monkeypatch.setattr(pm, "_raw_stream", lambda index: 0)
    monkeypatch.setattr(pm, "_pack", lambda table, bufs: np.zeros(8, np.uint8))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def run(table, bf16, clock=None):
        pm._launch(table, (), bf16, torch.device("cuda", 0), clock)

    return run


def test_launch_counts_keep_their_shape_and_read_the_store(clean_store, launch):
    assert launch_counts() == {"dense": 0, "compact": 0}
    xs = [torch.ones(3, 4), torch.ones(5, 2)]
    ws = [torch.ones(4, 6), torch.ones(2, 3)]
    fused_tenant_gemm(xs, ws)  # the CPU path launches nothing
    assert launch_counts() == {"dense": 0, "compact": 0}
    compact = tenant_table(TENANTS, *TENANT_LDS, False)
    dense = tenant_table(TENANTS, *TENANT_LDS, True)
    launch(compact, True)
    launch(dense, False)
    assert launch_counts() == {"dense": 1, "compact": 1}
    stats = launch_stats()
    assert stats["launches"] == launch_counts()
    assert stats["ctas"] == compact.grid + dense.grid
    assert stats["fill_ctas"] == 2
    assert stats["macs_issued"] == sum(TENANT_ISSUED)
    assert stats["macs_useful"] == 2 * TENANT_USEFUL
    reset_launch_counts()
    assert launch_counts() == {"dense": 0, "compact": 0}
    assert launch_stats()["ctas"] == 0


def test_each_launch_counts_once_across_reads_resets_and_folds(clean_store, launch):
    compact = tenant_table(TENANTS, *TENANT_LDS, False)
    for _ in range(3):
        launch(compact, True)
    assert launch_counts()["compact"] == 3  # read: summed, the counter zeroed
    launch(compact, True)
    launch(compact, False)
    assert launch_stats()["macs_issued"] == 4 * TENANT_ISSUED[1] + TENANT_ISSUED[0]
    launch(compact, True)
    reset_launch_stats()
    launch(compact, True)
    assert launch_stats()["ctas"] == compact.grid
    # more tables than the store watches between reads: summed as it goes
    tables = [tenant_table(((i + 1, 8, 8),), (8,), (8,), False)
              for i in range(2 * tracing.FOLD + 3)]
    for t in tables:
        launch(t, True)
        launch(t, True)
    assert len(tracing._store.watched) < tracing.FOLD
    assert launch_counts()["compact"] == 1 + 2 * len(tables)
    assert launch_stats()["ctas"] == compact.grid + 2 * sum(t.grid for t in tables)


def test_a_launch_ends_the_table_and_launch_phases(clean_store, launch):
    table = tenant_table(TENANTS, *TENANT_LDS, False)
    set_tracing(True)
    clock = tracing.Clock()
    clock.mark()  # prepare
    clock.mark()  # alloc
    launch(table, True, clock)
    empty = tenant_table(((0, 8, 8),), (8,), (8,), True)  # no CTA, no launch
    clock = tracing.Clock()
    clock.mark()
    clock.mark()
    launch(empty, True, clock)
    stats = launch_stats()
    assert stats["phase_calls"] == dict.fromkeys(tracing.PHASES, 2)
    assert stats["launches"] == {"dense": 0, "compact": 1}


def test_table_builds_count_cache_misses(clean_store):
    shapes = ((7, 9, 11), (13, 3, 5))
    lds = (9, 3), (11, 5)
    tenant_table(shapes, *lds, False)
    tenant_table(shapes, *lds, False)
    stacked_table((1, 64, 64), 64, (0,), (17,), (19,), 64, True)
    stacked_table((1, 64, 64), 64, (0,), (17,), (19,), 64, True)
    assert launch_stats()["table_builds"] == 2


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
    table = tenant_table(shapes, *lds, bool(dense))
    assert after["ctas"] - before["ctas"] == table.grid
    assert after["table_builds"] == before["table_builds"]
    for p in tracing.PHASES:
        assert after["phase_calls"][p] - before["phase_calls"][p] == 1
    for x, w, out in zip(xs, ws, outs):
        ref = x @ w
        assert ((out - ref).abs().max() / ref.abs().max()).item() < 1e-4
