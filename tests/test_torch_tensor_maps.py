"""Which operands of a bfloat16 launch share a tensor map
(``partitioned_matmul.operand_feeds``, the rule of ``encode_maps`` in the
CUDA source), and the launcher's counts by feed as ``launch_stats`` and the
benchmark's ``staged_feed_share`` read them.

Operands that are row-views of one storage, with one row pitch, one live
width and one column offset in a row, share one map; the rest keep a map
of their own until a launch's ``MAX_MAPS`` are used, and operands off 16
bytes are staged.  All of it follows from the tensors' addresses, so it is
held here on CPU tensors; the card tests hold the library's counts against
it (``tests/test_torch_cuda.py``).  The file imports no JAX.
"""

import importlib
import sys
from collections import Counter
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_stats, reset_launch_stats  # noqa: E402
from repro_torch.kernels import tracing  # noqa: E402

pm = importlib.import_module("repro_torch.kernels.partitioned_matmul")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cardbench import harness  # noqa: E402

READER = harness.module("metrics", "staged_feed_share")

# a routed layer at small widths: 64 experts, four of them empty
ROWS = [0 if e in (3, 17, 40, 63) else 5 + (7 * e) % 23 for e in range(64)]
D, F = 64, 64  # depths of whole K slices, as the cell's 2,048 and 1,536


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _feeds(table, xs, ws):
    return pm.operand_feeds(table, (*xs, *ws))


def _table(xs, ws, mode, out_cols=None):
    """The table a call of ``mode`` ("dense", "compact" or "epilogue", the
    last gated where ``out_cols`` is half of w's columns) makes."""
    shapes = tuple((x.shape[0], x.shape[1], w.shape[1]) for x, w in zip(xs, ws))
    lds = tuple(x.stride(0) for x in xs), tuple(w.stride(0) for w in ws)
    if mode == "epilogue":
        glu = 2 * out_cols == shapes[0][2]
        return pm.epilogue_table(shapes, *lds, out_cols, glu, 132)
    return pm.tenant_table(shapes, *lds, mode == "dense", True, 132)


def _expert_calls():
    """The layer's gate‖up and down operands: x one sorted buffer's split,
    w one stack's unbind."""
    gate_up = (list(_bf16(sum(ROWS), D).split(ROWS)), list(_bf16(64, D, 2 * F).unbind(0)))
    down = (list(_bf16(sum(ROWS), F).split(ROWS)), list(_bf16(64, F, D).unbind(0)))
    return {"gate_up": (*gate_up, F), "down": (*down, D)}


@pytest.mark.parametrize("mode", ["compact", "dense", "epilogue"])
@pytest.mark.parametrize("call", ["gate_up", "down"])
def test_expert_splits_and_unbinds_share_one_map_each(call, mode):
    xs, ws, out_cols = _expert_calls()[call]
    feeds = _feeds(_table(xs, ws, mode, out_cols), xs, ws)
    live = sum(1 for r in ROWS if r)
    assert len(feeds) == 2 * live  # the empty experts have no live operand
    assert {f for *_, f in feeds} == {"shared_map"}
    x_maps = {m for kind, _, m, _ in feeds if kind == "x"}
    w_maps = {m for kind, _, m, _ in feeds if kind == "w"}
    assert len(x_maps) == len(w_maps) == 1 and x_maps != w_maps


@pytest.mark.parametrize("call", ["gate_up", "down"])
def test_per_tenant_copies_take_a_map_each_until_the_maps_run_out(call):
    xs, ws, out_cols = _expert_calls()[call]
    xs, ws = [x.clone() for x in xs], [w.clone() for w in ws]
    feeds = _feeds(_table(xs, ws, "epilogue", out_cols), xs, ws)
    live = sum(1 for r in ROWS if r)
    assert Counter(f for *_, f in feeds) == {
        "own_map": pm.MAX_MAPS, "staged": 2 * live - pm.MAX_MAPS,
    }
    # in launch order, x then w, tenant by tenant: the first 12 live ones
    assert [m for _, _, m, _ in feeds[: pm.MAX_MAPS]] == list(range(pm.MAX_MAPS))
    assert {m for _, _, m, _ in feeds[pm.MAX_MAPS :]} == {-1}


def _flat_views(specs, K=64):
    """Views of one flat bfloat16 buffer, as ``gemm_rounds.draw`` cuts them:
    ``(element offset, rows, cols, row pitch)`` each."""
    flat = _bf16(1 << 16)
    return [flat[o : o + r * ld].view(r, ld)[:, :c] for o, r, c, ld in specs]


# two tenants' x in one flat buffer and their w, each of its own: whether
# the two x share a map
FLAT_CASES = {
    "whole-rows-apart": ([(0, 100, 64, 64), (64 * 300, 50, 64, 64)], "shared_map"),
    "not-whole-rows-apart": ([(0, 100, 64, 64), (64 * 300 + 8, 50, 64, 64)], "own_map"),
    "other-depth": ([(0, 100, 64, 64), (64 * 300, 50, 128, 128)], "own_map"),
    "other-pitch": ([(0, 100, 64, 64), (64 * 300, 50, 64, 72)], "own_map"),
    "column-slices": ([(0, 100, 64, 128), (64 * 300 + 64, 50, 64, 128)], "own_map"),
    "same-column-slices": ([(8, 100, 64, 128), (64 * 300 + 8, 50, 64, 128)],
                           "shared_map"),
    "2-bytes-off": ([(0, 100, 64, 64), (64 * 300 + 1, 50, 64, 64)], None),
}


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
@pytest.mark.parametrize("mode", ["dense", "compact"])
def test_views_of_one_flat_buffer_share_only_where_their_rows_line_up(case, mode):
    specs, want = FLAT_CASES[case]
    xs = _flat_views(specs)
    ws = [_bf16(x.shape[1], 64) for x in xs]
    feeds = _feeds(_table(xs, ws, mode), xs, ws)
    x_feeds = [f for kind, _, _, f in feeds if kind == "x"]
    if want is None:  # the view 2 bytes off is staged, the other maps alone
        assert sorted(x_feeds) == ["own_map", "staged"]
    else:
        assert x_feeds == [want, want]
    assert [f for kind, _, _, f in feeds if kind == "w"] == ["own_map", "own_map"]


@pytest.mark.parametrize("depth, want", [(128, "shared_map"), (100, "own_map")])
def test_a_stacked_w_shares_only_at_a_depth_of_whole_k_slices(depth, want):
    stack = _bf16(4, depth, 64)
    x = _bf16(300, -(-(depth + 1) // 8) * 8)  # rows 16-byte multiples apart
    xs, ws = [x[:100, :depth], x[100:, :depth]], [stack[0], stack[2]]
    feeds = _feeds(_table(xs, ws, "compact"), xs, ws)
    assert [f for kind, _, _, f in feeds if kind == "w"] == [want, want]
    assert [f for kind, _, _, f in feeds if kind == "x"] == ["shared_map"] * 2


def test_one_launch_mixes_shared_own_and_staged_operands():
    rows, stack = _bf16(500, 256), _bf16(3, 256, 192)
    off = _bf16(90 * 256 + 1)[1:].view(90, 256)
    xs = [*rows.split([200, 0, 300])[::2], _bf16(77, 256), off, _bf16(64, 256)]
    ws = [stack[0], stack[2], _bf16(256, 192), _bf16(256, 192), stack[1]]
    feeds = _feeds(_table(xs, ws, "compact"), xs, ws)
    assert Counter(f for *_, f in feeds) == {"own_map": 4, "shared_map": 5, "staged": 1}
    # a group takes one map: 2 shared + 4 own
    assert len({m for _, _, m, _ in feeds if m >= 0}) == 6


def test_a_group_takes_one_map_among_many_own_ones():
    """30 tenants of their own buffers and 20 splits of one: the splits'
    x share one map wherever their first one comes, the rest in order."""
    own = [(_bf16(10, 64), _bf16(64, 64)) for _ in range(30)]
    split = list(_bf16(200, 64).split(10))
    xs = [x for x, _ in own[:5]] + split + [x for x, _ in own[5:]]
    ws = [w for _, w in own[:5]] + [_bf16(64, 64) for _ in split] + [
        w for _, w in own[5:]]
    feeds = _feeds(_table(xs, ws, "compact"), xs, ws)
    counts = Counter(f for *_, f in feeds)
    # 10 maps for the first five tenants, one for the splits' x, then the
    # splits' w and the other tenants' operands alone until 24
    assert counts["shared_map"] == 20
    assert counts["own_map"] == pm.MAX_MAPS - 1
    assert counts["staged"] == 2 * 50 - 20 - (pm.MAX_MAPS - 1)


class _View:
    """A view at element offset ``off`` of a flat bfloat16 buffer, as the
    launcher sees it: addresses only, nothing allocated."""

    BASE = 1 << 40

    def __init__(self, off, shape):
        self.off, self.shape = off, shape

    def data_ptr(self):
        return self.BASE + 2 * self.off

    def untyped_storage(self):
        return _View(0, None)


@pytest.mark.parametrize(
    "config, own, shared, staged",
    [("table1-heavy", 351, 103, 20), ("table1-light", 56, 2, 4)],
)
def test_the_benchmark_plans_stage_only_their_misaligned_operands(
    config, own, shared, staged
):
    """The Table-1 waves as the benchmark draws them, views of one flat
    buffer: some operands share a map where their rows line up, and the
    staged ones are exactly those whose row pitch is off 16 bytes, so
    ``staged_feed_share`` reads the same in every run."""
    driver = harness.module("drivers", "gemm_rounds")
    plan = driver.waves(harness.config(config), 128)
    shapes = [[(t, k) for _, (t, k, _) in m] for m in plan]
    shapes += [[(k, n) for _, (_, k, n) in m] for m in plan]
    offsets, total = [], 0
    for row in shapes:
        offsets.append([])
        for a, b in row:
            offsets[-1].append(total)
            total += -(-(a * b) // driver.ALIGN) * driver.ALIGN
    n, feeds, misaligned = len(plan), Counter(), 0
    for w in range(n):
        xs = [_View(o, s) for o, s in zip(offsets[w], shapes[w])]
        ws = [_View(o, s) for o, s in zip(offsets[n + w], shapes[n + w])]
        wave = tuple((t, k, c) for (t, k), (_, c) in zip(shapes[w], shapes[n + w]))
        lds = tuple(k for _, k, _ in wave), tuple(c for _, _, c in wave)
        table = pm.tenant_table(wave, *lds, pm._dense_fits(wave), True, 132)
        feeds += Counter(f for *_, f in pm.operand_feeds(table, (*xs, *ws)))
        misaligned += sum(1 for t, k, c in wave if t and c and k % 8) + sum(
            1 for t, _, c in wave if t and c and c % 8)
    assert feeds == {"own_map": own, "shared_map": shared, "staged": staged}
    assert misaligned == staged


class _Library:
    """Stands in for the kernels' library: its feed counters."""

    def __init__(self):
        self.v = [0, 0, 0]

    def pm_feed_counts(self, v, reset):
        v[:] = self.v
        if reset:
            self.v = [0, 0, 0]
        return 0


@pytest.fixture
def clean_store():
    saved = tracing._store
    reset_launch_stats()
    yield
    tracing._store = saved


def test_launch_stats_read_the_launcher_s_feeds_and_reset_zeroes_them(
    clean_store, monkeypatch
):
    monkeypatch.setattr(tracing._build, "loaded", None)  # no library: zeros
    assert launch_stats()["feed"] == dict.fromkeys(tracing.FEEDS, 0)
    reset_launch_stats()
    lib = _Library()
    lib.v = [3, 120, 1]
    monkeypatch.setattr(tracing._build, "loaded", lib)
    assert launch_stats()["feed"] == {"own_map": 3, "shared_map": 120, "staged": 1}
    assert launch_stats()["feed"]["shared_map"] == 120  # a read keeps them
    reset_launch_stats()
    assert launch_stats()["feed"] == dict.fromkeys(tracing.FEEDS, 0)


def test_staged_feed_share_reads_the_launcher_s_counts(clean_store, monkeypatch):
    lib = _Library()
    lib.v = [3, 116, 1]
    monkeypatch.setattr(tracing._build, "loaded", lib)
    record = {"launches": {"dense": 2, "compact": 76}}
    assert READER.read(record) == pytest.approx(100 / 120)


@pytest.mark.parametrize("case", ["cpu-run", "no-bf16-launch", "no-counter", "no-program"])
def test_staged_feed_share_reads_nothing_without_counts(case, clean_store, monkeypatch):
    import repro_torch.kernels as K

    record = {"launches": {"dense": 1, "compact": 0}}
    if case == "cpu-run":  # launched nothing
        record = {"launches": {"dense": 0, "compact": 0}}
        monkeypatch.setattr(tracing._build, "loaded", _Library())
    elif case == "no-bf16-launch":  # float32 launches only: no operand counted
        monkeypatch.setattr(tracing._build, "loaded", _Library())
    elif case == "no-counter":  # a program whose launch_stats has no feeds
        stats = {k: v for k, v in launch_stats().items() if k != "feed"}
        monkeypatch.setattr(K, "launch_stats", lambda: stats)
    else:
        monkeypatch.delattr(K, "launch_stats")
    assert READER.read(record) is None
