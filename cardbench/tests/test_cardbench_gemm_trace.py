"""The program's own spans and counters beside the benchmark's: a traced
window reads the same with the program's ``repro_torch.gemm.*`` spans in
it, and ``tile_efficiency`` reads the program's launch counters, nothing
where there is nothing to read."""

import json

import pytest

from cardbench import harness
from cardbench import trace as tracing
from cardbench.tests._tiny import run_on_cpu, tiny_root

BENCH = harness.benchmark()
READER = harness.module("metrics", "tile_efficiency")


class _Prof:
    """Stands in for a profiler: exports the given chrome-trace events."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _events(program_spans: bool) -> list:
    """One round of two waves and a wait; three kernels, the first gap
    while the host is in wave 1 (inside its program's prepare span), the
    others while it waits."""
    ev = [
        _x("cardbench.round", "user_annotation", 0, 1000),
        _x("cardbench.wave0", "user_annotation", 0, 100),
        _x("cardbench.wave1", "user_annotation", 100, 100),
        _x("cardbench.wait", "user_annotation", 200, 800),
        _x("compact_kernel<bf16>", "kernel", 50, 70),
        _x("compact_kernel<bf16>", "kernel", 160, 240),
        _x("dense_kernel<bf16>", "kernel", 450, 450),
    ]
    if program_spans:
        for w, t0 in ((0, 0), (1, 100)):
            for i, phase in enumerate(("prepare", "alloc", "table", "launch")):
                ev.append(_x(f"repro_torch.gemm.{phase}", "user_annotation",
                             t0 + 25 * i, 25))
    return ev


def test_program_spans_leave_every_traced_number_as_it_was(tmp_path):
    without = tracing.read(_Prof(_events(False)), tmp_path / "a.json")
    with_spans = tracing.read(_Prof(_events(True)), tmp_path / "b.json")
    assert with_spans == without
    assert without["window_s"] == pytest.approx(950e-6)
    assert without["busy_s"] == pytest.approx(760e-6)
    assert without["idle_gaps"] == [
        ["wait", pytest.approx(100e-6)],
        ["wait", pytest.approx(50e-6)],
        ["wave1", pytest.approx(40e-6)],
    ]
    record = {"peak_flops": 1e12, "trace": {**without, "flops": 1e6}}
    for m in harness.metrics_for(BENCH, "heavy-b128", True):
        if m["source"] == "device_trace":
            read = harness.module("metrics", m["name"]).read
            rec_with = {**record, "trace": {**with_spans, "flops": 1e6}}
            assert read(rec_with) == read(record)


def test_tile_efficiency_reads_nothing_on_a_cpu_run(tmp_path):
    root, bench, cell = tiny_root(tmp_path)
    res, rec = run_on_cpu(root, bench, cell, trace=True)
    assert READER.read(rec) is None
    assert "tile_efficiency" not in res["metrics"]


@pytest.fixture
def store():
    kernels = pytest.importorskip("repro_torch.kernels")
    saved = kernels.tracing._store
    kernels.reset_launch_stats()
    yield kernels
    kernels.tracing._store = saved


def test_tile_efficiency_reads_the_programs_counters(store):
    table = store.tenant_table(((100, 40, 70), (64, 8, 64)), (40, 8), (70, 64), False)
    store.tracing.watch(table.counts[True], [0, 1], 1)  # one bf16 launch
    record = {"launches": {"dense": 0, "compact": 1}}
    useful = 100 * 40 * 70 + 64 * 8 * 64
    issued = 4096 * (4 * 64 + 32)
    assert READER.read(record) == pytest.approx(100 * useful / issued)
    assert READER.read({"launches": {"dense": 0, "compact": 0}}) is None


def test_tile_efficiency_reads_nothing_from_a_program_without_counters(
    store, monkeypatch
):
    monkeypatch.delattr(store, "launch_stats")
    assert READER.read({"launches": {"dense": 1, "compact": 0}}) is None
