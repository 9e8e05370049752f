"""The port's observability (``repro_torch.obs``) against the JAX package's
``repro.obs``.

The registry, the tracer, the exporters and the armed serve runs are host
arithmetic in both packages, so every comparison here is ``==``: registry
and tracer states after the same operations (ring drops, stride doubling,
merges included), ``Timeline.summary()``, ``render()``, and the Chrome
trace and CSV bytes.  The golden's obs section
(``tests/data/resilience_golden.json``, written by
``python tests/test_torch_chaos.py --write-golden``) is regenerated from the
JAX package here and the port is checked against it.
"""

import dataclasses
import json
import os
import random
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C
import repro
import repro.api
import repro.chaos
import repro.obs as JB
import repro.obs.export as JE
import repro.obs.render as JR
import repro.overload
import repro.traffic
import repro_torch
import repro_torch.api
import repro_torch.chaos
import repro_torch.obs as PB
import repro_torch.obs.export as PE
import repro_torch.obs.render as PR
import repro_torch.overload
import repro_torch.traffic

GOLDEN = os.path.join(ROOT, C.RESILIENCE_GOLDEN)
PKGS = (("jax", repro), ("port", repro_torch))


def _records(res):
    return [dataclasses.astuple(r) for r in res.records]


def _same(a, b):
    assert json.dumps(b.as_dict()) == json.dumps(a.as_dict())
    assert _records(b) == _records(a)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def _fill(B, seed, max_samples=16):
    """The same operations on one registry: every instrument type, a
    series driven well past its cap (stride doubling)."""
    rng = random.Random(seed)
    reg = B.MetricsRegistry(max_samples)
    for i in range(300):
        t = i * 1e-4 + rng.random() * 1e-5
        reg.counter(f"c{i % 3}").inc(rng.randrange(4))
        reg.gauge(f"g{i % 2}").set(rng.random())
        reg.histogram("h").observe(rng.gauss(0.0, 1.0))
        reg.series(f"s{i % 4}").sample(t, rng.random())
        if i % 7 == 0:
            reg.series("sparse").sample(t, float(i))
    return reg


@pytest.mark.parametrize("max_samples", [2, 16, 4096])
@pytest.mark.parametrize("seed", [0, 5])
def test_registry_state_and_summary(seed, max_samples):
    mine, theirs = _fill(PB, seed, max_samples), _fill(JB, seed, max_samples)
    assert mine.state() == theirs.state()
    assert json.dumps(mine.as_dict()) == json.dumps(theirs.as_dict())
    assert PE.timeline_csv(mine) == JE.timeline_csv(theirs)
    assert PR.render_summary(mine) == JR.render_summary(theirs)
    if max_samples == 16:
        assert mine.series("s0").stride > 1


def test_registry_merge():
    def merged(B):
        reg = _fill(B, 1)
        for seed in (2, 3):
            reg.merge(_fill(B, seed).state())
        reg.merge(B.MetricsRegistry().state())
        return reg

    mine, theirs = merged(PB), merged(JB)
    assert mine.state() == theirs.state()
    assert json.dumps(mine.as_dict()) == json.dumps(theirs.as_dict())


def test_series_and_histogram_edges():
    for B in (JB, PB):
        with pytest.raises(ValueError, match="max_samples must be >= 2"):
            B.Series(1)
    got = [
        (B.Series().summary(), B.Histogram().as_dict(), B.Series(4).mean)
        for B in (JB, PB)
    ]
    assert json.dumps(got[0]) == json.dumps(got[1])


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def _trace_ops(B, max_events):
    rng = random.Random(max_events)
    tr = B.Tracer(max_events)
    for i in range(200):
        t = rng.random() * 1e-2
        node = rng.randrange(3)
        tenant = rng.choice((None, "a", "b", "c"))
        if i % 3:
            tr.instant(rng.choice(("preempt", "migrate", "fault")), t, node, tenant)
        else:
            tr.span("compute", t, t + 1e-4, node, tenant, (("layer", f"l{i}"),))
    tr.attach_source(lambda: [("complete", 5e-3, 5e-3, 1, "a", ())])
    return tr


@pytest.mark.parametrize("max_events", [1, 50, 65536])
def test_tracer_ring_sources_and_absorb(max_events):
    mine, theirs = _trace_ops(PB, max_events), _trace_ops(JB, max_events)
    assert mine.state() == theirs.state()
    assert (mine.n_recorded, mine.n_dropped, len(mine)) == (
        theirs.n_recorded,
        theirs.n_dropped,
        len(theirs),
    )
    assert mine.counts_by_kind() == theirs.counts_by_kind()
    assert [dataclasses.astuple(e) for e in mine.events()] == [
        dataclasses.astuple(e) for e in theirs.events()
    ]
    for tr, B in ((mine, PB), (theirs, JB)):
        tr.absorb(_trace_ops(B, 40).state())
    assert mine.state() == theirs.state()
    assert json.dumps(PE.chrome_trace(mine)) == json.dumps(JE.chrome_trace(theirs))
    assert PR.render_summary(None, mine) == JR.render_summary(None, theirs)
    if max_events == 50:
        assert mine.n_dropped > 0


def test_observability_resolve_and_errors():
    for B in (JB, PB):
        assert B.resolve_obs(None) is None and B.resolve_obs(False) is None
        assert isinstance(B.resolve_obs(True), B.Observability)
    for build in (
        lambda B: B.resolve_obs("yes"),
        lambda B: B.Observability(sample_every=0),
        lambda B: B.Tracer(0),
        lambda B: B.Timeline(B.Observability(tracer=False)).chrome_trace(),
        lambda B: B.Timeline(B.Observability(metrics=False)).timeline_csv(),
    ):
        with pytest.raises(Exception) as theirs:
            build(JB)
        with pytest.raises(Exception) as mine:
            build(PB)
        assert type(mine.value).__name__ == type(theirs.value).__name__
        assert str(mine.value) == str(theirs.value)
    assert set(PB.__all__) == set(JB.__all__)
    assert repro_torch.Observability is PB.Observability


def _clear(pkg):
    C.clear_cost_caches(pkg)
    ops = __import__(f"{pkg}.kernels.ops", fromlist=["autotune_blocks"])
    ops.autotune_blocks.cache_clear()


def test_snapshot_host_caches_reads_the_ports_caches():
    """The port reads its own cost and autotune caches with no fallback;
    after the same calls from clear caches both packages count the same."""
    counts = {}
    for pkg in ("repro", "repro_torch"):
        _clear(pkg)
        ops = __import__(f"{pkg}.kernels.ops", fromlist=["autotune_blocks"])
        shapes = ((64, 64, 64), (300, 147, 99))
        for _ in range(3):
            ops.autotune_blocks(shapes, "float32", "float32")
        mod = __import__(f"{pkg}.obs.render", fromlist=["snapshot_host_caches"])
        api = __import__(f"{pkg}.api", fromlist=["Session"])
        api.Session("equal").run("light")
        reg = mod.snapshot_host_caches()
        counts[pkg] = {k: c.value for k, c in reg.counters.items()}
    assert counts["repro_torch"] == counts["repro"]
    assert counts["repro_torch"]["kernel.autotune.hits"] == 2
    assert counts["repro_torch"]["kernel.autotune.misses"] == 1


# ---------------------------------------------------------------------------
# armed serve runs
# ---------------------------------------------------------------------------

ARR = dict(rate=8000.0, horizon=0.02, pool="heavy", slo_s=0.004, tiers=(0, 1))
OBS = {
    "default": lambda B: True,
    "audit": lambda B: B.Observability(audit=True, sample_every=1),
    "small_ring": lambda B: B.Observability(max_events=300, max_samples=8),
    "tracer_only": lambda B: B.Observability(metrics=False),
    "metrics_only": lambda B: B.Observability(tracer=False, sample_every=3),
}


def _armed(pkg, obs_case, **kw):
    C.clear_cost_caches(pkg.__name__)
    return pkg.traffic.TrafficSimulator(
        "mmpp",
        policy="deadline_preempt",
        n_arrays=3,
        dispatch="jsq",
        max_concurrent=4,
        queue_cap=8,
        preemption=True,
        rebalance_interval=1e-3,
        fairness=True,
        obs=OBS[obs_case](pkg.obs),
        **kw,
        **ARR,
    ).run()


@pytest.mark.parametrize("keep_trace", [False, True])
@pytest.mark.parametrize("case", list(OBS))
def test_obs_armed_serve(case, keep_trace, tmp_path):
    theirs = _armed(repro, case, keep_trace=keep_trace)
    mine = _armed(repro_torch, case, keep_trace=keep_trace)
    _same(theirs, mine)
    tl, jl = mine.timeline, theirs.timeline
    assert json.dumps(tl.summary()) == json.dumps(jl.summary())
    assert tl.render() == jl.render()
    if tl.tracer is not None:
        assert json.dumps(tl.chrome_trace()) == json.dumps(jl.chrome_trace())
        paths = [tmp_path / "mine.json", tmp_path / "theirs.json"]
        tl.write_chrome_trace(str(paths[0]))
        jl.write_chrome_trace(str(paths[1]))
        assert paths[0].read_bytes() == paths[1].read_bytes()
    if tl.registry is not None:
        assert tl.timeline_csv() == jl.timeline_csv()
    # pure observation: the armed record is the unarmed one plus "obs"
    plain = dataclasses.replace(mine, timeline=None).as_dict()
    C.clear_cost_caches("repro_torch")
    off = repro_torch.traffic.TrafficSimulator(
        "mmpp",
        policy="deadline_preempt",
        n_arrays=3,
        dispatch="jsq",
        max_concurrent=4,
        queue_cap=8,
        preemption=True,
        rebalance_interval=1e-3,
        fairness=True,
        keep_trace=keep_trace,
        **ARR,
    ).run()
    assert json.dumps(plain) == json.dumps(off.as_dict())


def test_obs_with_faults_and_brownout():
    """Fault, detect, recover and brownout instants in the trace."""
    runs = {}
    for key, pkg in PKGS:
        plan = pkg.chaos.FaultPlan.seeded(
            1, horizon=0.02, n_nodes=3, crashes=1, blackouts=1, stragglers=1
        )
        brown = pkg.overload.BrownoutController(delay_target_s=5e-4, enter_after=2)
        runs[key] = _armed(pkg, "default", faults=plan, brownout=brown)
    _same(runs["jax"], runs["port"])
    trace = runs["port"].timeline.chrome_trace()
    assert json.dumps(trace) == json.dumps(runs["jax"].timeline.chrome_trace())
    kinds = {e["cat"] for e in trace["traceEvents"] if e["ph"] != "M"}
    assert {"fault", "detect", "brownout"} <= kinds


@pytest.mark.parametrize("parallel", [False, True])
@pytest.mark.parametrize("n_shards", [1, 2])
def test_sharded_obs_merges_like_jax(n_shards, parallel):
    runs = {}
    for key, pkg in PKGS:
        runs[key] = pkg.traffic.ShardedTrafficSimulator(
            "poisson",
            policy="drf",
            n_arrays=4,
            n_shards=n_shards,
            dispatch="jsq",
            sync_every=32,
            parallel=parallel and key == "port",
            preemption=True,
            obs=pkg.obs.Observability(max_events=2000, max_samples=64),
            rate=20000.0,
            horizon=0.02,
            pool="light",
            slo_s=0.004,
        ).run()
    _same(runs["jax"], runs["port"])
    tl, jl = runs["port"].timeline, runs["jax"].timeline
    assert json.dumps(tl.chrome_trace()) == json.dumps(jl.chrome_trace())
    assert tl.timeline_csv() == jl.timeline_csv()
    assert tl.render() == jl.render()


def test_session_serve_with_obs():
    theirs = repro.api.Session("equal").serve("poisson", obs=True, **ARR)
    mine = repro_torch.api.Session("equal").serve("poisson", obs=True, **ARR)
    _same(theirs, mine)
    assert "obs" in mine.as_dict()


# ---------------------------------------------------------------------------
# the card's trace cell and the overhead pair
# ---------------------------------------------------------------------------


def test_trace_cell_at_cut_size(tmp_path):
    theirs, _ = C.trace_cell("repro", jobs_per_array=12, trace_dir=tmp_path)
    mine, timing = C.trace_cell("repro_torch", jobs_per_array=12, trace_dir=tmp_path)
    assert mine == theirs
    assert mine["trace"]["spans"] > 0 and timing["bytes"] == mine["trace"]["bytes"]


def test_golden_obs_section_regenerates_from_jax(tmp_path):
    with open(GOLDEN) as f:
        golden = json.load(f)["obs"]
    theirs, _ = C.trace_cell("repro", trace_dir=tmp_path)
    mine, _ = C.trace_cell("repro_torch", trace_dir=tmp_path)
    assert C._jsonable(theirs) == golden
    assert C._jsonable(mine) == golden
    trace = golden["trace"]
    assert trace["events"] == 21420 and trace["node_tracks"] == [0, 1, 2, 3]
    assert trace["preempt_markers"] > 0 and trace["migrate_markers"] > 0


def test_overhead_pair_serializes_the_same_bytes():
    """One obs-off and one armed pass of the traffic cells, as the card's
    overhead estimator times them: the same ``as_dict()`` bytes."""
    for keep_trace in (False, True):
        _, off = C._traffic_pass("repro_torch", None, keep_trace)
        _, on = C._traffic_pass("repro_torch", PB.Observability, keep_trace)
        assert on == off
    _, theirs = C._traffic_pass("repro", None, True)
    assert off == theirs


@pytest.mark.parametrize("on_first", [False, True])
def test_overhead_pair_interleaves_parts(monkeypatch, on_first):
    """A sample pair runs the sides part by part, alternating which side
    goes first, over ``OBS_PASSES`` passes."""
    calls = []
    parts = C.traffic_parts

    def tagged(pkg, obs=None, keep_trace=False):
        side = "off" if obs is None else "on"
        return [
            lambda k=k, part=part: calls.append((side, k)) or part()
            for k, part in enumerate(parts(pkg, obs, keep_trace))
        ]

    monkeypatch.setattr(C, "OBS_PASSES", 2)
    monkeypatch.setattr(C, "traffic_parts", tagged)
    cpu = C._overhead_pair("repro_torch", PB.Observability, False, on_first)
    assert set(cpu) == {"off", "on"} and min(cpu.values()) >= 0.0
    n = len(parts("repro_torch"))
    assert len(calls) == 2 * C.OBS_PASSES * n
    pairs = [calls[j : j + 2] for j in range(0, len(calls), 2)]
    for j, ((first, k0), (second, k1)) in enumerate(pairs):
        assert k0 == k1 == j % n and {first, second} == {"off", "on"}
        assert (first == "on") == (((j // n + k0) % 2 == 0) == on_first)


def test_pass_instructions_count_the_armed_side():
    """``--obs-split``'s bytecode count: the same number for the same pass
    (no host's speed in it), more on the armed side, and the monitoring
    tool released afterwards."""
    C._traffic_pass("repro_torch", None, False)  # warm the cost caches
    off = [C._pass_instructions("repro_torch", None, False) for _ in range(2)]
    on = C._pass_instructions("repro_torch", PB.Observability, False)
    assert off[0] == off[1] and on > off[0] > 0
    assert sys.monitoring.get_tool(sys.monitoring.PROFILER_ID) is None


def test_obs_pairs_prints_the_gates_estimator(monkeypatch, capsys):
    """``--obs-pairs N``: N samples a side on each gated path, the floor
    ratio the gate reads (min armed / min off) and the median pair ratio,
    one JSON line."""
    monkeypatch.setattr(C, "OBS_PASSES", 1)
    assert C.obs_pairs(2) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"default", "spans"}
    for row in out.values():
        assert len(row["off"]) == len(row["on"]) == 2
        assert row["ratio"] == min(row["on"]) / min(row["off"])
        assert row["median_ratio"] > 0.0
