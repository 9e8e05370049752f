"""The port's dataflow, timing, energy and scheduler against the JAX package.

The same seeded inputs go through ``repro`` and ``repro_torch``; every
result must be equal with ``==`` (no tolerance): this path is host
arithmetic on Python ints and floats and NumPy int64 in both packages.
Caches that are module- or class-level (the ``ws_cost`` / ``layer_cost``
LRUs, the batch oracle's shared memos) are cleared in both packages before
each test, so no result depends on cache warmth.
"""

import dataclasses
import math
import random
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import policy as JP
from repro.core import dataflow as JD
from repro.core import dnng as JG
from repro.core import partition as JPa
from repro.core import scheduler as JS
from repro.fairness import flow as JF
from repro.sim import energy as JE
from repro.sim import systolic as JY
from repro.sim import workloads as JW
from repro_torch.api import policy as PP
from repro_torch.core import dataflow as PD
from repro_torch.core import dnng as PG
from repro_torch.core import partition as PPa
from repro_torch.core import scheduler as PS
from repro_torch.fairness import flow as PF
from repro_torch.sim import energy as PE
from repro_torch.sim import systolic as PY
from repro_torch.sim import workloads as PW

ARRAY = (128, 128)
POLICIES = JP.list_policies()


@pytest.fixture(autouse=True)
def _cold_caches():
    for mod in (JD, PD):
        mod.ws_cost_cache_clear()
        mod.ws_cost_batch_stats_clear()
    for mod in (JY, PY):
        mod.layer_cost.cache_clear()
        mod._BatchTimeOracle.clear_all()
    yield


# ---------------------------------------------------------------------------
# helpers: the same object built in both packages
# ---------------------------------------------------------------------------


_HI = (700, 6, 300, 6, 6, 40, 40, 30, 30)  # exclusive bounds of M N C R S H W P Q


def _rand_layer(rng, i=0):
    f = {k: int(rng.integers(1, hi)) for k, hi in zip("MNCRSHWPQ", _HI)}
    return f | {"name": f"l{i}"}


def _layers(fields):
    return JG.LayerShape(**fields), PG.LayerShape(**fields)


def _parts(rows, col_start, cols):
    return (
        JPa.Partition(rows=rows, col_start=col_start, cols=cols),
        PPa.Partition(rows=rows, col_start=col_start, cols=cols),
    )


def _rand_part(rng, array_cols=128):
    cols = int(rng.integers(1, array_cols + 1))
    start = int(rng.integers(0, array_cols - cols + 1))
    return _parts(int(rng.integers(1, 129)), start, cols)


def _port_layer(layer):
    fields = dataclasses.fields(layer)
    return PG.LayerShape(**{f.name: getattr(layer, f.name) for f in fields})


def _port_dnng(g):
    return PG.DNNG(
        name=g.name,
        layers=tuple(_port_layer(la) for la in g.layers),
        arrival_time=g.arrival_time,
        edges=g.edges,
    )


def _trace(res):
    """Everything a schedule result holds, partitions as plain tuples."""
    ev = tuple(
        (
            e.tenant,
            e.layer_index,
            e.layer_name,
            e.partition.rows,
            e.partition.col_start,
            e.partition.cols,
            e.start,
            e.end,
            e.compute_start,
            e.compute_end,
            e.fraction,
            e.resumed,
            e.preempted,
        )
        for e in res.trace
    )
    return (
        ev,
        res.completion,
        res.makespan,
        res.busy_pe_seconds,
        res.preemptions,
        res.bus_stall_s,
        (res.array.rows, res.array.cols),
    )


def _assert_python_floats(res):
    """No NumPy scalar leaks into the port's trace: every time is a float."""
    for e in res.trace:
        for v in (e.start, e.end, e.compute_start, e.compute_end, e.fraction):
            assert type(v) is float
    assert type(res.makespan) is float
    assert all(type(v) is float for v in res.completion.values())


def _oracles():
    return JY.layer_time_fn(JY.SystolicConfig()), PY.layer_time_fn(PY.SystolicConfig())


# ---------------------------------------------------------------------------
# core.dnng
# ---------------------------------------------------------------------------


class TestDNNG:
    @pytest.mark.parametrize("seed", range(3))
    def test_layer_properties(self, seed):
        rng = np.random.default_rng(seed)
        for i in range(50):
            j, p = _layers(_rand_layer(rng, i))
            for attr in (
                "opr",
                "macs",
                "gemm_k",
                "gemm_n",
                "gemm_m",
                "weight_bytes",
                "ifmap_elems",
                "ofmap_elems",
            ):
                assert getattr(p, attr) == getattr(j, attr), attr

    def test_memoized_hash_keeps_equality(self):
        a = PG.LayerShape.fc("x", 64, 128, batch=4)
        b = PG.LayerShape.fc("x", 64, 128, batch=4)
        assert hash(a) == hash(b) and a == b
        assert a.opr == b.opr  # memoizing opr must not break equality
        assert a == b and {a: 1}[b] == 1
        assert a != PG.LayerShape.fc("y", 64, 128, batch=4)
        assert PP.TenantDemand("t", layer=a) == PP.TenantDemand("t", layer=b)

    @pytest.mark.parametrize(
        "edges", [None, ((0, 1), (0, 2), (1, 3), (2, 3)), ((0, 2), (1, 2))]
    )
    def test_graph_queries(self, edges):
        rng = np.random.default_rng(7)
        fields = [_rand_layer(rng, i) for i in range(4)]
        j = JG.DNNG("g", tuple(JG.LayerShape(**f) for f in fields), 1e-6, edges)
        p = PG.DNNG("g", tuple(PG.LayerShape(**f) for f in fields), 1e-6, edges)
        assert p.edge_list == j.edge_list
        assert p.pred_table == j.pred_table
        for i in range(4):
            assert p.predecessors(i) == j.predecessors(i)
            assert p.successors(i) == j.successors(i)
        assert p.roots() == j.roots()
        assert (p.total_macs, p.total_opr) == (j.total_macs, j.total_opr)
        assert len(p) == len(j) == 4
        assert PG.validate_dag(p) == JG.validate_dag(j)
        assert PG.estimated_execution_time(p, 16384) == JG.estimated_execution_time(
            j, 16384
        )
        c = p.clone(name="h", arrival_time=2.0)
        assert (c.name, c.arrival_time) == ("h", 2.0)
        assert c.layers is p.layers and c.edges == edges

    def test_graph_validation_matches(self):
        la = PG.LayerShape.fc("a", 4, 4)
        for bad in (((0, 2),), ((1, 0),)):
            with pytest.raises(ValueError):
                PG.DNNG("g", (la, la), edges=bad)
            with pytest.raises(ValueError):
                JG.DNNG("g", (JG.LayerShape.fc("a", 4, 4),) * 2, edges=bad)
        with pytest.raises(ValueError, match="positive"):
            PG.estimated_execution_time(PG.chain("g", [la]), 0)


# ---------------------------------------------------------------------------
# core.partition: Task_Assignment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_task_assignment_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(30):
        n_ready, n_parts = int(rng.integers(1, 6)), int(rng.integers(1, 6))
        fields = [_rand_layer(rng, i) for i in range(n_ready)]
        widths = rng.integers(1, 40, n_parts)
        starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
        jr = [(f"t{i}", i, JG.LayerShape(**f)) for i, f in enumerate(fields)]
        pr = [(f"t{i}", i, PG.LayerShape(**f)) for i, f in enumerate(fields)]
        jp = [JPa.Partition(128, int(s), int(w)) for s, w in zip(starts, widths)]
        pp = [PPa.Partition(128, int(s), int(w)) for s, w in zip(starts, widths)]
        got = [
            (a.tenant, a.layer_index, a.partition.col_start, a.partition.cols)
            for a in PPa.task_assignment(pr, pp)
        ]
        want = [
            (a.tenant, a.layer_index, a.partition.col_start, a.partition.cols)
            for a in JPa.task_assignment(jr, jp)
        ]
        assert got == want


def test_busy_view_is_live():
    ps = PPa.PartitionSet(PPa.ArrayShape(128, 128))
    view = ps.busy_view()
    got = ps.allocate("a", 32)
    assert view == {"a": got} and ps.busy_partitions == view
    ps.free("a")
    assert view == {}


# ---------------------------------------------------------------------------
# core.dataflow: scalar vs batch vs JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_shares", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_ws_cost_scalar_batch_and_jax_agree(seed, with_shares):
    rng = np.random.default_rng(seed)
    n = 200
    jg, pg, jpart, ppart = [], [], [], []
    for _ in range(n):
        t, k, nn = (int(v) for v in rng.integers(1, 5000, 3))
        jg.append(JD.GEMM(t, k, nn))
        pg.append(PD.GEMM(t, k, nn))
        a, b = _rand_part(rng)
        jpart.append(a)
        ppart.append(b)
    shares = rng.uniform(0.05, 1.0, n) if with_shares else None
    if with_shares:
        shares[::7] = 1.0
    pb = PD.ws_cost_batch(pg, ppart, bw_shares=shares)
    jb = JD.ws_cost_batch(jg, jpart, bw_shares=shares)
    packed = PD.ws_cost_batch(PD.pack_gemms(pg), PD.pack_partitions(ppart), shares)
    for f in dataclasses.fields(PD.BatchCost):
        a, b, c = (getattr(x, f.name) for x in (pb, jb, packed))
        if a is None:
            assert b is None and c is None and not with_shares
            continue
        assert a.dtype == b.dtype and np.array_equal(a, b) and np.array_equal(a, c)
    if with_shares:
        assert np.all(pb.dram_stall_elems[::7] == 0.0)
    for i in range(n):
        scalar = PD.ws_cost(pg[i], ppart[i])
        theirs = JD.ws_cost(jg[i], jpart[i])
        assert dataclasses.astuple(scalar) == dataclasses.astuple(theirs)
        assert pb.row(i) == scalar
        assert PD.utilization(pg[i], ppart[i]) == JD.utilization(jg[i], jpart[i])
    assert PD.ws_cost_batch_stats() == {"calls": 2, "pairs": 2 * n}
    assert len(pb) == n


def test_ws_cost_cache_stats_and_validation():
    g, p = PD.GEMM(8, 8, 8), PPa.Partition(128, 0, 16)
    PD.ws_cost(g, p)
    PD.ws_cost(g, p)
    stats = PD.ws_cost_cache_stats()
    assert (stats["hits"], stats["misses"], stats["currsize"]) == (1, 1, 1)
    # the port's LRU is its own: the JAX package's is untouched
    assert JD.ws_cost_cache_stats()["currsize"] == 0
    with pytest.raises(ValueError, match="matching shapes"):
        PD.ws_cost_batch([g, g], [p])
    for bad in ([0.0], [1.5]):
        with pytest.raises(ValueError, match="bw_shares"):
            PD.ws_cost_batch([g], [p], bw_shares=bad)
    with pytest.raises(ValueError, match="one share per pair"):
        PD.ws_cost_batch([g], [p], bw_shares=[0.5, 0.5])


def test_loopnest_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        t, k, n = (int(v) for v in rng.integers(1, 400, 3))
        jp, pp = _rand_part(rng)
        j = JD.partitioned_ws_loopnest(JD.GEMM(t, k, n), jp)
        p = PD.partitioned_ws_loopnest(PD.GEMM(t, k, n), pp)
        assert (p.load, p.feed, p.drain) == (j.load, j.feed, j.drain)


# ---------------------------------------------------------------------------
# sim.systolic: layer_time_fn and the batch oracle's two paths
# ---------------------------------------------------------------------------


def _distinct_pairs(n, seed):
    rng = np.random.default_rng(seed)
    jpairs, ppairs = [], []
    for i in range(n):
        jl, pl = _layers(_rand_layer(rng, i))
        jp, pp = _rand_part(rng)
        jpairs.append((jl, jp))
        ppairs.append((pl, pp))
    return jpairs, ppairs


@pytest.mark.parametrize("n_missing", [1, 31, 32, 33, 200])
def test_batch_oracle_paths_match_scalar_and_jax(n_missing):
    """Below ``VECTOR_THRESHOLD`` missing pairs the oracle walks the scalar
    LRU; at and above it, one NumPy pass.  Both give the same floats."""
    assert PY._BatchTimeOracle.VECTOR_THRESHOLD == 32
    jpairs, ppairs = _distinct_pairs(n_missing, seed=n_missing)
    jfn, pfn = _oracles()
    before = PD.ws_cost_batch_stats()["calls"]
    got = pfn.batch(ppairs + ppairs[:3])  # repeats inside one call
    vectorized = PD.ws_cost_batch_stats()["calls"] - before
    assert vectorized == (1 if n_missing >= 32 else 0)
    assert got == jfn.batch(jpairs + jpairs[:3])
    assert got == [pfn(la, p) for la, p in ppairs + ppairs[:3]]
    assert all(type(v) is float for v in got)
    repeats = min(3, n_missing)
    stats = pfn.batch.stats()
    assert stats["misses"] == n_missing and stats["hits"] == repeats
    # a second call is served from the memo
    assert pfn.batch(ppairs) == got[:n_missing]
    assert pfn.batch.stats()["hits"] == repeats + n_missing


def test_batch_oracle_memo_bound(monkeypatch):
    monkeypatch.setattr(PY._BatchTimeOracle, "MAX_ENTRIES", 40)
    _, ppairs = _distinct_pairs(60, seed=11)
    fn = PY.layer_time_fn(PY.SystolicConfig())
    first = fn.batch(ppairs[:30])
    assert fn.batch(ppairs[:30] + ppairs[30:]) == first + [
        fn(la, p) for la, p in ppairs[30:]
    ]
    assert fn.batch.stats()["currsize"] <= 60


@pytest.mark.parametrize("seed", range(3))
def test_layer_time_fn_and_layer_cost_batch(seed):
    jpairs, ppairs = _distinct_pairs(80, seed=100 + seed)
    jfn, pfn = _oracles()
    assert [pfn(*p) for p in ppairs] == [jfn(*p) for p in jpairs]
    pb = PY.layer_cost_batch([la for la, _ in ppairs], [p for _, p in ppairs])
    jb = JY.layer_cost_batch([la for la, _ in jpairs], [p for _, p in jpairs])
    assert np.array_equal(pb.cycles, jb.cycles)
    cycles = [PY.layer_cycles(*p) for p in ppairs]
    assert cycles == [JY.layer_cycles(*p) for p in jpairs]
    cfg = PY.SystolicConfig()
    assert (cfg.array.rows, cfg.array.cols, cfg.macs_per_cycle) == (128, 128, 16384)


# ---------------------------------------------------------------------------
# core.scheduler, driven incrementally
# ---------------------------------------------------------------------------

# one namespace per package, so a helper can build the same run in either
JAX = types.SimpleNamespace(S=JS, G=JG, A=JPa, Y=JY, E=JE)
PORT = types.SimpleNamespace(S=PS, G=PG, A=PPa, Y=PY, E=PE)


def _fc_chain(pkg, name, n_layers, size=256, arrival=0.0):
    fc = pkg.G.LayerShape.fc
    layers = [fc(f"l{i}", size, size, batch=size) for i in range(n_layers)]
    return pkg.G.chain(name, layers, arrival_time=arrival)


def _scheduler(pkg, policy="paper", stage=True, **kw):
    fn = pkg.Y.layer_time_fn(pkg.Y.SystolicConfig())
    stage = pkg.S.StageModel() if stage else None
    return pkg.S.DynamicScheduler(pkg.A.ArrayShape(*ARRAY), fn, stage, policy, **kw)


def _drive(pkg, policy, script, **kw):
    """Run one incremental script (submit / run_until / withdraw) on one
    package's DynamicScheduler; return its result and the call log."""
    done = []
    sched = _scheduler(
        pkg,
        policy,
        on_complete=lambda n, t: done.append((n, t)),
        check_invariants=True,
        **kw,
    )
    log = []
    for op, *args in script:
        if op == "submit":
            name, n_layers, size, arrival, deadline, tier = args
            g = _fc_chain(pkg, name, n_layers, size, arrival)
            sched.submit(g, deadline=deadline, tier=tier)
        elif op == "run_until":
            sched.run_until(args[0])
            inflight = sched.inflight_allocations().items()
            log.append(
                (
                    sched.now,
                    sched.n_active,
                    sched.pending(),
                    sched.next_event_time(),
                    sorted(sched.progress().items()),
                    sorted((n, la.name, p.cols) for n, (la, p) in inflight),
                )
            )
        elif op == "withdraw":
            log.append(sched.withdraw(args[0]))
    sched.run()
    log.append((sched.n_events, sched.n_completed, sched.n_preemptions, done))
    return sched.result(), log


def _script(rng, n_jobs, with_deadlines, tiers):
    """A seeded arrival script.  With deadlines, the first two jobs are long
    (4096-wide layers, no deadline) and later ones short with tight
    deadlines, so ``deadline_preempt`` has victims to evict."""
    script, t = [], 0.0
    for i in range(n_jobs):
        t += float(rng.exponential(2e-5))
        size = int(rng.choice([64, 256, 1024, 2048]))
        deadline = None
        if with_deadlines and i < 2:
            size = 4096
        elif with_deadlines:
            size = int(rng.choice([64, 256]))
            deadline = t + float(rng.uniform(2e-5, 3e-4))
        tier = int(rng.integers(0, 2)) if tiers else 0
        n_layers = int(rng.integers(1, 4))
        script.append(("submit", f"j{i}", n_layers, size, t, deadline, tier))
        if rng.random() < 0.5:
            script.append(("run_until", t + float(rng.uniform(0, 3e-5))))
            t = max(t, script[-1][1])
        if rng.random() < 0.2:
            script.append(("withdraw", f"j{int(rng.integers(0, i + 1))}"))
    return script


def _armed(kind):
    """(policy, scheduler kwargs builder) of a run kind."""
    if kind == "preempted":
        return "deadline_preempt", lambda pkg: {"preemption": pkg.S.PreemptionModel()}
    if kind == "contended":
        return "moca", lambda pkg: {"contention": pkg.S.ContentionModel(1e-5, 0.25)}
    return "equal", lambda pkg: {}


@pytest.mark.parametrize("seed", range(4))
def test_incremental_scheduler_with_preemption(seed):
    """Submit/run_until/withdraw under ``deadline_preempt`` with a
    ``PreemptionModel`` armed: same trace, segments and counters."""
    script = _script(np.random.default_rng(seed), 10, with_deadlines=True, tiers=False)
    policy, arm = _armed("preempted")
    jres, jlog = _drive(JAX, policy, script, **arm(JAX))
    pres, plog = _drive(PORT, policy, script, **arm(PORT))
    assert pres.preemptions > 0
    assert _trace(pres) == _trace(jres)
    assert plog == jlog
    _assert_python_floats(pres)


def test_preemption_fires_and_segments_match():
    def run(pkg):
        sched = _scheduler(pkg, "deadline_preempt", preemption=pkg.S.PreemptionModel())
        fc = pkg.G.LayerShape.fc
        sched.submit(pkg.G.chain("big", [fc("l0", 4096, 4096, batch=4096)]))
        small = pkg.G.chain("small", [fc("s0", 64, 64, batch=32)], 1e-4)
        sched.submit(small, deadline=3e-4)
        sched.run()
        return sched.result()

    pres, jres = run(PORT), run(JAX)
    assert pres.preemptions == 1
    assert _trace(pres) == _trace(jres)
    assert [e.preempted for e in pres.trace if e.tenant == "big"] == [True, False]


@pytest.mark.parametrize("seed", range(3))
def test_incremental_scheduler_with_contention_under_moca(seed):
    """A ``ContentionModel`` armed under ``moca`` with a tier mix: the caps,
    the stretched transfers and ``bus_stall_s`` match."""
    script = _script(np.random.default_rng(10 + seed), 8, False, tiers=True)
    policy, arm = _armed("contended")
    jres, jlog = _drive(JAX, policy, script, **arm(JAX))
    pres, plog = _drive(PORT, policy, script, **arm(PORT))
    assert pres.bus_stall_s > 0.0
    assert _trace(pres) == _trace(jres)
    assert plog == jlog


def test_shared_bandwidth_and_memory_system_match():
    c = dict(window_s=1e-4, capacity=0.5, alpha=1.5, beta=2.0)
    jb = JS.MemorySystem(contention=JS.ContentionModel(**c))
    pb = PS.MemorySystem(contention=PS.ContentionModel(**c))
    for bus in (jb, pb):
        bus.set_caps({"b": 0.25})
    rng = np.random.default_rng(5)
    for _ in range(40):
        now, dur = float(rng.uniform(0, 1e-3)), float(rng.uniform(1e-6, 1e-4))
        tenant = str(rng.choice(["a", "b"]))
        assert pb.acquire(now, dur, tenant) == jb.acquire(now, dur, tenant)
    assert (pb.free_at, pb.busy_s, pb.stall_s) == (jb.free_at, jb.busy_s, jb.stall_s)
    assert pb.shared.peak_pressure == jb.shared.peak_pressure
    pb.abort_reservation(0.0, pb.free_at - 1e-6, pb.free_at)
    jb.abort_reservation(0.0, jb.free_at - 1e-6, jb.free_at)
    assert (pb.free_at, pb.busy_s) == (jb.free_at, jb.busy_s)


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_scheduler_rejections_match(pkg):
    sched = _scheduler(pkg, stage=False)
    sched.submit(_fc_chain(pkg, "a", 1, arrival=1.0))
    with pytest.raises(ValueError, match="duplicate"):
        sched.submit(_fc_chain(pkg, "a", 1, arrival=1.0))
    sched.run_until(2.0)
    with pytest.raises(ValueError, match="in the past"):
        sched.submit(_fc_chain(pkg, "b", 1, arrival=0.5))
    with pytest.raises(ValueError, match="batch_demand_scale"):
        sched.set_batch_demand_scale(0.0)
    with pytest.raises(ValueError, match="duplicate DNNG names"):
        twice = [_fc_chain(pkg, "x", 1)] * 2
        pkg.S.schedule_dynamic(twice, sched.array, sched.time_fn)


@pytest.mark.parametrize("policy", POLICIES)
def test_batch_demand_scale_matches(policy):
    def run(pkg):
        sched = _scheduler(pkg, policy)
        for i in range(4):
            g = _fc_chain(pkg, f"t{i}", 2, size=512 + 256 * i, arrival=i * 1e-6)
            sched.submit(g, tier=i % 2)
        sched.set_batch_demand_scale(0.5)
        sched.run()
        return sched.result()

    assert _trace(run(PORT)) == _trace(run(JAX))


# ---------------------------------------------------------------------------
# sample_dnng workloads, scheduled under every policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool", ["heavy", "light", "all"])
@pytest.mark.parametrize("seed", range(3))
def test_sampled_workloads_schedule_identically(seed, pool):
    jrng, prng = np.random.default_rng(seed), np.random.default_rng(seed)
    jd, pd = [], []
    for i in range(6):
        t = i * 3e-6
        jd.append(JW.sample_dnng(jrng, pool, name=f"job{i}", arrival_time=t))
        pd.append(PW.sample_dnng(prng, pool, name=f"job{i}", arrival_time=t))
    assert [_port_dnng(g) for g in jd] == pd
    jfn, pfn = _oracles()
    jarr, parr = JPa.ArrayShape(*ARRAY), PPa.ArrayShape(*ARRAY)
    for policy in POLICIES:
        j = JS.schedule_dynamic(jd, jarr, jfn, stage=JS.StageModel(), policy=policy)
        p = PS.schedule_dynamic(pd, parr, pfn, stage=PS.StageModel(), policy=policy)
        assert _trace(p) == _trace(j), policy
    js = JS.schedule_sequential(jd, jarr, jfn, stage=JS.StageModel())
    ps = PS.schedule_sequential(pd, parr, pfn, stage=PS.StageModel())
    assert _trace(ps) == _trace(js)
    assert ps.utilization == js.utilization


def test_sample_dnng_with_random_random_and_rejection():
    jg = JW.sample_dnng(random.Random(4), "light", name="x", arrival_time=1.0)
    pg = PW.sample_dnng(random.Random(4), "light", name="x", arrival_time=1.0)
    assert _port_dnng(jg) == pg
    assert sorted(PW.MODELS) == sorted(JW.MODELS)
    assert PW.MODEL_POOLS == JW.MODEL_POOLS
    assert sorted(PW.WORKLOADS) == sorted(JW.WORKLOADS)
    with pytest.raises(ValueError, match="unknown pool"):
        PW.sample_dnng(random.Random(0), "nonesuch")


def test_model_templates_are_shared():
    a = PW.sample_dnng(random.Random(1), "heavy", name="a")
    b = PW.sample_dnng(random.Random(1), "heavy", name="b")
    assert a.layers is b.layers and (a.name, b.name) == ("a", "b")


# ---------------------------------------------------------------------------
# sim.energy
# ---------------------------------------------------------------------------


def _script_layers(pkg, script):
    """(tenant, layer index) -> LayerShape of every job a script submits."""
    out = {}
    for op, *args in script:
        if op == "submit":
            name, n_layers, size = args[:3]
            for i, layer in enumerate(_fc_chain(pkg, name, n_layers, size).layers):
                out[(name, i)] = layer
    return out


@pytest.mark.parametrize("baseline_pe", [False, True])
@pytest.mark.parametrize("kind", ["plain", "preempted", "contended"])
def test_schedule_energy_with_layers_matches(kind, baseline_pe):
    """The books agree on plain traces (identity scale), on preempted
    segments (fraction-scaled counts + drain/re-stage) and under memory
    contention (stall energy), for both PE designs."""
    script = _script(np.random.default_rng(21), 8, kind == "preempted", tiers=True)
    policy, arm = _armed(kind)
    books = []
    for pkg in (JAX, PORT):
        res, _ = _drive(pkg, policy, script, **arm(pkg))
        if kind == "preempted":
            assert any(e.fraction != 1.0 for e in res.trace)
        if kind == "contended":
            assert res.bus_stall_s > 0.0
        books.append(
            pkg.E.schedule_energy_with_layers(
                res,
                _script_layers(pkg, script),
                pkg.Y.SystolicConfig(),
                pkg.E.EnergyModel(),
                baseline_pe,
            )
        )
    j, p = books
    assert p.as_dict() == j.as_dict()
    assert p.dynamic == j.dynamic
    assert all(type(v) is float for v in p.as_dict().values())


def test_energy_model_constants_match():
    assert dataclasses.asdict(PE.EnergyModel()) == dataclasses.asdict(JE.EnergyModel())
    array = (128, 128)
    mine = PE.EnergyModel().leak_power(PPa.ArrayShape(*array))
    assert mine == JE.EnergyModel().leak_power(JPa.ArrayShape(*array))


# ---------------------------------------------------------------------------
# fairness.flow: the matching itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_min_cost_assignment_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n, m = int(rng.integers(0, 6)), int(rng.integers(1, 6))
        costs = rng.uniform(0, 10, (n, m)).round(2).tolist()
        for row in costs:
            for j in range(m):
                if rng.random() < 0.2:
                    row[j] = math.inf
        assert PF.min_cost_assignment(costs) == JF.min_cost_assignment(costs)


def test_experiment_result_alias():
    import repro.sim as JSim
    import repro_torch.sim as PSim
    from repro_torch.api.session import SessionResult
    from repro_torch.sim import ExperimentResult

    assert ExperimentResult is SessionResult
    assert "ExperimentResult" in PSim.__all__
    assert PSim.__all__ == JSim.__all__
