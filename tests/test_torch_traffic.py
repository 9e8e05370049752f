"""The port's open-loop serving path against the JAX package's.

``repro_torch.traffic`` (arrivals, dispatch, migration, sharded pods,
metrics), ``repro_torch.fairness.accounting``, ``repro_torch.api.config``
and ``Session.serve`` are host arithmetic in both packages, so every
comparison here is ``==``: job lists, dispatch choices, records, depth
samples, trace events, ``json.dumps(as_dict())``, and error types and texts.

``tests/data/serve_golden.json`` holds every seeded field of the card's
``serve`` phase (``chip_smoke.py``), made from the JAX package:

    python tests/test_torch_traffic.py --write-golden

(the 10,000-job scale cell and the 100,000-job sharded cell included, run
serially, which gives the same result as forked pods).  The tests below
regenerate its small sections from the JAX package and check the port
against all of them.
"""

import dataclasses
import json
import os
import random
import sys
import types

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C
import repro.api as JA
import repro.fairness as JF
import repro.traffic as JT
import repro.traffic.cluster as JC
import repro.traffic.sharded as JSH
import repro.traffic.simulator as JSIM
import repro_torch
import repro_torch.api as PA
import repro_torch.fairness as PF
import repro_torch.traffic as PT
import repro_torch.traffic.cluster as PC
import repro_torch.traffic.sharded as PSH
import repro_torch.traffic.simulator as PSIM

GOLDEN = os.path.join(ROOT, C.SERVE_GOLDEN)
SMALL = ("traffic", "cluster", "armed")
POLICIES = JA.list_policies()


def _jobs(arrivals):
    return [dataclasses.astuple(j) for j in arrivals]


def _records(res):
    return [dataclasses.astuple(r) for r in res.records]


def _dump(res):
    return json.dumps(res.as_dict())


def _trace(res):
    return [
        [
            (e.tenant, e.layer_index, e.layer_name, e.partition.col_start)
            + (e.partition.cols, e.start, e.end, e.compute_start, e.compute_end)
            + (e.fraction, e.resumed, e.preempted)
            for e in s.trace
        ]
        for s in res.schedules
    ]


@pytest.fixture
def depth(monkeypatch):
    """The per-arrival queue-depth samples and busy PE-seconds each run
    hands ``summarize``, per package (spied on the simulators' modules)."""
    seen = {"jax": [], "port": []}

    def spy(pkg, real):
        def summarize(records, **kw):
            seen[pkg].append(
                (list(kw.get("queue_depth_samples", ())), kw.get("pe_seconds_busy"))
            )
            return real(records, **kw)

        return summarize

    for mod, pkg in ((JSIM, "jax"), (JSH, "jax"), (PSIM, "port"), (PSH, "port")):
        monkeypatch.setattr(mod, "summarize", spy(pkg, mod.summarize))
    return seen


def _fields(obj):
    """Every field of a dataclass, NaN included (``nan != nan``)."""
    return json.dumps(dataclasses.asdict(obj))


def _same(jax_res, port_res):
    assert _dump(port_res) == _dump(jax_res)
    assert _records(port_res) == _records(jax_res)
    assert _fields(port_res.metrics) == _fields(jax_res.metrics)


# ---------------------------------------------------------------------------
# arrivals
# ---------------------------------------------------------------------------

ARRIVAL_CASES = [
    ("poisson", dict(rate=2000.0, horizon=0.05, pool="light")),
    ("poisson", dict(rate=500.0, horizon=0.2, pool="all", tiers=(0, 1, 2))),
    ("mmpp", dict(rate=1500.0, horizon=0.1, pool="heavy", burst_factor=6.0)),
    ("mmpp", dict(rate=800.0, horizon=0.1, dwell_s=0.004, slo_s=0.01)),
    ("diurnal", dict(rate=1200.0, horizon=0.1, amplitude=0.5, tiers=(0, 1))),
    ("diurnal", dict(rate=900.0, horizon=0.3, period_s=0.05, pool="heavy")),
]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name,kw", ARRIVAL_CASES)
def test_arrival_process_job_lists(name, kw, seed):
    mine = PT.get_arrival_process(name, seed=seed, **kw)
    theirs = JT.get_arrival_process(name, seed=seed, **kw)
    assert len(_jobs(theirs)) > 5
    assert _jobs(mine) == _jobs(theirs)
    assert _jobs(mine) == _jobs(mine)  # iterating replays the stream
    for attr in ("name", "rate", "horizon"):
        assert getattr(mine, attr) == getattr(theirs, attr)


def test_trace_and_batch_instance_replay():
    rows = [
        {"t": 0.003, "model": "NCF", "tier": 1},
        {"t": 0.001, "model": "AlexNet", "slo_s": 0.02},
        {"t": 0.002, "model": "MelodyLSTM"},
    ]
    assert _jobs(PT.TraceArrivals(rows)) == _jobs(JT.TraceArrivals(rows))
    csv_rows = PT.synth_batch_instance_rows(300, seed=5)
    assert csv_rows == JT.synth_batch_instance_rows(300, seed=5)
    for kw in (dict(seed=2), dict(seed=0, jitter=False, pool="light", cpu_hi=200.0)):
        mine = PT.resolve_arrivals("batch_instance", source=csv_rows, **kw)
        theirs = JT.resolve_arrivals("batch_instance", source=csv_rows, **kw)
        assert _jobs(mine) == _jobs(theirs)
        assert (mine.rate, mine.horizon) == (theirs.rate, theirs.horizon)


def test_arrival_registry_and_errors():
    assert PT.list_arrival_processes() == JT.list_arrival_processes()
    bad = [
        ("poisson", dict(rate=0.0, horizon=1.0)),
        ("poisson", dict(rate=1.0, horizon=1.0, pool="nope")),
        ("poisson", dict(rate=1.0, horizon=1.0, tiers=())),
        ("mmpp", dict(rate=1.0, horizon=1.0, burst_factor=0.0)),
        ("diurnal", dict(rate=1.0, horizon=1.0, amplitude=1.5)),
        ("trace", dict(trace=[])),
        ("trace", dict(trace=[{"t": 0.0, "model": "nope"}])),
        ("batch_instance", dict(source=["a,b"])),
        ("nope", dict()),
    ]
    for name, kw in bad:
        with pytest.raises(ValueError) as theirs:
            JT.get_arrival_process(name, **kw)
        with pytest.raises(ValueError) as mine:
            PT.get_arrival_process(name, **kw)
        assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# dispatch and fleet loads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dispatch", ["jsq", "p2c", "rr"])
def test_dispatchers_on_fixed_loads(dispatch):
    assert PC.list_dispatchers() == JC.list_dispatchers()
    mine, theirs = PC.resolve_dispatcher(dispatch), JC.resolve_dispatcher(dispatch)
    gen = random.Random(11)
    rng_m, rng_t = random.Random(4), random.Random(4)
    for _ in range(300):
        loads = [gen.randrange(5) for _ in range(gen.choice([1, 2, 5, 16]))]
        assert mine.choose(loads, rng_m) == theirs.choose(loads, rng_t)
    assert rng_m.getstate() == rng_t.getstate()


class _Node:
    """What FleetLoads reads of an ArrayNode: index, in_system, queue."""

    def __init__(self, index, load, queued):
        self.index, self.in_system, self.queue = index, load, [None] * queued


@pytest.mark.parametrize("n", [1, 3, 64])
def test_fleet_loads_against_linear_scan(n):
    gen = random.Random(n)
    nodes = [_Node(i, gen.randrange(4), gen.randrange(3)) for i in range(n)]
    mine, theirs = PC.FleetLoads(nodes), JC.FleetLoads(nodes)
    for step in range(2000):
        node = gen.choice(nodes)
        node.in_system = max(0, node.in_system + gen.choice([-1, 1, 1]))
        node.queue = [None] * gen.randrange(4)
        mine.update(node)
        theirs.update(node)
        want = min(range(n), key=lambda i: (nodes[i].in_system, i))
        assert mine.min_index() == theirs.min_index() == want
        assert mine.queued_total == theirs.queued_total
        assert mine.queued_total == sum(len(x.queue) for x in nodes)
        assert mine.loads == theirs.loads
        for name in ("jsq", "p2c", "rr"):
            r1, r2 = random.Random(step), random.Random(step)
            got = PC.resolve_dispatcher(name).choose_tracked(mine, r1)
            assert got == JC.resolve_dispatcher(name).choose_tracked(theirs, r2)


# ---------------------------------------------------------------------------
# metrics and fairness accounting
# ---------------------------------------------------------------------------


def _random_records(mod, n, seed):
    gen = random.Random(seed)
    out = []
    for i in range(n):
        t = gen.random()
        sub = None if gen.random() < 0.1 else t + gen.random() * 1e-3
        done = None if sub is None or gen.random() < 0.1 else sub + gen.random() * 1e-2
        model, tier = gen.choice("ABC"), gen.randrange(3)
        out.append(mod.JobRecord(i, model, tier, t, t + 0.01, 0, sub, done))
    return out


def test_summarize_and_as_dict():
    ns = types.SimpleNamespace
    payloads = dict(
        fairness=ns(
            jain_fairness=0.5,
            per_tenant_slowdown={"B": 2.0, "A": 1.5},
            jain_dominant_share=0.7,
            dominant_share_mean={"B": 0.2, "A": 0.1},
        ),
        chaos=ns(
            faults_injected=3,
            jobs_lost=2,
            jobs_retried=2,
            jobs_recovered=1,
            retries_exhausted=1,
            jobs_shed=0,
        ),
        memory=ns(stall_s=0.25, stall_by_node={1: 0.2, 0: 0.05}, peak_pressure=1.7),
        overload=ns(
            rejections_by_cause={"queue_full": 4},
            shed_by_tier={2: 1},
            brownout_transitions=2,
            brownout_energy_j=0.1,
        ),
    )
    for armed in ({}, payloads):
        for n in (0, 1, 257):
            kw = dict(
                duration_s=1.3,
                pe_seconds_busy=0.4,
                total_pes=16384,
                queue_depth_samples=[random.Random(n).randrange(9) for _ in range(n)],
                preemptions=2,
                migrations=1,
                **armed,
            )
            theirs = JT.summarize(_random_records(JT, n, n), **kw)
            mine = PT.summarize(_random_records(PT, n, n), **kw)
            assert json.dumps(mine.as_dict()) == json.dumps(theirs.as_dict())
            assert _fields(mine) == _fields(theirs)
    vals = [random.Random(1).random() for _ in range(101)]
    for p in (0.0, 50.0, 95.0, 99.0, 100.0):
        assert PT.percentile(vals, p) == JT.percentile(vals, p)
    recs = _random_records(PT, 50, 9)
    assert PT.split_by(recs, "model") == JT.split_by(recs, "model")


def test_jain_index_and_accounting_decimation():
    for xs in ([], [0.0, 0.0], [1.0], [1.0, 2.0, 3.5], [1e-9, 5.0]):
        assert PF.jain_index(xs) == JF.jain_index(xs) or xs == []
    kw = dict(fairness=True, n_arrays=2, rate=4000.0, horizon=0.05, pool="light")

    def run(mod, acct_mod):
        sim = mod.TrafficSimulator("poisson", policy="drf", **kw)
        real = acct_mod.FairnessAccounting
        sim.accounting = real(
            sim.backend.array,
            sim.backend.time_fn(),
            stage=sim.backend.stage_model(),
            n_arrays=2,
            max_samples=16,
        )
        res = sim.run()
        return res, sim.accounting

    (mine, ma), (theirs, ta) = run(PT, PF), run(JT, JF)
    assert len(ma._samples) < 16 and ma._stride > 1
    assert mine.fairness == PF.FairnessReport(**dataclasses.asdict(theirs.fairness))
    assert _dump(mine) == _dump(theirs)
    assert ma.isolated_s("nope") is None and ta.isolated_s("nope") is None


# ---------------------------------------------------------------------------
# the simulator: config, armed features, errors
# ---------------------------------------------------------------------------


def test_serve_config_equals_flat_kwargs():
    flat = dict(
        n_arrays=3,
        dispatch="p2c",
        max_concurrent=2,
        queue_cap=5,
        seed=4,
        keep_trace=True,
        preemption=True,
        rebalance_interval=2e-3,
        fairness=True,
        memory=True,
    )
    assert dataclasses.asdict(PA.ServeConfig.of(**flat)) == dataclasses.asdict(
        JA.ServeConfig.of(**flat)
    )
    cfg = PA.ServeConfig(
        scheduling=PA.SchedulingConfig(
            n_arrays=3,
            dispatch="p2c",
            max_concurrent=2,
            queue_cap=5,
            seed=4,
            keep_trace=True,
            preemption=True,
        ),
        rebalance=PA.RebalanceConfig(interval=2e-3),
        fairness=True,
        memory=PA.MemoryConfig(contention=True),
    )
    assert cfg == PA.ServeConfig.of(**flat)
    arr = dict(rate=3000.0, horizon=0.03, pool="heavy", tiers=(0, 1))
    by_cfg = PA.Session("deadline_preempt").serve("mmpp", config=cfg, **arr)
    by_kw = PA.Session("deadline_preempt").serve("mmpp", **flat, **arr)
    theirs = JA.Session("deadline_preempt").serve("mmpp", **flat, **arr)
    for mine in (by_cfg, by_kw):
        _same(theirs, mine)
        assert _trace(mine) == _trace(theirs)
    assert by_cfg.as_dict()["preemption"] == "PreemptionModel"
    assert "memory_stall_s" in by_cfg.as_dict()


@pytest.mark.parametrize("policy", POLICIES)
def test_session_serve_every_policy(policy, depth):
    kw = dict(rate=2500.0, horizon=0.03, pool="all", tiers=(0, 1), n_arrays=2)
    theirs = JA.Session(policy).serve("poisson", **kw)
    mine = PA.Session(policy).serve("poisson", **kw)
    _same(theirs, mine)
    assert depth["port"] == depth["jax"] and len(depth["port"][0][0]) > 10


ARMED = {
    "preempt": ("deadline_preempt", dict(preemption=True, max_concurrent=8)),
    "moca": ("moca", dict(memory=True, n_arrays=2)),
    "migrate": ("equal", dict(rebalance_interval=1e-3, n_arrays=4, queue_cap=8)),
    "migrate_weights": (
        "equal",
        dict(rebalance_interval=5e-4, n_arrays=3, migration="weights"),
    ),
    "fairness": ("drf", dict(fairness=True, n_arrays=4)),
    "fairness_resources": ("equal", dict(fairness="resources", n_arrays=2)),
    "everything": (
        "deadline_preempt",
        dict(
            preemption=True,
            memory=True,
            fairness=True,
            rebalance_interval=1e-3,
            n_arrays=3,
            dispatch="p2c",
            check_invariants=True,
        ),
    ),
}


def _armed_kwargs(pkg, kw):
    kw = dict(kw)
    if kw.get("migration") == "weights":
        kw["migration"] = pkg.traffic.MigrationModel(include_weights=True)
    if kw.get("fairness") == "resources":
        kw["fairness"] = pkg.fairness.ResourceModel(window_s=2e-4)
    return kw


@pytest.mark.parametrize("name", list(ARMED))
def test_armed_feature(name, depth):
    import repro

    policy, kw = ARMED[name]
    arr = dict(rate=4000.0, horizon=0.04, pool="heavy", slo_s=0.004, tiers=(0, 1))
    runs = {}
    for key, pkg in (("jax", repro), ("port", repro_torch)):
        pkg_kw = _armed_kwargs(pkg, kw)
        sim = pkg.traffic.TrafficSimulator(
            "mmpp", policy=policy, keep_trace=True, **pkg_kw, **arr
        )
        runs[key] = sim.run()
    _same(runs["jax"], runs["port"])
    assert _trace(runs["port"]) == _trace(runs["jax"])
    assert depth["port"] == depth["jax"]
    d = runs["port"].as_dict()
    fired = {
        "preempt": d.get("preemptions", 0) > 0,
        "moca": d.get("memory_stall_s", 0.0) > 0.0,
        "migrate": d.get("migrations", 0) > 0,
        "fairness": "jain_dominant_share" in d,
    }
    assert fired.get(name, True)


def _both_raise(build):
    with pytest.raises(Exception) as theirs:
        build(JA, JT)
    with pytest.raises(Exception) as mine:
        build(PA, PT)
    assert type(mine.value).__name__ == type(theirs.value).__name__
    assert str(mine.value) == str(theirs.value)


ARR = dict(rate=1000.0, horizon=0.01)
INVALID = {
    "config_and_flat": lambda A, T: T.serve(
        "poisson", config=A.ServeConfig(), n_arrays=2, **ARR
    ),
    "config_not_a_config": lambda A, T: T.serve("poisson", config={}, **ARR),
    "unknown_knob": lambda A, T: A.ServeConfig.of(n_array=2),
    "n_arrays": lambda A, T: T.serve("poisson", n_arrays=0, **ARR),
    "interval": lambda A, T: T.serve("poisson", rebalance_interval=0.0, **ARR),
    "rebalancer_alone": lambda A, T: T.serve(
        "poisson", rebalancer="migrate_on_pressure", **ARR
    ),
    "migration_alone": lambda A, T: T.serve(
        "poisson", migration=T.MigrationModel(), **ARR
    ),
    "migration_with_instance": lambda A, T: T.serve(
        "poisson",
        rebalance_interval=1e-3,
        rebalancer=T.MigrateOnPressure(),
        migration=T.MigrationModel(),
        **ARR,
    ),
    "unknown_rebalancer": lambda A, T: T.serve(
        "poisson", rebalance_interval=1e-3, rebalancer="nope", **ARR
    ),
    "recovery_alone": lambda A, T: T.serve("poisson", recovery="abort", **ARR),
    "monitor_alone": lambda A, T: T.serve("poisson", monitor=object(), **ARR),
    "arrival_kwargs_on_jobs": lambda A, T: T.serve([], rate=1.0),
    "unknown_dispatch": lambda A, T: T.serve("poisson", dispatch="nope", **ARR),
    "unknown_arrivals": lambda A, T: T.serve("nope", **ARR),
    "unknown_policy": lambda A, T: T.serve("poisson", policy="nope", **ARR),
    "bad_node": lambda A, T: T.ArrayNode(
        0, None, None, None, None, max_concurrent=0, queue_cap=1, on_complete=None
    ),
    "sharded_object_policy": lambda A, T: T.ShardedTrafficSimulator(
        "poisson", policy=A.EqualPolicy(), **ARR
    ),
    "sharded_shards": lambda A, T: T.ShardedTrafficSimulator(
        "poisson", n_arrays=2, n_shards=3, **ARR
    ),
    "sharded_sync": lambda A, T: T.ShardedTrafficSimulator(
        "poisson", sync_every=0, **ARR
    ),
    "sharded_timeout": lambda A, T: T.ShardedTrafficSimulator(
        "poisson", pod_timeout_s=0.0, **ARR
    ),
    "sharded_respawn_alone": lambda A, T: T.ShardedTrafficSimulator(
        "poisson", respawn=True, **ARR
    ),
    "sharded_arrival_kwargs": lambda A, T: T.ShardedTrafficSimulator([], rate=1.0),
}


@pytest.mark.parametrize("case", list(INVALID))
def test_invalid_combination_raises_like_jax(case):
    _both_raise(INVALID[case])


def test_duplicate_job_names_rejected():
    jobs = list(PT.PoissonArrivals(rate=3000.0, horizon=0.01))
    with pytest.raises(ValueError, match="duplicate job name"):
        PT.serve(jobs + jobs[-1:])


KNOB_ARR = dict(rate=6000.0, horizon=0.02, pool="light", slo_s=0.004, tiers=(0, 1))
ARMED_KNOBS = {
    "obs": lambda P: P.traffic.serve("poisson", obs=True, n_arrays=2, **KNOB_ARR),
    "faults": lambda P: P.traffic.serve(
        "poisson",
        faults=[P.chaos.FaultEvent(t=0.008, kind="crash", node=1)],
        n_arrays=2,
        **KNOB_ARR,
    ),
    "admission": lambda P: P.traffic.serve(
        "poisson", admission="static", n_arrays=2, **KNOB_ARR
    ),
    "brownout": lambda P: P.traffic.serve(
        "poisson", brownout=True, n_arrays=2, **KNOB_ARR
    ),
    "config_chaos": lambda P: P.api.Session().serve(
        "poisson",
        config=P.api.ServeConfig(
            scheduling=P.api.SchedulingConfig(n_arrays=3),
            chaos=P.api.ChaosConfig(
                faults=[
                    P.chaos.FaultEvent(t=0.006, kind="degrade", node=2, dead_cols=40)
                ]
            ),
        ),
        **KNOB_ARR,
    ),
    "sharded_obs": lambda P: P.traffic.serve_sharded(
        "poisson", obs=True, n_arrays=4, **KNOB_ARR
    ),
    "sharded_faults": lambda P: P.traffic.serve_sharded(
        "poisson",
        faults=[P.chaos.FaultEvent(t=0.0, kind="pod_kill", node=1, epoch=1)],
        respawn=True,
        n_arrays=4,
        sync_every=16,
        **KNOB_ARR,
    ),
}


# the test's name is historical (these knobs once raised in the port); it is
# kept so its ids stay, and it checks that each armed knob equals the reference
@pytest.mark.parametrize("knob", list(ARMED_KNOBS))
def test_not_ported_knob_raises(knob):
    """Each knob that once raised ``NotImplementedError`` in the port runs
    armed now, and equals the JAX package's run."""
    import repro
    import repro.chaos
    import repro_torch.chaos

    # the obs digest's oracle-calls-per-event gauge reads process-global caches
    C.clear_cost_caches("repro")
    theirs = ARMED_KNOBS[knob](repro)
    C.clear_cost_caches("repro_torch")
    mine = ARMED_KNOBS[knob](repro_torch)
    _same(theirs, mine)
    gated = {"obs", "faults", "overload"} & set(mine.as_dict())
    assert gated, knob


def _node(T, done=None):
    backend = (PA if T is PT else JA).resolve_backend("sim")
    return T.ArrayNode(
        0,
        backend.array,
        backend.time_fn(),
        backend.stage_model(),
        (PA if T is PT else JA).resolve_policy("equal"),
        max_concurrent=2,
        queue_cap=3,
        on_complete=done or (lambda node, name, t: None),
    )


def test_array_node_surface():
    """Admission, queueing, migration out and in, queue promotion and the
    full-queue rejection on one node, step for step."""

    def drive(T):
        done = []
        node = _node(T, lambda n, name, t: done.append((name, t)))
        jobs = list(T.PoissonArrivals(rate=20000.0, horizon=0.0008, pool="heavy"))
        log = [node.offer(j) for j in jobs[:7]]
        log.append(node.wait_estimate())
        log.append(node.service_estimate(jobs[0].dnng))
        moved = node.take_for_migration(jobs[4].dnng.name)
        log.append(moved.job_id if moved else None)
        log.append(node.take_for_migration("nope"))
        log.append(node.admit_migrated(moved, 1e-4, 3e-4))
        node.scheduler.run_until(2e-4)
        log += [node.offer(j) for j in jobs[7:]]
        node.scheduler.run()
        log += [node.in_system, node.pe_seconds_busy, node.bus_stall_s, done]
        return log

    log = drive(PT)
    assert log == drive(JT)
    assert "rejected" in log and "queued" in log


# ---------------------------------------------------------------------------
# sharded pods
# ---------------------------------------------------------------------------

SHARDED_ARR = dict(rate=12000.0, horizon=0.15, pool="light", slo_s=0.01)


@pytest.mark.parametrize("parallel", [False, True])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("dispatch", ["rr", "jsq", "p2c"])
def test_sharded_matches_jax(dispatch, n_shards, parallel, depth):
    kw = dict(
        policy="drf",
        n_arrays=8,
        n_shards=n_shards,
        dispatch=dispatch,
        sync_every=64,
        parallel=parallel,
        fairness=True,
        preemption=True,
        **SHARDED_ARR,
    )
    theirs = JT.serve_sharded("poisson", **kw)
    mine = PT.serve_sharded("poisson", **kw)
    assert 1000 < mine.metrics.jobs_arrived <= 2000
    _same(theirs, mine)
    assert depth["port"] == depth["jax"]
    # invariance to the shard count and the fork
    one = PT.serve_sharded("poisson", **{**kw, "n_shards": 1, "parallel": False})
    assert _dump(one) == _dump(mine) and _records(one) == _records(mine)
    if dispatch == "rr":
        # round robin reads no loads: byte-identical to the single loop
        single = PT.serve(
            "poisson",
            policy="drf",
            n_arrays=8,
            dispatch="rr",
            fairness=True,
            preemption=True,
            **SHARDED_ARR,
        )
        assert _records(single) == _records(mine)
        assert depth["port"][-1] == depth["port"][0]
        single_d = single.as_dict()
        for key in ("jain_dominant_share", "dominant_share_mean"):
            single_d.pop(key)
        assert json.dumps(single_d) == _dump(mine)


def test_pod_failure_is_reported_not_hung(monkeypatch):
    """A pod that dies mid-run surfaces as PodFailureError within the pod
    time limit, with the ledger's partial payload."""

    def die(self, lo, hi, snapshot):
        if lo >= 128 and self.base == 0:
            os._exit(3)
        return real(self, lo, hi, snapshot)

    real = PSH._Pod.run_epoch
    monkeypatch.setattr(PSH._Pod, "run_epoch", die)
    sim = PT.ShardedTrafficSimulator(
        "poisson", n_arrays=4, n_shards=2, pod_timeout_s=30.0, **SHARDED_ARR
    )
    with pytest.raises(PT.PodFailureError) as e:
        sim.run()
    err = e.value
    assert err.pod == 0 and err.epoch == 2
    assert err.pod_status[0] == {"state": "dead", "epochs_done": 2}
    assert err.pod_status[1]["state"] == "ok"
    done = sum(r.completed is not None for r in err.partial_records)
    assert err.jobs_completed == done


# ---------------------------------------------------------------------------
# the card's serve phase, rehearsed against its golden record
# ---------------------------------------------------------------------------


def _golden():
    with open(GOLDEN) as f:
        return json.load(f)


def test_golden_small_sections_regenerate_from_jax():
    record, _ = C.serve_record("repro", big=False)
    golden = _golden()
    for section in SMALL:
        assert json.loads(json.dumps(record[section])) == golden[section], section


def test_port_serve_phase_equals_golden():
    import repro_torch.kernels as K

    K.reset_launch_counts()
    record, _ = C.serve_record("repro_torch", big=False)
    assert sum(K.launch_counts().values()) == 0
    golden = _golden()
    assert set(golden) == set(SMALL) | {"scale", "sharded_scale"}
    for section in SMALL:
        assert json.loads(json.dumps(record[section])) == golden[section], section
    assert golden["scale"]["jobs_target"] == C.SCALE_CELL[0]
    assert golden["sharded_scale"]["jobs_arrived"] > 99_000


def test_scale_and_sharded_cells_at_cut_size():
    """The big cells' code at a cut size, the port against the JAX
    package (their full sizes run on the card, against the golden)."""
    mine, _ = C.scale_cell("repro_torch", 1000, 16)
    theirs, _ = C.scale_cell("repro", 1000, 16)
    assert mine == theirs and mine["events"] > 10_000
    mine, timing = C.sharded_cell("repro_torch", 2000, 32, 4, parallel=True)
    theirs, _ = C.sharded_cell("repro", 2000, 32, 4, parallel=False)
    assert mine == theirs and timing["jobs_per_s"] > 0


def test_top_level_exports():
    assert set(repro_torch.__all__) >= {"Session", "ServeConfig", "serve"}
    assert repro_torch.serve is PT.serve
    assert repro_torch.ServeConfig is PA.ServeConfig
    assert set(PF.__all__) == set(JF.__all__)
    assert set(PT.__all__) == set(JT.__all__)
    assert set(PA.__all__) == set(JA.__all__)


def _write_golden() -> None:
    record, timing = C.serve_record("repro", big=True, parallel=False)
    with open(GOLDEN, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"wrote {GOLDEN}: {json.dumps(timing)}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: python tests/test_torch_traffic.py --write-golden")
    _write_golden()
