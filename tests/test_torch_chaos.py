"""The port's fault injection (``repro_torch.chaos``) against the JAX
package's ``repro.chaos``.

Fault plans, detection, recovery and the serve runs they arm are host
arithmetic in both packages, so every comparison here is ``==``: error
types and texts, plans, belief transitions, backoff streams, records,
``json.dumps(as_dict())`` and ``ChaosReport``.

``tests/data/resilience_golden.json`` holds every seeded field of the
resilience cells of ``chip_smoke.py``'s serve phase (chaos, overload, obs,
and the two scale cells with every knob armed), made from the JAX package:

    python tests/test_torch_chaos.py --write-golden

(the 100,000-job sharded cell run serially, which gives the same result as
forked pods).  This file regenerates the golden's chaos section from the JAX
package and checks the port against it and against both scale cells at a
cut size.
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
import repro.chaos as JX
import repro.sim.workloads as JW
import repro.traffic as JT
import repro.traffic.cluster as JC
import repro_torch
import repro_torch.chaos as PX
import repro_torch.sim.workloads as PW
import repro_torch.traffic as PT
import repro_torch.traffic.cluster as PC

GOLDEN = os.path.join(ROOT, C.RESILIENCE_GOLDEN)
PKGS = (("jax", repro), ("port", repro_torch))


def _records(res):
    return [dataclasses.astuple(r) for r in res.records]


def _same(a, b):
    assert json.dumps(b.as_dict()) == json.dumps(a.as_dict())
    assert _records(b) == _records(a)


def _both_raise(build):
    with pytest.raises(Exception) as theirs:
        build(JX, JT)
    with pytest.raises(Exception) as mine:
        build(PX, PT)
    assert type(mine.value).__name__ == type(theirs.value).__name__
    assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

BAD_EVENTS = {
    "kind": dict(t=0.0, kind="meteor"),
    "time": dict(t=-1.0, kind="crash"),
    "node": dict(t=0.0, kind="crash", node=-1),
    "duration": dict(t=0.0, kind="crash", duration_s=-1.0),
    "blackout": dict(t=0.0, kind="blackout"),
    "bus_stall": dict(t=0.0, kind="bus_stall", duration_s=1.0),
    "straggler": dict(t=0.0, kind="straggler", factor=0.5),
    "degrade": dict(t=0.0, kind="degrade"),
    "pod_kill": dict(t=0.0, kind="pod_kill", epoch=-1),
}


@pytest.mark.parametrize("case", list(BAD_EVENTS))
def test_fault_event_validation(case):
    _both_raise(lambda X, T: X.FaultEvent(**BAD_EVENTS[case]))


def _plan(plan):
    return plan.name, [dataclasses.astuple(e) for e in plan.events], plan.kinds()


SEEDED = [
    dict(crashes=1, blackouts=1, stragglers=1),
    dict(crashes=2, degrades=2, bus_stalls=1, dead_cols=32),
    dict(blackouts=3, stragglers=2, repair_frac=0.1, window=(0.1, 0.9), name="x"),
]


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("kw", range(len(SEEDED)))
def test_fault_plan_seeded(seed, kw):
    args = dict(horizon=0.37, n_nodes=5, **SEEDED[kw])
    theirs = JX.FaultPlan.seeded(seed, **args)
    mine = PX.FaultPlan.seeded(seed, **args)
    assert _plan(mine) == _plan(theirs)
    assert mine == PX.FaultPlan.seeded(seed, **args)


def test_fault_plan_single_resolve_and_errors():
    kw = dict(t=0.1, node=2, dead_cols=8)
    single = [X.FaultPlan.single("degrade", **kw) for X in (JX, PX)]
    assert _plan(single[1]) == _plan(single[0])
    events = [dict(t=0.3, kind="crash", node=1), dict(t=0.1, kind="pod_kill", epoch=2)]
    got = [
        _plan(X.resolve_faults([X.FaultEvent(**e) for e in events])) for X in (JX, PX)
    ]
    assert got[0] == got[1]
    got = [_plan(X.resolve_faults(X.FaultEvent(**events[0]))) for X in (JX, PX)]
    assert got[0] == got[1]
    _both_raise(lambda X, T: X.resolve_faults("crash"))
    _both_raise(lambda X, T: X.resolve_faults([1, 2]))
    _both_raise(lambda X, T: X.FaultPlan.seeded(0, horizon=0.0, n_nodes=1))
    assert PX.FAULT_KINDS == JX.FAULT_KINDS
    assert set(PX.__all__) == set(JX.__all__)


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------


def test_truncate_dnng():
    for name in ("ResNet50", "AlexNet", "SA_LSTM"):
        theirs, mine = JW.MODELS[name](), PW.MODELS[name]()
        for done in (0, 1, len(mine.layers) - 1):
            t = JX.truncate_dnng(theirs, done, arrival_time=0.25)
            m = PX.truncate_dnng(mine, done, arrival_time=0.25)
            assert (m.name, m.edges) == (t.name, t.edges)
            assert m.arrival_time == t.arrival_time
            assert [dataclasses.astuple(x) for x in m.layers] == [
                dataclasses.astuple(x) for x in t.layers
            ]
    dag = [
        X.DNNG(
            name="dag",
            layers=W.MODELS["AlexNet"]().layers[:5],
            edges=((0, 1), (0, 2), (1, 3), (2, 3), (3, 4), (1, 4)),
        )
        for X, W in ((repro.core.dnng, JW), (repro_torch.core.dnng, PW))
    ]
    mine, theirs = PX.truncate_dnng(dag[1], 2, 0.1), JX.truncate_dnng(dag[0], 2, 0.1)
    assert mine.edges == theirs.edges
    _both_raise(
        lambda X, T: X.truncate_dnng(
            (JW if X is JX else PW).MODELS["AlexNet"](), 99, arrival_time=0.0
        )
    )


def test_retry_restart_backoffs_and_shedding():
    def drive(X):
        pol = X.RetryRestart(
            retry=X.RetryPolicy(base_backoff_s=2e-3, jitter_frac=0.3, budgets=(4, 2)),
            checkpoint_every=3,
            shed_below={1: 0.6, 2: 0.8},
        )
        rng = random.Random(11)
        model = (JW if X is JX else PW).MODELS["ResNet50"]()
        return [
            [pol.backoff_s(a, rng) for a in range(8)],
            [pol.retry_budget(t) for t in range(4)],
            [pol.checkpoint_layers(k) for k in range(10)],
            [pol.should_shed(t, f) for t in range(4) for f in (0.5, 0.7, 0.9)],
            pol.restore_s(model),
            X.NoRecovery().retry_budget(0),
            X.NoRecovery().backoff_s(3, rng),
            X.list_recoveries(),
            X.resolve_recovery("none").name,
        ]

    assert drive(PX) == drive(JX)


@pytest.mark.parametrize("key", ["respawn:0:1:1", "respawn:5:3:2", "x"])
def test_respawn_backoffs(key):
    for n in (0, 1, 17):
        assert PX.respawn_backoffs(n, key) == JX.respawn_backoffs(n, key)
    retry = [X.RetryPolicy(base_backoff_s=1e-4, jitter_frac=0.5) for X in (JX, PX)]
    mine = PX.respawn_backoffs(9, key, retry[1])
    assert mine == JX.respawn_backoffs(9, key, retry[0])


BAD_RECOVERY = {
    "backoff": lambda X: X.RetryPolicy(base_backoff_s=0.0),
    "factor": lambda X: X.RetryPolicy(backoff_factor=0.5),
    "jitter": lambda X: X.RetryPolicy(jitter_frac=1.0),
    "budgets": lambda X: X.RetryPolicy(budgets=()),
    "checkpoint": lambda X: X.RetryRestart(checkpoint_every=0),
    "shed_tier0": lambda X: X.RetryRestart(shed_below={0: 0.5}),
    "unknown": lambda X: X.resolve_recovery("nope"),
    "monitor_order": lambda X: X.HealthMonitor(suspect_after_s=1.0, dead_after_s=0.5),
    "monitor_factor": lambda X: X.HealthMonitor(outlier_factor=1.0),
    "monitor_alpha": lambda X: X.HealthMonitor(ewma_alpha=0.0),
}


@pytest.mark.parametrize("case", list(BAD_RECOVERY))
def test_recovery_and_monitor_validation(case):
    _both_raise(lambda X, T: BAD_RECOVERY[case](X))


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------


class _Node:
    def __init__(self, index):
        self.index = index
        self.alive = True
        self.health = "healthy"
        self.down_since = 0.0


class _Fleet:
    def __init__(self):
        self.calls = []

    def exclude(self, i):
        self.calls.append(("exclude", i))

    def readmit(self, i):
        self.calls.append(("readmit", i))


def test_health_monitor_transitions():
    """A scripted fleet: a straggler trips the ratio rule and is
    re-probed, a node dies and is detected by staleness, another by a
    failed dispatch, and a blackout comes back."""

    def drive(X):
        mon = X.HealthMonitor(min_observations=2, probe_after_s=4e-3)
        nodes = [_Node(i) for i in range(5)]
        fleet = _Fleet()
        rng = random.Random(3)
        fired = []
        for step in range(120):
            now = step * 5e-4
            for node in nodes:
                slow = 6.0 if node.index == 2 and 10 <= step < 70 else 1.0
                mon.observe(node.index, slow * (0.8 + 0.4 * rng.random()), now)
            if step == 20:
                nodes[3].alive, nodes[3].down_since = False, now
            if step == 30:
                nodes[1].alive, nodes[1].down_since = False, now
                mon.note_dispatch_failure(nodes[1], fleet, now)
            if step == 45:
                nodes[1].alive, nodes[1].down_since = True, 0.0
            fired.append(mon.refresh(now, nodes, fleet))
        return mon.transitions, fleet.calls, fired, [n.health for n in nodes]

    theirs, mine = drive(JX), drive(PX)
    assert mine == theirs
    causes = {t[4] for t in mine[0]}
    assert {"service_outlier", "heartbeat_lost", "dispatch_failure"} <= causes


# ---------------------------------------------------------------------------
# the fleet's fault surface
# ---------------------------------------------------------------------------


def _node(pkg, done):
    backend = pkg.api.resolve_backend("sim")
    return pkg.traffic.ArrayNode(
        0,
        backend.array,
        backend.time_fn(),
        backend.stage_model(),
        pkg.api.resolve_policy("equal"),
        max_concurrent=2,
        queue_cap=2,
        on_complete=lambda n, name, t: done.append((name, t)),
    )


def test_array_node_fault_surface():
    """fail, repair, degrade and the speed scales on one node, step for
    step: lost jobs with their checkpointed layers, overflow, busy carry."""

    def drive(pkg):
        done = []
        node = _node(pkg, done)
        jobs = list(
            pkg.traffic.PoissonArrivals(rate=30000.0, horizon=0.002, pool="heavy")
        )
        early = [j for j in jobs if j.arrival < 2e-4]
        late = [j for j in jobs if j.arrival > 7e-4][:4]
        log = [node.offer(j) for j in early]
        node.scheduler.run_until(2e-4)
        node.set_compute_scale(3.0)
        node.set_bus_scale(2.0)
        node.set_batch_demand_scale(0.5)
        lost = node.degrade(2e-4, 48)
        log.append([(j.job_id, k) for j, k in lost])
        log += [node.array.cols, node.in_system, node.scheduler.time_scale]
        node.scheduler.run_until(5e-4)
        lost = node.fail(5e-4)
        log.append([(j.job_id, k, len(j.dnng.layers)) for j, k in lost])
        log += [node.alive, node.down_since, node.in_system]
        node.repair(7e-4)
        log += [node.offer(j) for j in late]
        node.set_compute_scale(1.0)
        node.scheduler.run()
        log += [node.pe_seconds_busy, node.bus_stall_s, done]
        with pytest.raises(ValueError) as e:
            node.degrade(1e-3, node.array.cols)
        log.append(str(e.value))
        return log

    assert drive(repro_torch) == drive(repro)


def test_fleet_loads_health_exclusion():
    """Exclusion, readmission and load moves in a random order: the heap
    argmin, the routing view and both dispatchers' choices, step for step."""

    class N:
        def __init__(self, i):
            self.index, self.in_system, self.queue = i, 0, []

    script = [random.Random(5).random() for _ in range(400)]

    def run(T):
        nodes = [N(i) for i in range(6)]
        fleet = T.FleetLoads(nodes)
        jsq, p2c = T.resolve_dispatcher("jsq"), T.resolve_dispatcher("p2c")
        rr = random.Random(9)
        out = []
        for k, x in enumerate(script):
            i = int(x * 6)
            if x < 0.15:
                fleet.exclude(i)
            elif x < 0.3:
                fleet.readmit(i)
            else:
                nodes[i].in_system = (nodes[i].in_system + k) % 5
                fleet.update(nodes[i])
            out.append(
                (
                    fleet.min_index(),
                    list(fleet.routing_loads),
                    jsq.choose_tracked(fleet, rr),
                    p2c.choose_tracked(fleet, rr),
                )
            )
        return out

    assert run(PC) == run(JC)


# ---------------------------------------------------------------------------
# armed serve runs
# ---------------------------------------------------------------------------

ARR = dict(rate=20000.0, horizon=0.02, pool="light", slo_s=0.01, tiers=(0, 1, 2))
FLEET = dict(n_arrays=4, dispatch="jsq", max_concurrent=4, queue_cap=16)
PLANS = {
    "crash": lambda X: X.FaultPlan.single("crash", t=0.006, node=1),
    "blackout": lambda X: X.FaultPlan.single(
        "blackout", t=0.005, node=0, duration_s=0.004
    ),
    "degrade": lambda X: X.FaultPlan.single("degrade", t=0.006, node=1, dead_cols=96),
    "degrade_full": lambda X: X.FaultPlan.single(
        "degrade", t=0.006, node=1, dead_cols=128
    ),
    "bus_stall": lambda X: X.FaultPlan.single(
        "bus_stall", t=0.004, node=3, factor=5.0, duration_s=0.006
    ),
    "straggler": lambda X: X.FaultPlan.single(
        "straggler", t=0.004, node=2, factor=6.0, duration_s=0.01
    ),
    "seeded": lambda X: X.FaultPlan.seeded(
        3, horizon=0.02, n_nodes=4, crashes=1, blackouts=2, degrades=1,
        bus_stalls=1, stragglers=1,
    ),
    "late": lambda X: X.FaultPlan.single("blackout", t=0.05, node=2, duration_s=0.01),
}
RECOVERY = {
    "retry_restart": lambda X: "retry_restart",
    "none": lambda X: "none",
    "shedding": lambda X: X.RetryRestart(
        retry=X.RetryPolicy(budgets=(1,)), checkpoint_every=2, shed_below={1: 0.9}
    ),
}


@pytest.mark.parametrize("recovery", list(RECOVERY))
@pytest.mark.parametrize("plan", list(PLANS))
def test_fault_armed_serve(plan, recovery):
    runs = {}
    for key, pkg in PKGS:
        X = pkg.chaos
        runs[key] = pkg.traffic.TrafficSimulator(
            "poisson",
            faults=PLANS[plan](X),
            recovery=RECOVERY[recovery](X),
            monitor=X.HealthMonitor(dead_after_s=3e-3),
            seed=4,
            **FLEET,
            **ARR,
        ).run()
    _same(runs["jax"], runs["port"])
    mine, theirs = runs["port"].chaos, runs["jax"].chaos
    assert dataclasses.astuple(mine) == dataclasses.astuple(theirs)
    assert mine.as_dict() == theirs.as_dict()
    assert mine.faults_injected >= 1


def test_fault_errors_like_jax():
    kw = dict(rate=1000.0, horizon=0.01)
    _both_raise(
        lambda X, T: T.serve(
            "poisson", faults=X.FaultEvent(t=0.0, kind="pod_kill"), **kw
        )
    )
    _both_raise(
        lambda X, T: T.serve(
            "poisson", faults=X.FaultEvent(t=0.0, kind="crash", node=3), **kw
        )
    )
    _both_raise(
        lambda X, T: T.serve_sharded(
            "poisson", faults=X.FaultEvent(t=0.0, kind="crash"), **kw
        )
    )
    _both_raise(
        lambda X, T: T.serve_sharded(
            "poisson", faults=X.FaultEvent(t=0.0, kind="pod_kill", node=5), **kw
        )
    )


# ---------------------------------------------------------------------------
# sharded pods: pod_kill and respawn
# ---------------------------------------------------------------------------

SHARDED = dict(
    policy="equal",
    n_arrays=4,
    dispatch="rr",
    max_concurrent=4,
    queue_cap=8,
    sync_every=32,
    pod_timeout_s=60.0,
    rate=30000.0,
    horizon=0.02,
    pool="light",
    slo_s=0.004,
    tiers=(0, 1, 1),
)


def _pod_kill(pkg, n_shards, parallel, **kw):
    kill = pkg.chaos.FaultEvent(t=0.0, kind="pod_kill", node=n_shards - 1, epoch=2)
    return pkg.traffic.ShardedTrafficSimulator(
        "poisson", n_shards=n_shards, parallel=parallel, faults=kill, **SHARDED, **kw
    )


@pytest.mark.parametrize("parallel", [False, True])
@pytest.mark.parametrize("n_shards", [1, 2])
def test_pod_kill_aborts_like_jax(n_shards, parallel):
    errs = {}
    for key, pkg in PKGS:
        with pytest.raises(pkg.traffic.PodFailureError) as e:
            _pod_kill(pkg, n_shards, parallel and key == "port").run()
        errs[key] = e.value
    assert C._pod_failure(errs["port"]) == C._pod_failure(errs["jax"])
    assert errs["port"].epoch == 2 and errs["port"].jobs_completed > 0


@pytest.mark.parametrize("parallel", [False, True])
@pytest.mark.parametrize("n_shards", [1, 2])
def test_pod_respawn_like_jax(n_shards, parallel):
    theirs = _pod_kill(repro, n_shards, False, respawn=True).run()
    mine = _pod_kill(repro_torch, n_shards, parallel, respawn=True).run()
    _same(theirs, mine)
    assert mine.recovery == "pod_respawn" and mine.faults == "pod_kill"
    # a plan that never fires leaves the run as a fault-free one
    late = PX.FaultEvent(t=0.0, kind="pod_kill", node=0, epoch=10_000)
    quiet = PT.serve_sharded(
        "poisson", n_shards=n_shards, faults=late, respawn=True, **SHARDED
    )
    plain = PT.serve_sharded("poisson", n_shards=n_shards, **SHARDED)
    assert json.dumps(quiet.as_dict()) == json.dumps(plain.as_dict())


# ---------------------------------------------------------------------------
# the card's resilience cells, rehearsed against their golden record
# ---------------------------------------------------------------------------


def _golden():
    with open(GOLDEN) as f:
        return json.load(f)


def test_chaos_cells_at_cut_size():
    theirs = C.chaos_cells("repro", jobs=200, parallel=False)
    mine = C.chaos_cells("repro_torch", jobs=200, parallel=True)
    assert mine == theirs
    assert mine["crash"]["chaos_report"]["jobs_lost"] >= 0


def test_golden_chaos_section_regenerates_from_jax():
    golden = _golden()["chaos"]
    assert C._jsonable(C.chaos_cells("repro", parallel=False)) == golden
    assert C._jsonable(C.chaos_cells("repro_torch")) == golden
    assert golden["crash"]["chaos_report"]["jobs_recovered"] > 0
    causes = [t[4] for t in golden["straggler"]["transitions"]]
    assert "service_outlier" in causes


def test_scale_cells_at_cut_size():
    """Both armed scale cells' code at a cut size, the port against the JAX
    package (their full sizes run on the card, against the golden)."""
    mine, _ = C.armed_scale_cell("repro_torch", 1500, 16)
    theirs, _ = C.armed_scale_cell("repro", 1500, 16)
    assert mine == theirs and mine["chaos_report"]["faults_injected"] == 3
    mine, timing = C.respawn_scale_cell("repro_torch", 3000, 32, 4, parallel=True)
    theirs, _ = C.respawn_scale_cell("repro", 3000, 32, 4, parallel=False)
    assert mine == theirs and timing["jobs_per_s"] > 0
    golden = _golden()
    assert golden["scale"]["jobs_target"] == C.SCALE_CELL[0]
    assert golden["sharded_scale"]["recovery"] == "pod_respawn"
    assert golden["sharded_scale"]["jobs_arrived"] > 99_000


def test_top_level_exports():
    assert repro_torch.FaultPlan is PX.FaultPlan
    assert {"FaultPlan", "Observability"} <= set(repro_torch.__all__)
    assert set(repro_torch.__all__) == set(repro.__all__)


def _write_golden() -> None:
    record, timing = C.resilience_record("repro", parallel=False)
    with open(GOLDEN, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"wrote {GOLDEN}: {json.dumps(timing)}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: python tests/test_torch_chaos.py --write-golden")
    _write_golden()
