"""The port's overload control (``repro_torch.overload``) against the JAX
package's ``repro.overload``.

Admission decisions, the brownout ladder and the serve runs they arm are
host arithmetic in both packages, so every comparison here is ``==``:
decision streams, stage transitions, ``BrownoutReport``, records and
``json.dumps(as_dict())``.  The golden's overload section
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
import repro.overload as JO
import repro.traffic
import repro_torch
import repro_torch.api
import repro_torch.chaos
import repro_torch.overload as PO
import repro_torch.traffic

GOLDEN = os.path.join(ROOT, C.RESILIENCE_GOLDEN)
PKGS = (("jax", repro), ("port", repro_torch))


def _records(res):
    return [dataclasses.astuple(r) for r in res.records]


def _same(a, b):
    assert json.dumps(b.as_dict()) == json.dumps(a.as_dict())
    assert _records(b) == _records(a)


def _both_raise(build):
    with pytest.raises(Exception) as theirs:
        build(JO)
    with pytest.raises(Exception) as mine:
        build(PO)
    assert type(mine.value).__name__ == type(theirs.value).__name__
    assert str(mine.value) == str(theirs.value)


def _stream(n=600, seed=2):
    """A fixed (tier, now, delay) stream: delay ramps up, holds above any
    target, then falls back, with jitter."""
    rng = random.Random(seed)
    out, now = [], 0.0
    for i in range(n):
        now += rng.expovariate(2000.0)
        phase = i / n
        delay = 8e-3 * min(1.0, 3 * phase) * (1.0 if phase < 0.7 else 0.1)
        out.append((rng.choice((0, 1, 1, 2)), now, delay * (0.5 + rng.random())))
    return out


ADMISSIONS = {
    "static": lambda O: "static",
    "codel": lambda O: "codel",
    "codel_tight": lambda O: O.CoDelAdmission(target_delay_s=1e-3, interval_s=2e-3),
    "token_bucket": lambda O: "token_bucket",
    "token_bucket_small": lambda O: O.TokenBucketAdmission(rate=300.0, burst=3.0),
}


@pytest.mark.parametrize("name", list(ADMISSIONS))
def test_admission_decisions(name):
    decisions = {}
    for key, O in (("jax", JO), ("port", PO)):
        pol = O.resolve_admission(ADMISSIONS[name](O))
        decisions[key] = [pol.admit(t, now, d) for t, now, d in _stream()]
    assert decisions["port"] == decisions["jax"]
    mine = decisions["port"]
    assert all(ok for ok, (t, _, _) in zip(mine, _stream()) if t == 0)
    if name != "static":
        assert not all(mine)


def test_admission_registry_and_errors():
    assert PO.list_admissions() == JO.list_admissions()
    assert set(PO.__all__) == set(JO.__all__)
    _both_raise(lambda O: O.resolve_admission("nope"))
    _both_raise(lambda O: O.CoDelAdmission(target_delay_s=0.0))
    _both_raise(lambda O: O.TokenBucketAdmission(rate=1.0, burst=0.5))


LADDERS = {
    "default": lambda O: dict(),
    "fast": lambda O: dict(delay_target_s=2e-3, enter_after=2, exit_after=3),
    "floor": lambda O: dict(capacity_floor=0.8, transition_energy_j=0.2),
    "bench": lambda O: dict(
        delay_target_s=2e-3,
        stages=(
            O.BrownoutStage("shrink_floors", batch_demand_scale=0.5),
            O.BrownoutStage(
                "stretch_deadlines", batch_demand_scale=0.35, deadline_stretch=2.0
            ),
            O.BrownoutStage(
                "shed", batch_demand_scale=0.25, deadline_stretch=2.0, shed_batch=True
            ),
        ),
    ),
}


@pytest.mark.parametrize("name", list(LADDERS))
def test_brownout_ladder(name):
    def drive(O):
        ctl = O.BrownoutController(**LADDERS[name](O))
        log = []
        for i, (tier, now, delay) in enumerate(_stream()):
            healthy = 0.5 if 200 <= i < 260 else 1.0
            changed = ctl.observe(now, delay, healthy)
            stage = ctl.stage
            log.append(
                (
                    changed,
                    stage.name if stage is not None else None,
                    ctl.shed(tier),
                    ctl.stretch_deadline(tier, now, now + 1e-3),
                )
            )
        return log, dataclasses.astuple(ctl.report())

    mine, theirs = drive(PO), drive(JO)
    assert mine == theirs
    assert mine[1][1] > 0  # the ladder moved


BAD_STAGES = {
    "cap": lambda O: O.BrownoutStage("x", batch_bw_cap=1.5),
    "scale": lambda O: O.BrownoutStage("x", batch_demand_scale=0.0),
    "stretch": lambda O: O.BrownoutStage("x", deadline_stretch=0.5),
    "no_stages": lambda O: O.BrownoutController(stages=()),
    "target": lambda O: O.BrownoutController(delay_target_s=0.0),
    "hysteresis": lambda O: O.BrownoutController(enter_after=0),
    "floor": lambda O: O.BrownoutController(capacity_floor=1.5),
    "energy": lambda O: O.BrownoutController(transition_energy_j=-1.0),
}


@pytest.mark.parametrize("case", list(BAD_STAGES))
def test_brownout_validation(case):
    _both_raise(BAD_STAGES[case])


# ---------------------------------------------------------------------------
# armed serve runs
# ---------------------------------------------------------------------------

ARR = dict(rate=60000.0, horizon=0.01, pool="light", slo_s=0.004, tiers=(0, 1, 1))
FLEET = dict(n_arrays=4, dispatch="jsq", max_concurrent=4, queue_cap=8, seed=1)
ARMS = {
    "static": lambda O, X: dict(admission="static"),
    "codel": lambda O, X: dict(admission="codel"),
    "token_bucket": lambda O, X: dict(admission=O.TokenBucketAdmission(rate=2e3)),
    "brownout": lambda O, X: dict(brownout=True),
    "brownout_fast": lambda O, X: dict(
        brownout=O.BrownoutController(delay_target_s=1e-3, enter_after=2)
    ),
    "both": lambda O, X: dict(admission="codel", brownout=True),
    "with_faults": lambda O, X: dict(
        brownout=O.BrownoutController(capacity_floor=0.9, delay_target_s=1e-3),
        admission="token_bucket",
        faults=X.FaultPlan.single("blackout", t=0.003, node=1, duration_s=0.004),
        recovery=X.RetryRestart(shed_below={1: 0.8}),
    ),
    "moca_caps": lambda O, X: dict(brownout=True, memory=True),
}


@pytest.mark.parametrize("policy", ["width_aware", "equal", "moca"])
@pytest.mark.parametrize("arm", list(ARMS))
def test_overload_armed_serve(arm, policy):
    runs = {}
    for key, pkg in PKGS:
        kw = ARMS[arm](pkg.overload, pkg.chaos)
        runs[key] = pkg.traffic.TrafficSimulator(
            "mmpp", policy=policy, keep_trace=True, **kw, **FLEET, **ARR
        ).run()
    _same(runs["jax"], runs["port"])
    mine, theirs = runs["port"], runs["jax"]
    assert mine.overload == theirs.overload and mine.overload
    if theirs.brownout is not None:
        report = dataclasses.astuple(theirs.brownout)
        assert dataclasses.astuple(mine.brownout) == report
    sched = [[dataclasses.astuple(e) for e in s.trace] for s in theirs.schedules]
    assert [[dataclasses.astuple(e) for e in s.trace] for s in mine.schedules] == sched
    assert 0 not in (mine.metrics.shed_by_tier or {})


def test_overload_knobs_through_serve_config():
    """``OverloadConfig`` and the flat keywords arm the same run."""
    runs = []
    for pkg in (repro, repro_torch):
        A = pkg.api
        cfg = A.ServeConfig(
            scheduling=A.SchedulingConfig(**FLEET),
            overload=A.OverloadConfig(admission="codel", brownout=True),
        )
        runs.append(A.Session("width_aware").serve("mmpp", config=cfg, **ARR))
    flat = repro_torch.api.Session("width_aware").serve(
        "mmpp", admission="codel", brownout=True, **FLEET, **ARR
    )
    _same(runs[0], runs[1])
    _same(runs[1], flat)


# ---------------------------------------------------------------------------
# the card's overload cells
# ---------------------------------------------------------------------------


def test_overload_cells_at_cut_size():
    """static / codel / brownout on the overdriven cell, then the sharded
    respawn cell (abort without respawn, serial == forked with it)."""
    theirs = C.overload_cells("repro", jobs=240, parallel=False)
    mine = C.overload_cells("repro_torch", jobs=240, parallel=True)
    assert mine == theirs
    assert mine["respawn"]["recovery"] == "pod_respawn"


@pytest.mark.parametrize("parallel", [False, True])
@pytest.mark.parametrize("n_shards", [1, 2])
def test_sharded_respawn_overdriven(n_shards, parallel):
    """The respawn cell's shape over the shard counts and both pod modes."""
    runs = {}
    for key, pkg in PKGS:
        kill = pkg.chaos.FaultEvent(t=0.0, kind="pod_kill", node=0, epoch=1)
        runs[key] = pkg.traffic.ShardedTrafficSimulator(
            "poisson",
            n_arrays=4,
            n_shards=n_shards,
            dispatch="rr",
            max_concurrent=4,
            queue_cap=8,
            sync_every=64,
            parallel=parallel and key == "port",
            pod_timeout_s=60.0,
            faults=kill,
            respawn=True,
            **ARR,
        ).run()
    _same(runs["jax"], runs["port"])


def test_golden_overload_section_regenerates_from_jax():
    with open(GOLDEN) as f:
        golden = json.load(f)["overload"]
    assert C._jsonable(C.overload_cells("repro", parallel=False)) == golden
    assert C._jsonable(C.overload_cells("repro_torch")) == golden
    arms = {a: golden[a] for a in ("static", "codel", "brownout")}
    assert arms["brownout"]["brownout_transitions"] > 0
    p99 = {a: arms[a]["tier0_p99_latency_s"] for a in arms}
    assert p99["brownout"] < p99["static"]
