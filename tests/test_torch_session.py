"""The port's front door against the JAX package's: ``Session(policy,
"sim").run(workload)`` for every registered policy on both Table-1
workloads, held equal with ``==`` (no tolerance), the golden seed traces
hex for hex, the registries, and the Fig. 9 report text.
"""

import importlib
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro.api as J
import repro.sim.runner as JR
import repro_torch.api as P
import repro_torch.sim.runner as PR
from repro_torch.core.dnng import LayerShape, chain
from repro_torch.sim import workloads as PW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
WORKLOADS = ["heavy", "light"]
POLICIES = J.list_policies()


def _events(res):
    return [
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
    ]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("policy", POLICIES)
def test_session_run_matches_jax(policy, workload):
    mine = P.Session(policy=policy, backend="sim").run(workload)
    theirs = J.Session(policy=policy, backend="sim").run(workload)
    assert mine.as_dict() == theirs.as_dict()
    assert mine.partitioned_energy.as_dict() == theirs.partitioned_energy.as_dict()
    assert mine.baseline_energy.as_dict() == theirs.baseline_energy.as_dict()
    pairs = [(mine.partitioned, theirs.partitioned), (mine.baseline, theirs.baseline)]
    for m, t in pairs:
        assert _events(m) == _events(t)
        assert m.completion == t.completion and list(m.completion) == list(t.completion)
        assert (m.makespan, m.busy_pe_seconds, m.preemptions, m.bus_stall_s) == (
            t.makespan,
            t.busy_pe_seconds,
            t.preemptions,
            t.bus_stall_s,
        )
    # every number is a Python float, so hex() and JSON match the reference
    for k, v in mine.as_dict().items():
        if k not in ("workload", "policy", "backend", "partition_histogram"):
            assert type(v) is float, k
    assert json.dumps(mine.as_dict()) == json.dumps(theirs.as_dict())


@pytest.mark.parametrize("policy", POLICIES)
def test_run_all_matches_jax(policy):
    mine = P.Session(policy=policy, backend="sim").run_all()
    theirs = J.Session(policy=policy, backend="sim").run_all()
    assert list(mine) == list(theirs) == sorted(PW.WORKLOADS)
    assert {k: r.as_dict() for k, r in mine.items()} == {
        k: r.as_dict() for k, r in theirs.items()
    }
    one = P.Session(policy=policy, backend="sim").run_all(["light"])
    assert list(one) == ["light"]
    assert one["light"].as_dict() == theirs["light"].as_dict()


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_policy_beats_sequential(workload):
    for pol in P.list_policies():
        res = P.Session(policy=pol, backend="sim").run(workload)
        assert res.policy == pol
        assert set(res.partitioned.completion) == set(res.baseline.completion)
        assert res.turnaround_saving > 0 or res.time_saving > 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_equal_reproduces_seed_trace_hex_for_hex(workload):
    """`equal` is Algorithm 1 verbatim: the port reproduces the golden trace
    the JAX package's tests hold it to, bit for bit."""
    with open(os.path.join(DATA, f"seed_trace_{workload}.json")) as f:
        golden = json.load(f)
    dyn = P.Session(policy="equal", backend="sim").run(workload).partitioned
    assert dyn.makespan.hex() == golden["makespan"]
    assert {k: v.hex() for k, v in dyn.completion.items()} == golden["completion"]
    assert len(dyn.trace) == len(golden["trace"])
    for e, g in zip(dyn.trace, golden["trace"]):
        got = (
            e.tenant,
            e.layer_index,
            e.layer_name,
            e.partition.rows,
            e.partition.col_start,
            e.partition.cols,
            e.start.hex(),
            e.end.hex(),
            e.compute_start.hex(),
            e.compute_end.hex(),
        )
        want = tuple(
            g[k]
            for k in (
                "tenant",
                "layer_index",
                "layer_name",
                "rows",
                "col_start",
                "cols",
                "start",
                "end",
                "compute_start",
                "compute_end",
            )
        )
        assert got == want


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("policy", ["paper", "equal", "width_aware", "min_cost_flow"])
def test_format_report_text_matches(policy, workload):
    mine = PR.format_report(PR.run_experiment(workload, policy=policy))
    assert mine == JR.format_report(JR.run_experiment(workload, policy=policy))


def _run_module(module, code):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code.format(module=module)],
        capture_output=True,
        text=True,
        env=env,
        cwd=ROOT,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout


_RUN_MAIN = """
import runpy, sys
runpy.run_module("{module}", run_name="__main__")
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro")))
"""


def test_runner_prints_the_same_report_without_jax():
    """``python -m repro_torch.sim.runner`` prints ``python -m
    repro.sim.runner``'s text, and imports neither jax nor repro."""
    mine = _run_module("repro_torch.sim.runner", _RUN_MAIN).splitlines()
    theirs = _run_module("repro.sim.runner", _RUN_MAIN).splitlines()
    assert mine[:-1] == theirs[:-1]
    assert "== workload: heavy (policy: equal) ==" in mine
    assert mine[-1] == "[]"


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------


def test_policy_and_backend_registries():
    assert P.list_policies() == J.list_policies()
    assert len(P.list_policies()) == 9
    assert P.list_backends() == ["mesh", "sim"] == J.list_backends()
    assert P.get_policy("paper").name == "equal"
    assert isinstance(P.resolve_backend("sim"), P.Accelerator)
    assert isinstance(P.resolve_backend("mesh"), P.Accelerator)


@pytest.mark.parametrize("name", ["equl", "Equal", "drff"])
def test_typo_policy_lists_the_registry(name):
    with pytest.raises(ValueError) as e:
        P.Session(policy=name)
    msg = str(e.value)
    assert name in msg and all(p in msg for p in P.list_policies())


@pytest.mark.parametrize("name", ["simm"])
def test_unknown_backend_lists_the_registry(name):
    match = r"unknown backend .*registered: \['mesh', 'sim'\]"
    with pytest.raises(ValueError, match=match):
        P.Session(backend=name)


# the JAX package's MeshLatencyModel defaults, passed explicitly: the
# port's own defaults are the H100's
JAX_MESH = dict(
    device_flops=90e12, ici_bw_bytes=45e9, host_bw_bytes=50e9, launch_overhead_s=5e-6
)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("policy", POLICIES)
def test_mesh_backend_matches_jax(policy, workload):
    from repro.distributed.tenancy import MeshLatencyModel as JM
    from repro_torch.distributed.tenancy import MeshLatencyModel as PM

    mine = P.Session(policy, "mesh", latency=PM(**JAX_MESH)).run(workload)
    theirs = J.Session(policy, "mesh", latency=JM(**JAX_MESH)).run(workload)
    assert mine.as_dict() == theirs.as_dict()
    assert mine.partitioned_energy is None and mine.baseline_energy is None
    pairs = [(mine.partitioned, theirs.partitioned), (mine.baseline, theirs.baseline)]
    for m, t in pairs:
        assert _events(m) == _events(t)


def test_mesh_backend_geometry_and_defaults():
    from repro_torch.distributed.tenancy import MeshLatencyModel

    mesh = P.MeshBackend(n_cols=4, rows=2)
    assert (mesh.array.rows, mesh.array.cols) == (2, 4)
    assert mesh.stage_model().dram_bw_bytes == mesh.latency.host_bw_bytes
    default = MeshLatencyModel()
    for name, tpu in JAX_MESH.items():
        assert getattr(default, name) != tpu, name
    res = P.Session("equal", "mesh").run("light")
    assert res.backend == "mesh" and res.partitioned.makespan > 0


def test_bad_policy_and_backend_objects_rejected():
    with pytest.raises(ValueError, match="not a PartitionPolicy"):
        P.Session(policy=object())
    with pytest.raises(ValueError, match="not a backend"):
        P.Session(backend=object())
    with pytest.raises(ValueError, match="kwargs only apply"):
        P.Session(backend=P.SimBackend(), clock=1.0)


def test_policy_instances_and_kwargs():
    pol = P.get_policy("moca", tier0_guarantee=0.5)
    assert P.Session(policy=pol).policy is pol
    with pytest.raises(ValueError, match="tier0_guarantee"):
        P.get_policy("moca", tier0_guarantee=1.0)
    with pytest.raises(ValueError, match="max_width_factor"):
        P.get_policy("min_cost_flow", max_width_factor=0.5)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_split_and_place_match_jax(policy, n):
    """Every policy's whole-array split, on demands that carry layers."""
    import numpy as np

    from repro.core.dnng import LayerShape as JLayer

    rng = np.random.default_rng(n)
    specs = [
        (f"t{i}", int(m), int(f), int(t))
        for i, (m, f, t) in enumerate(
            zip(rng.integers(8, 600, n), rng.integers(1, 4, n), rng.integers(0, 2, n))
        )
    ]
    md = [
        P.TenantDemand(
            name=a,
            demand=float(m * 100),
            width_demand=min(m, 128),
            min_cols=f,
            tier=t,
            layer=LayerShape.fc(a, 256, m, batch=64),
        )
        for a, m, f, t in specs
    ]
    jd = [
        J.TenantDemand(
            name=a,
            demand=float(m * 100),
            width_demand=min(m, 128),
            min_cols=f,
            tier=t,
            layer=JLayer.fc(a, 256, m, batch=64),
        )
        for a, m, f, t in specs
    ]
    mine, theirs = P.get_policy(policy), J.get_policy(policy)
    arr_p, arr_j = P.SimBackend().array, J.SimBackend().array
    assert [str(p) for p in mine.split(arr_p, md)] == [
        str(p) for p in theirs.split(arr_j, jd)
    ]
    assert {k: str(v) for k, v in mine.place(arr_p, md).items()} == {
        k: str(v) for k, v in theirs.place(arr_j, jd).items()
    }
    assert mine.widths(128, md) == theirs.widths(128, jd)


# ---------------------------------------------------------------------------
# Session surface
# ---------------------------------------------------------------------------


def test_shared_baseline_and_its_checks():
    s = P.Session(policy="best_fit")
    base = s.run_baseline("light")
    shared = s.run("light", baseline=base)
    assert shared.as_dict() == s.run("light").as_dict()
    assert shared.as_dict() == J.Session(policy="best_fit").run("light").as_dict()
    with pytest.raises(ValueError, match="baseline is for workload"):
        s.run("heavy", baseline=base)
    gs = [chain("a", [LayerShape.fc("l", 64, 64, batch=8)])]
    other = s.run_baseline(gs)
    with pytest.raises(ValueError, match="baseline covers DNNGs"):
        s.run([chain("b", [LayerShape.fc("l", 64, 64, batch=8)])], baseline=other)


def test_compare_baseline_off_and_custom_workloads():
    res = P.Session().run("light", compare_baseline=False)
    assert res.baseline is None and res.time_saving == 0.0
    assert res.energy_saving == 0.0 and res.turnaround_saving == 0.0
    gs = [chain("a", [LayerShape.fc("l", 64, 64, batch=8)])]
    res = P.Session().run(gs)
    assert res.workload == "custom" and len(res.partitioned.trace) == 1
    with pytest.raises(ValueError, match="unknown workload"):
        P.Session().run("nonesuch")
    with pytest.raises(ValueError, match="sequence of DNNGs"):
        P.Session().run([1, 2])


def test_workloads_read_at_call_time(monkeypatch):
    monkeypatch.setitem(PW.WORKLOADS, "tiny", lambda: PW.light_workload()[:2])
    res = P.Session().run("tiny")
    assert res.workload == "tiny" and len(res.partitioned.completion) == 2


def test_serve_names_its_roadmap_item():
    """Serving runs, and ``Session().serve(..., obs=True)`` (once a knob
    whose subsystem was not ported) equals the JAX package's run, its
    timeline digest and Perfetto trace included."""
    res = P.Session().serve("poisson", rate=2000.0, horizon=0.01)
    assert res.metrics.jobs_arrived > 0
    kw = dict(rate=3000.0, horizon=0.01, obs=True, keep_trace=True)
    runs = []
    for pkg, api in (("repro_torch", P), ("repro", J)):
        # the oracle-calls-per-event gauge reads process-global caches
        df = importlib.import_module(f"{pkg}.core.dataflow")
        systolic = importlib.import_module(f"{pkg}.sim.systolic")
        df.ws_cost_cache_clear()
        systolic.layer_cost.cache_clear()
        systolic._BatchTimeOracle.clear_all()
        runs.append(api.Session().serve("poisson", **kw))
    mine, theirs = runs
    assert json.dumps(mine.as_dict()) == json.dumps(theirs.as_dict())
    assert "obs" in mine.as_dict()
    trace = mine.timeline.chrome_trace()
    assert json.dumps(trace) == json.dumps(theirs.timeline.chrome_trace())


def test_top_level_lazy_exports():
    import repro_torch

    assert repro_torch.Session is P.Session
    assert repro_torch.list_policies is P.list_policies
    assert {"Session", "list_policies"} <= set(dir(repro_torch))
    with pytest.raises(AttributeError):
        repro_torch.nonesuch  # noqa: B018
