"""The port's rules: no JAX, nothing of ``repro``, and CUDA by default."""

import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(path):
    """Imports of jax or repro, and any use of a name ``jax``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            if isinstance(node, ast.Name) and node.id == "jax":
                bad.append(f"line {node.lineno}: name jax")
            continue
        for m in mods:
            top = m.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"line {node.lineno}: import {m}")
    return bad


# the paper path's modules: host Python + NumPy, no kernel
PAPER_PATH = [
    "api/backend.py",
    "api/policy.py",
    "api/session.py",
    "core/dataflow.py",
    "core/dnng.py",
    "core/partition.py",
    "core/scheduler.py",
    "fairness/__init__.py",
    "fairness/drf.py",
    "fairness/flow.py",
    "sim/energy.py",
    "sim/runner.py",
    "sim/systolic.py",
    "sim/workloads.py",
]

# the open-loop serving path's modules: host Python, no kernel
SERVE_PATH = [
    "api/config.py",
    "fairness/accounting.py",
    "traffic/__init__.py",
    "traffic/arrivals.py",
    "traffic/cluster.py",
    "traffic/metrics.py",
    "traffic/rebalance.py",
    "traffic/sharded.py",
    "traffic/simulator.py",
]

# fault injection, overload control and observability: host Python, no kernel
RESILIENCE_PATH = [
    "chaos/__init__.py",
    "chaos/controller.py",
    "chaos/faults.py",
    "chaos/monitor.py",
    "chaos/recovery.py",
    "obs/__init__.py",
    "obs/export.py",
    "obs/registry.py",
    "obs/render.py",
    "obs/tracer.py",
    "overload/__init__.py",
    "overload/admission.py",
    "overload/brownout.py",
]


def test_scan_sees_every_module():
    files = _port_files()
    assert os.path.join(ROOT, "chip_smoke.py") in files
    for rel in PAPER_PATH + SERVE_PATH + RESILIENCE_PATH:
        assert os.path.join(PORT, *rel.split("/")) in files, rel
    assert len(files) >= 56


def test_front_door_imports_no_jax_and_no_repro():
    """In a fresh interpreter, the front door runs a workload without
    pulling ``jax`` or any ``repro`` module into ``sys.modules``."""
    code = (
        "import sys\n"
        "import repro_torch.api\n"
        "from repro_torch.api import Session\n"
        "res = Session('equal').run('light')\n"
        "assert res.partitioned.makespan > 0\n"
        "srv = Session('drf').serve('poisson', rate=2e3, horizon=0.01, fairness=True)\n"
        "assert srv.metrics.jobs_arrived > 0\n"
        "from repro_torch import FaultPlan\n"
        "plan = FaultPlan.single('crash', t=0.004, node=1)\n"
        "srv = Session('equal').serve('poisson', rate=4e3, horizon=0.01, n_arrays=2,"
        " faults=plan, brownout=True, admission='codel', obs=True)\n"
        "assert srv.chaos.faults_injected == 1 and srv.timeline.chrome_trace()\n"
        "from repro_torch.obs.render import snapshot_host_caches\n"
        "assert 'kernel.autotune.hits' in snapshot_host_caches().counters\n"
        "assert Session('equal', 'mesh').run('light').partitioned.makespan > 0\n"
        "assert len(repro_torch.api.list_policies()) == 9\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        env=env,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_no_repro_imports(path):
    assert _forbidden(path) == []


def test_scan_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom repro.core import dnng\nx = jax\n")
    assert len(_forbidden(str(src))) == 3


def _creating_calls():
    from repro_torch.configs import get
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model import init_cache, init_params
    from repro_torch.serving.kv_cache import DecodeSession

    cfg = get("llama3.2-3b").smoke
    return {
        "init_params": lambda: init_params(cfg),
        "init_cache": lambda: init_cache(cfg, 1, 8),
        "params_from_jax": lambda: params_from_jax({"w": [[1.0]]}),
        "DecodeSession": lambda: DecodeSession(cfg, {}, 1, 8),
    }


@pytest.mark.parametrize(
    "entry", ["init_params", "init_cache", "params_from_jax", "DecodeSession"]
)
def test_creating_entry_points_default_to_cuda(entry, monkeypatch):
    """Without ``device=`` an entry point that creates tensors targets
    CUDA, and raises where there is none — never a quiet CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _creating_calls()[entry]()


def test_kernel_wrapper_never_falls_back_on_an_unknown_device():
    from repro_torch.kernels import partitioned_matmul

    xs = torch.zeros((1, 128, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        partitioned_matmul(xs, torch.zeros((128, 128), device="meta"), [0], [128])
