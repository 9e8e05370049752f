"""The port's rules: no JAX, nothing of ``repro``, and CUDA by default."""

import ast
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
EXAMPLES = os.path.join(ROOT, "examples_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    files += [
        os.path.join(EXAMPLES, n) for n in os.listdir(EXAMPLES) if n.endswith(".py")
    ]
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


# the full-sequence paths and the single-card training path
TRAIN_PATH = [
    "_tree.py",
    "distributed/compression.py",
    "distributed/sharding.py",
    "launch/__init__.py",
    "launch/mesh.py",
    "launch/train.py",
    "models/layers.py",
    "models/model.py",
    "training/__init__.py",
    "training/checkpoint.py",
    "training/data.py",
    "training/optimizer.py",
    "training/train_loop.py",
]


# the launch layer: the dry run's steps, HLO-text analysis, the serve CLI
LAUNCH_PATH = [
    "launch/dryrun.py",
    "launch/hlo_analysis.py",
    "launch/serve.py",
    "launch/steps.py",
]


def test_scan_sees_every_module():
    files = _port_files()
    assert os.path.join(ROOT, "chip_smoke.py") in files
    assert os.path.join(EXAMPLES, "quickstart.py") in files
    paths = PAPER_PATH + SERVE_PATH + RESILIENCE_PATH + TRAIN_PATH + LAUNCH_PATH
    for rel in paths:
        assert os.path.join(PORT, *rel.split("/")) in files, rel
    assert len(files) >= 72


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
    from repro_torch.distributed.tenancy import device_grid
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model import init_cache, init_params
    from repro_torch.serving.kv_cache import DecodeSession
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.train_loop import init_sharded

    cfg = get("llama3.2-3b").smoke
    card = Mesh(device_grid("cuda", 1), ("data", "model"))  # what make_host_mesh gives
    sys.path.insert(0, ROOT)
    from examples_torch import multi_tenant_serving, partitioned_training, quickstart

    return {
        "init_params": lambda: init_params(cfg),
        "init_cache": lambda: init_cache(cfg, 1, 8),
        "params_from_jax": lambda: params_from_jax({"w": [[1.0]]}),
        "DecodeSession": lambda: DecodeSession(cfg, {}, 1, 8),
        "init_sharded": lambda: init_sharded(cfg, card),
        "make_batch": lambda: make_batch(DataConfig(cfg.vocab, 2, 8), 0),
        "make_host_mesh": lambda: make_host_mesh(),
        "launch.train.main": lambda: train.main(["--smoke", "--steps", "1"]),
        "launch.serve.main": lambda: serve.main(["--requests", "1"]),
        "examples_torch/multi_tenant_serving": lambda: multi_tenant_serving.main([]),
        "examples_torch/partitioned_training": lambda: partitioned_training.main([]),
        "examples_torch/quickstart": lambda: quickstart.main([]),
    }


@pytest.mark.parametrize(
    "entry",
    [
        "init_params",
        "init_cache",
        "params_from_jax",
        "DecodeSession",
        "init_sharded",
        "make_batch",
        "make_host_mesh",
        "launch.train.main",
        "launch.serve.main",
        "examples_torch/multi_tenant_serving",
        "examples_torch/partitioned_training",
        "examples_torch/quickstart",
    ],
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


# ---------------------------------------------------------------------------
# the port's public signatures against the reference's
# ---------------------------------------------------------------------------

# parameter names the port renames on purpose, each with its reason
RENAMED = {
    "key": ("gen", "initialisers draw from a torch.Generator (or the meta "
            "device) where JAX threads a PRNG key"),
    "axis_name": ("group", "a collective names its process group where JAX "
                  "names a mesh axis inside shard_map"),
}
# parameters only the port has, each with its reason
PORT_ONLY = {
    "device": "an entry point that creates tensors takes its device (CUDA by "
    "default) where JAX uses its default device",
    "lead": "an initialiser draws stacked weights (layers, experts) as one "
    "leaf where JAX vmaps it",
    "live": "decode_step leaves dead rows' cache as it was (the engine's "
    "ragged batches)",
    "grad_norm": "AdamW takes the norm the sharded step reduced over the mesh",
    "lend": "loss_and_grads takes the sharded step's lending of the params",
}
# parameters only the reference has: TPU-only
JAX_ONLY = {
    "interpret": "Pallas's interpret mode; on a CPU tensor the port's "
    "wrappers compute the plain version",
    "vmem_budget_bytes": "a Pallas block's VMEM budget; the CUDA kernels' "
    "tiles are fixed",
}
# names whose difference no rule above covers: (reference's parameters,
# the port's, the reason); None where the port has no such name
ACCEPTED = {
    "repro.models.model.init_params": (
        ["cfg", "key"], ["cfg", "seed", "device"],
        "the port seeds its generator from an int where JAX takes a key",
    ),
    "repro.models.layers.init_rmsnorm": (
        ["dim"], ["gen", "dim", "lead"],
        "every initialiser takes the generator, so the sharded draw sees "
        "each leaf in its order",
    ),
    "repro.models.layers.init_layernorm": (
        ["dim"], ["gen", "dim", "lead"],
        "every initialiser takes the generator, so the sharded draw sees "
        "each leaf in its order",
    ),
    "repro.launch.steps.Lowerable": (
        ["jitted", "args", "kind", "arch_id", "cell_name"],
        ["step", "args", "in_shardings", "out_shardings", "kind", "arch_id",
         "cell_name", "mesh", "sharded"],
        "the port has no jitted form: it carries the eager step and its "
        "shardings for the dry run's fake-group partition",
    ),
    "repro.kernels.partitioned_matmul.block_vmem_bytes": (
        ["block_t", "block_k", "block_n", "x_dtype", "w_dtype"], None,
        "a Pallas block's VMEM bytes: TPU-only",
    ),
    "repro.kernels.ops.fused_tenant_gemm": (
        ["xs", "ws", "block_t", "block_k", "block_n", "grid_mode",
         "vmem_budget_bytes", "interpret", "return_stats"],
        ["xs", "ws", "block_t", "block_k", "block_n", "grid_mode",
         "return_stats", "epilogue", "row_scale", "out"],
        "the port's expert layer finishes its calls in the kernel's epilogue "
        "(SiLU·up, a row scale, one bf16 buffer), which the reference's "
        "kernel lacks; the TPU-only parameters as JAX_ONLY says",
    ),
}

_SIGNATURES = r"""
import importlib, inspect, json, os, sys
root = sys.argv[1]
out = {}
for dirpath, _, files in os.walk(os.path.join(root, "repro")):
    for f in sorted(files):
        if not f.endswith(".py"):
            continue
        rel = os.path.relpath(os.path.join(dirpath, f), root)[:-3]
        name = rel.replace(os.sep, ".").removesuffix(".__init__")
        mod = importlib.import_module(name)
        port = importlib.import_module("repro_torch" + name[len("repro"):])
        for attr, obj in vars(mod).items():
            public = not attr.startswith("_") and getattr(obj, "__module__", "") == name
            if not (public and (inspect.isfunction(obj) or inspect.isclass(obj))):
                continue
            try:
                mine = list(inspect.signature(obj).parameters)
            except (TypeError, ValueError):
                continue
            other = getattr(port, attr, None)
            theirs = other and list(inspect.signature(other).parameters)
            out[name + "." + attr] = [mine, theirs]
print(json.dumps(out))
"""


def test_public_signatures_match_the_reference():
    """Every public function and class of every ``repro`` module has its
    counterpart in ``repro_torch`` with the same parameter names, but for
    the differences tabled above with their reasons (each used, none
    stale).  Read in a fresh interpreter: importing the reference's dry
    run sets ``XLA_FLAGS`` for the whole process."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _SIGNATURES, os.path.join(ROOT, "src")],
        capture_output=True,
        text=True,
        env=env,
        timeout=600,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    found = json.loads(out.stdout)
    assert len(found) > 200
    used, wrong = set(), []
    for name, (ref, port) in found.items():
        if name in ACCEPTED:
            used.add(name)
            if ACCEPTED[name][:2] != (ref, port):
                wrong.append((name, ref, port))
            continue
        if port is None:
            wrong.append((name, ref, port))
            continue
        # a rename where the port has the new name (``split_by``'s key stays)
        renames = {p for p in ref if p in RENAMED and RENAMED[p][0] in port}
        renamed = [
            RENAMED[p][0] if p in renames else p for p in ref if p not in JAX_ONLY
        ]
        kept = [p for p in port if p not in PORT_ONLY]
        used |= renames | {p for p in ref if p in JAX_ONLY}
        used |= {p for p in port if p in PORT_ONLY}
        if renamed != kept:
            wrong.append((name, ref, port))
    assert wrong == []
    table = set(RENAMED) | set(PORT_ONLY) | set(JAX_ONLY) | set(ACCEPTED)
    assert table - used == set()
    for repaired in (
        "repro.distributed.tenancy.TenantMeshManager",
        "repro.training.train_loop.make_train_step",
    ):
        assert repaired not in ACCEPTED
        assert found[repaired][0] == found[repaired][1]
