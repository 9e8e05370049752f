"""Nothing the benchmark runs imports JAX or the JAX package ``repro``
(top-level names compared whole, so ``repro_torch`` passes); the reference
imports nothing of the program; nothing reads ``benchmarks/``."""

import ast
import json
import subprocess
import sys

import pytest

from cardbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in harness.HERE.rglob("*.py") if "tests" not in p.parts)


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", SOURCES, ids=lambda p: str(p.relative_to(harness.HERE))
)
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not FORBIDDEN & set(_imported(path))
    assert "benchmarks/" not in path.read_text()


@pytest.mark.parametrize(
    "path", sorted((harness.HERE / "references").glob("*.py")), ids=lambda p: p.name
)
def test_the_reference_imports_nothing_of_the_program(path):
    names = set(_imported(path))
    assert not names & (FORBIDDEN | {"repro_torch", "cardbench"})
    assert names <= {"__future__", "contextlib", "math", "numpy", "torch"}


def test_the_scan_compares_whole_names():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")


def test_the_run_path_loads_neither_jax_nor_the_jax_package():
    """Everything a run loads, in a fresh interpreter: the harness, every
    part every cell names, the program's kernels."""
    code = f"""
import json, sys
sys.path[:0] = [{str(harness.REPO / "src")!r}, {str(harness.REPO)!r}]
import cardbench.run
from cardbench import harness, trace, roofline, faults
bench = harness.benchmark()
for c in bench["workloads"]:
    cfg, mx = harness.config(c["config"]), harness.mix(c["traffic"])
    harness.module("drivers", mx["driver"])
    harness.module("references", cfg["reference"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        harness.module("metrics", m["name"])
import repro_torch.kernels
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.kernels" in mods
    assert not sorted(m for m in mods if m.split(".")[0] in FORBIDDEN)
