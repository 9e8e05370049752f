"""The benchmark's parts, found by name, and a run turned into its result.

``BENCHMARK.json`` at the root of the checkout names the cells.  A cell's
configuration is ``configs/<config>.json``; its traffic mix is
``mixes/<traffic>.json``, whose ``driver`` names ``drivers/<driver>.py``;
the configuration's ``reference`` names ``references/<reference>.py``; each
metric is read by ``metrics/<name>.py`` (``read(record)``, ``None`` where
the run holds nothing to read).  Adding a configuration, a mix, a driver,
a reference or a metric is adding a file: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# top-level module names no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(repo: Path = REPO) -> dict:
    return load_json(repo / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for c in bench["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, root: Path = HERE) -> dict:
    return load_json(root / "configs" / f"{name}.json")


def mix(name: str, root: Path = HERE) -> dict:
    return load_json(root / "mixes" / f"{name}.json")


def module(kind: str, name: str, root: Path = HERE):
    """``<root>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"cardbench_{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is forbidden."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(
    bench,
    cell_entry,
    *,
    seed,
    seconds,
    trace,
    device,
    t_start,
    program=None,
    root=HERE,
    out_dir=None,
):
    """Run one cell once; returns ``(result, record)``.  ``program`` stands
    in for ``repro_torch.kernels.fused_tenant_gemm`` (the tests and the
    control readings plant faults or the control there)."""
    cfg = config(cell_entry["config"], root)
    mx = mix(cell_entry["traffic"], root)
    driver = module("drivers", mx["driver"], root)
    reference = module("references", cfg["reference"], root)
    if program is None:
        from repro_torch.kernels import fused_tenant_gemm as program
    if out_dir is None:
        out_dir = REPO / "build" / "cardbench" / cell_entry["name"] / f"seed{seed}"
    out_dir.mkdir(parents=True, exist_ok=True)
    record = driver.run(
        cfg,
        mx,
        reference,
        seed=seed,
        seconds=seconds,
        trace=trace,
        device=device,
        t_start=t_start,
        program=program,
        out_dir=out_dir,
    )
    metrics = {}
    for m in metrics_for(bench, cell_entry["name"], trace):
        value = module("metrics", m["name"], root).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # a value that is not finite (a NaN output, a missing one) prints as
    # the largest float, over any limit, so the line stays strict JSON
    checks = {
        name: {"value": _finite(record["check"][name]), "limit": limit}
        for name, limit in record["limits"].items()
    }
    within = all(c["value"] <= c["limit"] for c in checks.values())
    correct = record["compared"] > 0 and within
    result = {
        "correct": correct,
        "attempted": record["rounds"] * record["gemms_per_round"],
        "failed": record["failed"],
        "metrics": metrics,
        "device": device_info(device, record, trace),
    }
    tr = record.get("trace")
    if trace and tr:
        result["breakdown"] = {
            "device_ops": tr["device_ops"],
            "idle_gaps": tr["idle_gaps"],
        }
    result["checks"] = checks
    return result, record


def _finite(v: float) -> float:
    return v if math.isfinite(v) else sys.float_info.max


def device_info(device, record: dict, trace: bool) -> dict:
    import torch

    info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if device.type == "cuda":
        info = {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": record["memory_peak_bytes"],
        }
    tr = record.get("trace")
    if trace and tr:
        info["busy_s"] = tr["busy_s"]
        info["window_s"] = tr["window_s"]
    return info
