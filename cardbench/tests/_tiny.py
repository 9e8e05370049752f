"""A copy of the benchmark's parts with a configuration small enough for a
CPU run, for the tests."""

import json
import shutil
import time

import torch

from cardbench import harness

KINDS = ("drivers", "metrics", "references")


def tiny_root(tmp_path, batch: int = 2):
    """``tmp_path`` holding the drivers, metrics and references, a ``tiny``
    configuration (table1-light with every GEMM cut to at most 64 x 96 x 80,
    at batch 1) and a ``tiny`` mix; returns ``(root, bench, cell)``."""
    for kind in KINDS:
        shutil.copytree(harness.HERE / kind, tmp_path / kind)
    (tmp_path / "configs").mkdir()
    (tmp_path / "mixes").mkdir()
    cfg = harness.config("table1-light")
    cfg["name"] = "tiny"
    for t in cfg["tenants"]:
        t["layers"] = [
            [n, min(T, 64), min(K, 96), min(N, 80)] for n, T, K, N in t["layers"]
        ]
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mx = harness.mix("rounds-b128")
    mx["batch"] = batch
    (tmp_path / "mixes" / "tiny.json").write_text(json.dumps(mx))
    bench = harness.benchmark()
    cell = {"name": "light-b128", "config": "tiny", "traffic": "tiny", "chips": 1}
    return tmp_path, bench, cell


def run_on_cpu(
    root, bench, cell, *, program=None, trace=False, seed=2**31 + 11, seconds=0.05
):
    return harness.run_cell(
        bench,
        cell,
        seed=seed,
        seconds=seconds,
        trace=trace,
        device=torch.device("cpu"),
        t_start=time.perf_counter(),
        program=program,
        root=root,
        out_dir=root / "out",
    )
