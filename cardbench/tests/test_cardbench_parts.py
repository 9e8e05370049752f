"""The benchmark's parts are found by name, and BENCHMARK.json keeps to the
shape the harness reads."""

import json
import re

import pytest

from cardbench import harness
from cardbench.tests._tiny import run_on_cpu, tiny_root

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_every_part_of_a_cell_is_found_by_name(cell):
    entry = harness.cell(BENCH, cell)
    cfg = harness.config(entry["config"])
    mx = harness.mix(entry["traffic"])
    assert callable(harness.module("drivers", mx["driver"]).run)
    ref = harness.module("references", cfg["reference"])
    assert callable(ref.worst_gap) and callable(ref.control) and ref.LIMITS
    for trace in (False, True):
        metrics = harness.metrics_for(BENCH, cell, trace)
        assert metrics, "every cell reports end-to-end and per-layer metrics"
        for m in metrics:
            assert callable(harness.module("metrics", m["name"]).read)


def test_a_missing_part_names_its_file():
    with pytest.raises(FileNotFoundError, match="no_such_driver"):
        harness.module("drivers", "no_such_driver")


def test_benchmark_json_has_the_keys_and_names_it_should():
    assert set(BENCH) == {
        *("command", "paths", "run_seconds", "configs"),
        *("workloads", "end_to_end", "per_layer"),
    }
    assert BENCH["command"] == ["python3", "cardbench/run.py"]
    assert BENCH["paths"] == ["cardbench"]
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"cardbench/configs/{c['name']}.json"
        assert harness.config(c["name"])["source"] == c["source"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
    assert {w["config"] for w in BENCH["workloads"]} == set(names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_new_config_file_is_picked_up_without_an_edit(tmp_path):
    root, bench, cell = tiny_root(tmp_path)
    cfg = harness.config("tiny", root)
    cfg["name"] = "tiny-two"
    cfg["tenants"] = cfg["tenants"][:2]
    (root / "configs" / "tiny-two.json").write_text(json.dumps(cfg))
    res, rec = run_on_cpu(root, bench, {**cell, "config": "tiny-two"})
    assert res["correct"]
    assert rec["compared"] == sum(len(t["layers"]) for t in cfg["tenants"])
    assert set(res["metrics"]) == {"workload_ms", "setup_s"}
