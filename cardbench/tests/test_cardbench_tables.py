"""The frozen layer tables hold the totals of the paper's Table-1 groups as
lowered at batch 1 when they were copied."""

import pytest

from cardbench import harness

TOTALS = {
    "table1-heavy": (237, 20_545_897_036, [8, 54, 58, 4, 4, 5, 44, 60]),
    "table1-light": (31, 7_407_452_160, [4, 17, 6, 4]),
}


@pytest.mark.parametrize("name", sorted(TOTALS))
def test_frozen_table_totals(name):
    cfg = harness.config(name)
    gemms, macs, counts = TOTALS[name]
    layers = [layer for t in cfg["tenants"] for layer in t["layers"]]
    assert len(layers) == gemms
    assert sum(t * k * n for _, t, k, n in layers) == macs
    assert [len(t["layers"]) for t in cfg["tenants"]] == counts
    assert cfg["reduced"] == [] and cfg["dtype"] == "bfloat16"
    assert len(cfg["source"]) <= 200


@pytest.mark.parametrize(
    "name, waves, tenants_per_wave",
    [
        ("table1-heavy", 60, {0: 8, 4: 6, 5: 5, 8: 4, 44: 3, 54: 2, 58: 1}),
        ("table1-light", 17, {0: 4, 4: 2, 6: 1}),
    ],
)
def test_the_round_drops_finished_tenants(name, waves, tenants_per_wave):
    drv = harness.module("drivers", "gemm_rounds")
    plan = drv.waves(harness.config(name), 128)
    assert len(plan) == waves
    for w, n in tenants_per_wave.items():
        assert len(plan[w]) == n
    assert all(t % 128 == 0 for m in plan for _, (t, _, _) in m)
