"""The comparison that decides ``correct``: the reference agrees with a
plain product, and the control and every planted fault come out not
correct through a whole run on the CPU (the card's own readings are in
PERF.md)."""

import numpy as np
import pytest
import torch

from cardbench import faults, harness
from cardbench.tests._tiny import run_on_cpu, tiny_root

REF = harness.module("references", "gemm_f32")


def _operands(t, k, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((t, k), generator=g).to(torch.bfloat16)
    w = torch.randn((k, n), generator=g).to(torch.bfloat16)
    return x, w


def test_reference_agrees_with_a_plain_float64_product():
    x, w = _operands(300, 257, 70)
    plain = torch.from_numpy(x.double().numpy() @ w.double().numpy()).float()
    assert REF.gap(x, w, plain) < 1e-6
    assert REF.gap(x, w, x.float() @ w.float()) == 0.0


def test_reference_blocks_rows_as_one_product(monkeypatch):
    x, w = _operands(333, 64, 40, seed=1)
    out = torch.from_numpy(x.float().numpy() @ w.float().numpy())
    whole = REF.gap(x, w, out)
    monkeypatch.setattr(REF, "BLOCK_ELEMS", 40 * 7)  # 7 rows a block
    assert REF.gap(x, w, out) == pytest.approx(whole, abs=1e-7)


def test_gap_of_a_wrong_shape_or_a_nan_is_infinite():
    x, w = _operands(16, 8, 4)
    good = x.float() @ w.float()
    assert REF.gap(x, w, good[:15]) == np.inf
    bad = good.clone()
    bad[3, 2] = float("nan")
    assert REF.gap(x, w, bad) == np.inf
    assert REF.gap(x, w, None) == np.inf


def test_control_is_over_the_limit_where_the_program_is_under():
    x, w = _operands(256, 512, 128, seed=3)
    (ctrl,) = REF.control([x], [w])
    limit = REF.LIMITS["max_rel_err"]
    assert REF.gap(x, w, ctrl) > 3 * limit
    assert REF.gap(x, w, x.float() @ w.float()) <= limit


def test_a_sound_run_is_correct(tmp_path):
    root, bench, cell = tiny_root(tmp_path)
    res, rec = run_on_cpu(root, bench, cell)
    assert res["correct"] and res["failed"] == 0
    assert rec["compared"] == 31  # every tenant's output of the round
    assert list(res)[-1] == "checks"
    assert res["checks"]["max_rel_err"]["limit"] == REF.LIMITS["max_rel_err"]


def test_the_control_in_the_program_s_place_is_not_correct(tmp_path):
    root, bench, cell = tiny_root(tmp_path)
    res, rec = run_on_cpu(root, bench, cell, program=REF.control)
    assert not res["correct"] and res["failed"] > 0
    assert rec["check"]["max_rel_err"] > 3 * REF.LIMITS["max_rel_err"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_fault_under_the_timed_path_is_not_correct(tmp_path, fault):
    from repro_torch.kernels import fused_tenant_gemm

    root, bench, cell = tiny_root(tmp_path)
    planted = faults.FAULTS[fault](fused_tenant_gemm)
    res, _ = run_on_cpu(root, bench, cell, program=planted)
    assert not res["correct"]
    assert res["checks"]["max_rel_err"]["value"] > 0.1


def test_a_traced_cpu_run_reports_no_device_metric(tmp_path):
    root, bench, cell = tiny_root(tmp_path)
    res, rec = run_on_cpu(root, bench, cell, trace=True)
    assert res["correct"]
    assert set(res["metrics"]) <= {"enqueue_us"}  # no device: no roofline, idle or mfu
    assert (root / "out" / "trace.json").is_file()
    assert (root / "out" / "waves.tsv").is_file()
    assert rec["trace"]["rounds"] == 18  # ceil(300 launches / 17 waves)
