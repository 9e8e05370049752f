"""The GLM-4.7-Flash prefill cell on the CPU: a tiny copy of it runs correct,
the float8 control and every planted fault come out not correct, the frozen
reference is the repository's, the per-span trace reading and the FLOP
arithmetic of a round are pinned.  The card's own readings are in PERF.md
§2."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from cardbench import glm_faults, glm_roofline, harness, roofline

REF = harness.module("references", "glm4_moe_lite_f32")
DRIVER = harness.module("drivers", "glm_prefill_rounds")
CELL = "glm-4.7-flash-prefill-16k"
# a tiny GLM-4.7-Flash: the published head structure (MLA with its nope,
# rope and v split and a shared rope key, a dense layer 0, MoE layers with a
# shared expert, an untied head), 8 routed experts, 2 prompts of 16 tokens
TINY = dict(
    vocab_size=256, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
    num_attention_heads=4, num_key_value_heads=4, q_lora_rank=48, kv_lora_rank=32,
    qk_nope_head_dim=24, qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
    num_hidden_layers=4,
)
LAYERS, MOE_LAYERS = 4, 3


def tiny_root(tmp_path):
    """``tmp_path`` holding the drivers, metrics and references, a tiny
    copy of the cell's configuration and mix; returns ``(root, bench,
    cell)``."""
    for kind in ("drivers", "metrics", "references"):
        shutil.copytree(harness.HERE / kind, tmp_path / kind)
    (tmp_path / "configs").mkdir()
    (tmp_path / "mixes").mkdir()
    cfg = {**harness.config("glm-4.7-flash"), **TINY, "name": "tiny"}
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mx = {**harness.mix("prefill-1x16384"), "prompts": 2, "prompt_tokens": 16}
    (tmp_path / "mixes" / "tiny.json").write_text(json.dumps(mx))
    cell = {"name": CELL, "config": "tiny", "traffic": "tiny", "chips": 1}
    return tmp_path, harness.benchmark(), cell


def run_on_cpu(root, bench, cell, *, program=None, trace=False, seed=2**31 + 33):
    return harness.run_cell(
        bench, cell, seed=seed, seconds=0.05, trace=trace, device=torch.device("cpu"),
        t_start=time.perf_counter(), program=program, root=root, out_dir=root / "out",
    )


def test_a_sound_run_is_correct(tmp_path):
    root, bench, cell = tiny_root(tmp_path)
    res, rec = run_on_cpu(root, bench, cell)
    assert res["correct"] and res["failed"] == 0
    assert rec["compared"] == 3 * LAYERS + 1  # op, ffn and output a layer; logits
    # a layer's three MLA calls; the dense FFN's two, or the router, the
    # shared expert's two and the routed experts' two; the head
    assert rec["gemms_per_round"] == 3 * LAYERS + 2 + 5 * MOE_LAYERS + 1
    assert set(res["checks"]) == set(REF.LIMITS)
    assert set(res["metrics"]) == {"workload_ms", "setup_s"}


def test_a_run_of_the_cell_loads_neither_jax_nor_the_jax_package(tmp_path):
    """The tiny cell run whole in a fresh interpreter, as ``run.py`` runs
    it: afterwards no module of JAX or the JAX package is loaded."""
    root, _, _ = tiny_root(tmp_path)
    code = f"""
import sys, time
from pathlib import Path
sys.path[:0] = [{str(harness.REPO / "src")!r}, {str(harness.REPO)!r}]
import torch
from cardbench import harness
cell = {{"name": {CELL!r}, "config": "tiny", "traffic": "tiny", "chips": 1}}
root = Path({str(root)!r})
res, _ = harness.run_cell(
    harness.benchmark(), cell, seed=7, seconds=0.05, trace=False,
    device=torch.device("cpu"), t_start=time.perf_counter(), root=root,
    out_dir=root / "out",
)
assert res["correct"], res
print(harness.forbidden_modules())
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=600
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_control_in_the_program_s_place_is_not_correct(tmp_path):
    root, bench, cell = tiny_root(tmp_path)
    res, rec = run_on_cpu(root, bench, cell, program=REF.control)
    assert not res["correct"]
    assert rec["check"]["max_rel_err"] > REF.LIMITS["max_rel_err"]


@pytest.mark.parametrize("fault", sorted(glm_faults.FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(tmp_path, fault):
    from repro_torch.kernels import fused_tenant_gemm

    root, bench, cell = tiny_root(tmp_path)
    program, plant = glm_faults.FAULTS[fault](fused_tenant_gemm)
    with plant:
        res, rec = run_on_cpu(root, bench, cell, program=program)
    assert not res["correct"]
    over = [k for k, v in rec["check"].items() if v > REF.LIMITS[k]]
    assert over


def test_a_traced_cpu_run_reads_no_device_metric(tmp_path):
    root, bench, cell = tiny_root(tmp_path)
    res, rec = run_on_cpu(root, bench, cell, trace=True)
    assert res["correct"]
    assert res["metrics"] == {}  # no device: no mfu, no roofline
    assert rec["moe"]["armed_layers"] == 4 * MOE_LAYERS == rec["moe"]["layers"]
    assert rec["moe"]["shared_calls"] == 2 * rec["moe"]["layers"]
    assert (root / "out" / "calls.tsv").is_file()
    assert rec["trace"]["mla_kernel_s"] is None


def test_the_frozen_reference_is_the_repository_s():
    from repro_torch.models import glm4_moe_lite, glm4_moe_lite_ref

    cfg = {**harness.config("glm-4.7-flash"), **TINY}
    model = glm4_moe_lite.Glm4MoeLiteConfig.from_config(cfg)
    params = glm4_moe_lite.init_params(model, seed=3, device="cpu")
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator().manual_seed(3))
    mine, chosen = REF.forward(params, cfg, ids)
    theirs, chosen_too = glm4_moe_lite_ref.forward(params, cfg, ids)
    assert torch.equal(mine, theirs)
    assert sorted(chosen) == sorted(chosen_too) == [1, 2, 3]
    assert all(torch.equal(chosen[i], chosen_too[i]) for i in chosen_too)


def test_the_core_in_blocks_is_the_core_whole():
    """The reference's attention core in blocks of query rows gives what one
    block over the whole prompt gives."""
    from repro_torch.models import glm4_moe_lite

    cfg = {**harness.config("glm-4.7-flash"), **TINY}
    model = glm4_moe_lite.Glm4MoeLiteConfig.from_config(cfg)
    p = REF.upcast(glm4_moe_lite.init_params(model, seed=5, device="cpu")["layers"][1])
    x = torch.randn((2 * 16, 64), generator=torch.Generator().manual_seed(5))
    was = REF.BLOCK_ROWS
    try:
        REF.BLOCK_ROWS = 5
        blocks = REF.mla_op(p, cfg, x, 2)
        REF.BLOCK_ROWS = 16
        whole = REF.mla_op(p, cfg, x, 2)
    finally:
        REF.BLOCK_ROWS = was
    assert torch.allclose(blocks, whole, rtol=1e-5, atol=1e-6)


def test_the_round_s_flops_are_pinned():
    cfg = harness.config("glm-4.7-flash")
    parts = glm_roofline.round_flops(cfg, 1, 16384)
    assert {k: round(v / 1e12, 2) for k, v in parts.items()} == {
        "mla_proj": 33.51, "mla_core": 129.2, "dense_ffn": 2.06, "moe": 57.1,
        "shared": 14.22, "head": 0.0, "total": 236.09,
    }
    # the core is 55 % of the round's FLOPs
    assert round(parts["mla_core"] / parts["total"], 2) == 0.55


def test_the_flops_add_up_by_hand_on_a_tiny_config():
    cfg = {**harness.config("glm-4.7-flash"), **TINY}
    T = 2 * 16
    proj = glm_roofline.mla_projections(cfg, T)
    assert proj == {
        "q_a": (T, 64, 48), "kv_a": (T, 64, 32 + 8), "q_b": (T, 48, 4 * 32),
        "kv_b": (T, 32, 4 * (24 + 16)), "o": (T, 4 * 16, 64),
    }
    core = 2 * 2 * 4 * (32 + 16) * 16 * 17 // 2
    assert glm_roofline.mla_core_flops(cfg, 2, 16) == core
    per_layer = 2 * T * (64 * 48 + 64 * 40 + 48 * 128 + 32 * 160 + 64 * 64)
    dense = 2 * T * 64 * 96 * 3
    routed = 2 * T * 64 * 8 + 2 * (4 * T) * 64 * 32 * 3
    shared = 2 * T * 64 * 32 * 3
    head = 2 * 2 * 64 * 256
    parts = glm_roofline.round_flops(cfg, 2, 16)
    assert parts["mla_proj"] == LAYERS * per_layer
    assert parts["mla_core"] == LAYERS * core
    assert parts["dense_ffn"] == dense
    assert parts["moe"] == MOE_LAYERS * routed
    assert parts["shared"] == MOE_LAYERS * shared
    assert parts["head"] == head
    assert parts["total"] == LAYERS * (per_layer + core) + dense + MOE_LAYERS * (
        routed + shared
    ) + head
    bound = sum(roofline.call_bound_s([s], "bfloat16") for s in proj.values())
    assert glm_roofline.mla_bound_s(cfg, 2, 16) == pytest.approx(bound + core / 989e12)


def test_the_call_plan_is_the_program_s():
    from repro_torch.models import glm4_moe_lite

    model = glm4_moe_lite.Glm4MoeLiteConfig.from_config(
        {**harness.config("glm-4.7-flash"), **TINY}
    )
    plan = DRIVER.call_plan(model)
    assert plan[:5] == [(0, "q_a_kv_a"), (0, "q_b_kv_b"), (0, "o_proj"), (0, "w1_w3"),
                        (0, "w2")]
    assert plan[5:12] == [(1, "q_a_kv_a"), (1, "q_b_kv_b"), (1, "o_proj"),
                          (1, "router"), (1, "shared_gate_up"), (1, "shared_down"),
                          (1, "gate_up")]
    assert plan[-1] == (-1, "head") and len(plan) == 3 * 4 + 2 + 5 * 3 + 1


def _event(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_kernels_go_to_the_span_around_their_launch(tmp_path):
    """Kernels are given to the program's span in which the host launched
    them, by correlation id, however late they ran; launches outside the
    traced rounds are left out; a paused layer's open route span takes
    nothing."""
    events = [
        _event("user_annotation", "cardbench.round", 100, 900),
        _event("user_annotation", "repro_torch.moe.route", 110, 700),
        _event("user_annotation", "repro_torch.mla.proj", 120, 50),
        _event("user_annotation", "repro_torch.mla.core", 170, 30),
        _event("user_annotation", "repro_torch.mla.proj", 200, 20),
        _event("user_annotation", "repro_torch.moe.shared", 300, 40),
        _event("user_annotation", "repro_torch.mla.core", 1200, 30),
        _event("cuda_runtime", "cudaLaunchKernel", 130, 2, corr=1),
        _event("cuda_runtime", "cudaLaunchKernel", 180, 2, corr=2),
        _event("cuda_runtime", "cudaLaunchKernel", 210, 2, corr=3),
        _event("cuda_runtime", "cudaLaunchKernel", 310, 2, corr=4),
        _event("cuda_runtime", "cudaLaunchKernel", 500, 2, corr=5),
        _event("cuda_runtime", "cudaLaunchKernel", 1210, 2, corr=6),
        _event("kernel", "compact_kernel", 2000, 10, corr=1),
        _event("kernel", "flash_fwd", 2010, 40, corr=2),
        _event("kernel", "dense_kernel", 2050, 5, corr=3),
        _event("kernel", "compact_kernel", 2055, 7, corr=4),
        _event("kernel", "elementwise", 2062, 3, corr=5),
        _event("kernel", "flash_fwd", 2070, 40, corr=6),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    spans = DRIVER.by_span(path)
    assert spans["repro_torch.mla.proj"] == [2, pytest.approx(15e-6)]
    assert spans["repro_torch.mla.core"] == [1, pytest.approx(40e-6)]
    assert spans["repro_torch.moe.shared"] == [1, pytest.approx(7e-6)]
    assert spans["other"] == [1, pytest.approx(3e-6)]
    assert spans["mla_blocks"] == 1
    assert "repro_torch.moe.route" not in spans


def test_the_mla_roofline_reads_the_bound_over_the_blocks_kernels():
    read = harness.module("metrics", "mla_roofline").read
    assert read({"trace": {"mla_bound_s": 0.3, "mla_kernel_s": 0.6}}) == 50.0
    assert read({"trace": {"mla_bound_s": 0.3, "mla_kernel_s": None}}) is None
    assert read({"trace": None}) is None
    mfu = harness.module("metrics", "glm_mfu").read
    rec = {"peak_flops": 1e12, "trace": {"flops": 5e11, "window_s": 1.0, "busy_s": 0.9}}
    assert mfu(rec) == 50.0
    assert mfu({"trace": {"busy_s": 0.0}}) is None
