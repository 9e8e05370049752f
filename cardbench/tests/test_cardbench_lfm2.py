"""The LFM2-MoE prefill cell on the CPU: a tiny copy of it runs correct, the
float8 control and every planted fault come out not correct, the frozen
reference is the repository's, and the FLOP arithmetic of a round is pinned.
The card's own readings are in PERF.md §2."""

import json
import shutil
import time

import pytest
import torch

from cardbench import harness, lfm2_faults, lfm2_roofline

REF = harness.module("references", "lfm2_moe_f32")
CELL = "lfm2-24b-prefill-16k"
# a tiny LFM2-MoE: every kind of layer (dense and MoE FFNs, conv and
# attention ops), 8 experts, 2 prompts of 16 tokens
TINY = dict(
    vocab_size=256, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
    num_attention_heads=4, num_key_value_heads=2, num_experts=8,
    num_hidden_layers=5, layer_types=["conv", "conv", "full_attention", "conv",
                                      "full_attention"],
)


def tiny_root(tmp_path):
    """``tmp_path`` holding the drivers, metrics and references, a tiny
    copy of the cell's configuration and mix; returns ``(root, bench,
    cell)``."""
    for kind in ("drivers", "metrics", "references"):
        shutil.copytree(harness.HERE / kind, tmp_path / kind)
    (tmp_path / "configs").mkdir()
    (tmp_path / "mixes").mkdir()
    cfg = {**harness.config("lfm2-24b-a2b"), **TINY, "name": "tiny"}
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mx = {**harness.mix("prefill-4x4096"), "prompts": 2, "prompt_tokens": 16}
    (tmp_path / "mixes" / "tiny.json").write_text(json.dumps(mx))
    cell = {"name": CELL, "config": "tiny", "traffic": "tiny", "chips": 1}
    return tmp_path, harness.benchmark(), cell


def run_on_cpu(root, bench, cell, *, program=None, trace=False, seed=2**31 + 29):
    return harness.run_cell(
        bench, cell, seed=seed, seconds=0.05, trace=trace, device=torch.device("cpu"),
        t_start=time.perf_counter(), program=program, root=root, out_dir=root / "out",
    )


def test_a_sound_run_is_correct(tmp_path):
    root, bench, cell = tiny_root(tmp_path)
    res, rec = run_on_cpu(root, bench, cell)
    assert res["correct"] and res["failed"] == 0
    assert rec["compared"] == 3 * 5 + 1  # op, ffn and output a layer; logits
    assert rec["gemms_per_round"] == 4 * 2 + 3 * 2 + 3 * 3 + 1
    assert set(res["checks"]) == set(REF.LIMITS)
    assert set(res["metrics"]) == {"workload_ms", "setup_s"}


def test_the_window_waits_for_the_checked_round(tmp_path):
    """A window shorter than the loop's way to its checked round (here the
    last of the first 16, in lane 1) closes at lane 0's first completion
    after the checked round's."""
    root, bench, cell = tiny_root(tmp_path)
    seed = 2_147_500_103  # checked round 15
    res, rec = harness.run_cell(
        bench, cell, seed=seed, seconds=0.0, trace=False, device=torch.device("cpu"),
        t_start=time.perf_counter(), root=root, out_dir=root / "out",
    )
    assert rec["check_round"] == 15
    assert rec["rounds"] == 14  # rounds 3 to 16: the window opens at round 2's end
    assert res["correct"] and all(v < float("inf") for v in rec["check"].values())


def test_the_control_in_the_program_s_place_is_not_correct(tmp_path):
    root, bench, cell = tiny_root(tmp_path)
    res, rec = run_on_cpu(root, bench, cell, program=REF.control)
    assert not res["correct"]
    assert rec["check"]["max_rel_err"] > REF.LIMITS["max_rel_err"]


@pytest.mark.parametrize("fault", sorted(lfm2_faults.FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(tmp_path, fault):
    from repro_torch.kernels import fused_tenant_gemm

    root, bench, cell = tiny_root(tmp_path)
    program, plant = lfm2_faults.FAULTS[fault](fused_tenant_gemm)
    with plant:
        res, rec = run_on_cpu(root, bench, cell, program=program)
    assert not res["correct"]
    over = [k for k, v in rec["check"].items() if v > REF.LIMITS[k]]
    assert over


def test_a_traced_cpu_run_reads_the_host_clock_and_no_device_metric(tmp_path):
    root, bench, cell = tiny_root(tmp_path)
    res, rec = run_on_cpu(root, bench, cell, trace=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"moe_host_us"}  # no device: no mfu, no roofline
    # the lanes take steps in turn, so the profiled span holds as many MoE
    # layers as TRACE_ROUNDS whole rounds
    assert rec["moe"]["armed_layers"] == 4 * 3 == rec["moe"]["layers"]
    assert (root / "out" / "calls.tsv").is_file()


def test_the_frozen_reference_is_the_repository_s():
    from repro_torch.models import lfm2_moe, lfm2_moe_ref

    cfg = {**harness.config("lfm2-24b-a2b"), **TINY}
    model = lfm2_moe.Lfm2MoeConfig.from_config(cfg)
    params = lfm2_moe.init_params(model, seed=3, device="cpu")
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator().manual_seed(3))
    mine, chosen = REF.forward(params, cfg, ids)
    theirs, chosen_too = lfm2_moe_ref.forward(params, cfg, ids)
    assert torch.equal(mine, theirs)
    assert all(torch.equal(chosen[i], chosen_too[i]) for i in chosen_too)


def test_row_gap_reads_shape_and_non_finite_values_as_infinite():
    ref = torch.randn(8, 16)
    assert REF.row_gap(ref.clone(), ref) == 0.0
    assert REF.row_gap(ref[:7], ref) == float("inf")
    assert REF.row_gap(None, ref) == float("inf")
    bad = ref.clone()
    bad[2, 3] = float("nan")
    assert REF.row_gap(bad, ref) == float("inf")
    # each row is its own scale: a small row's error is not hidden
    ref[5] *= 1e-3
    out = ref.clone()
    out[5, 0] += 1e-3 * ref[5].abs().max()
    assert REF.row_gap(out, ref) == pytest.approx(1e-3, rel=1e-3)


def test_the_round_s_flops_are_pinned():
    cfg = harness.config("lfm2-24b-a2b")
    parts = lfm2_roofline.round_flops(cfg, 4, 4096)
    assert round(parts["total"] / 1e12, 1) == 74.6
    assert {k: round(v / 1e12, 2) for k, v in parts.items()} == {
        "conv": 16.49, "attention": 6.19, "attention_core": 2.75,
        "dense_ffn": 4.74, "moe": 47.17, "head": 0.0, "total": 74.59,
    }


def test_the_expert_bound_leaves_empty_experts_out():
    gu, down = lfm2_roofline.expert_calls([3, 0, 5], 2048, 1536)
    assert gu == [(3, 2048, 3072), (5, 2048, 3072)]
    assert down == [(3, 1536, 2048), (5, 1536, 2048)]
    # a layer of 16384 x 4 slots is bound by its FLOPs, as either call is
    one = lfm2_roofline.experts_bound_s([[1024] * 64], 2048, 1536)
    assert one == pytest.approx(3 * 2 * 65536 * 2048 * 1536 / 989e12)
