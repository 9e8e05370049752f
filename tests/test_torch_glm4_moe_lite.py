"""GLM-4.7-Flash prefill through the fused GEMM
(``repro_torch.models.glm4_moe_lite``, ``.routed_experts`` with its shared
expert) against the plain float32 reference
(``repro_torch.models.glm4_moe_lite_ref``), at small sizes on the CPU with
seeded weights; where the shared expert's calls fall in the expert layer's
steps, and that a layer without one makes the calls it made before; the
MLA spans and the shared expert's counters.

The model is port-only (the JAX package has no GLM): the registry of
architectures stays the JAX package's.  The comparison tolerance is the
repository's bfloat16 one (3e-2 of the reference's largest magnitude): the
program rounds every GEMM output and every activation to bfloat16.
"""

import json
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused_tenant_gemm, set_tracing  # noqa: E402
from repro_torch.models import glm4_moe_lite as M  # noqa: E402
from repro_torch.models import glm4_moe_lite_ref as R  # noqa: E402
from repro_torch.models import routed_experts as moe  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PUBLISHED = json.loads((ROOT / "cardbench/configs/glm-4.7-flash.json").read_text())
BF16_TOL = 3e-2
# the published head structure at a tiny width: MLA with a nope/rope/v split
# and a shared rope key, a dense layer 0, three MoE layers of 8 routed
# experts and a shared one, an untied head
TINY = {
    **PUBLISHED,
    "vocab_size": 256,
    "hidden_size": 64,
    "intermediate_size": 96,
    "moe_intermediate_size": 32,
    "num_attention_heads": 4,
    "num_key_value_heads": 4,
    "q_lora_rank": 48,
    "kv_lora_rank": 32,
    "qk_nope_head_dim": 24,
    "qk_rope_head_dim": 8,
    "v_head_dim": 16,
    "n_routed_experts": 8,
    "num_hidden_layers": 4,
}
MOE_LAYERS = [1, 2, 3]
MLA_SPANS = [M.SPAN_PREFIX + s for s in ("proj", "core")]


def _gap(out, ref):
    return ((out.float() - ref).abs().max() / ref.abs().max()).item()


@pytest.fixture(scope="module")
def tiny():
    cfg = M.Glm4MoeLiteConfig.from_config(TINY)
    return cfg, M.init_params(cfg, seed=21, device="cpu")


@pytest.fixture
def clean_stats():
    was = set_tracing(False)
    moe.reset_moe_stats()
    yield
    moe.reset_moe_stats()
    set_tracing(was)


def _x(T, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((T, d), generator=g).to(torch.bfloat16)


class _Log:
    """``gemm`` with each call logged: its tenants' shapes and keywords."""

    def __init__(self):
        self.calls = []

    def __call__(self, xs, ws, **kw):
        self.calls.append(
            ([tuple(x.shape) for x in xs], [tuple(w.shape) for w in ws], sorted(kw))
        )
        return fused_tenant_gemm(xs, ws, **kw)


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------


def test_the_published_config_reads_whole():
    cfg = M.Glm4MoeLiteConfig.from_config(PUBLISHED)
    assert cfg.num_hidden_layers == 47 and cfg.qk_head_dim == 256
    assert cfg.softmax_scale == 256**-0.5 and cfg.shared_width == 1536
    assert cfg.routed_scaling_factor == 1.8 and cfg.rope_theta == 1e6
    assert not cfg.is_moe(0) and cfg.is_moe(1) and cfg.is_moe(46)
    # 29.94 B parameters, 59.9 GB in bfloat16: the whole model on one card
    shapes = M.param_shapes(cfg)
    leaves = [shapes["embed"], shapes["norm"], shapes["lm_head"]]
    leaves += [s for layer in shapes["layers"] for s in layer.values()]
    assert sum(math.prod(s) for s in leaves) == 29_943_393_920
    lp = shapes["layers"][1]
    assert lp["q_b_proj"] == (768, 20 * 256) and lp["kv_b_proj"] == (512, 20 * 448)
    assert lp["kv_a_proj_with_mqa"] == (2048, 576) and lp["o_proj"] == (5120, 2048)
    assert lp["shared_gate_up"] == (2048, 3072) and lp["gate_up"] == (64, 2048, 3072)
    # only the multi-token-prediction layer is cut
    assert PUBLISHED["reduced"] == ["num_nextn_predict_layers"]
    assert PUBLISHED["num_nextn_predict_layers"] == 0


@pytest.mark.parametrize(
    "change",
    [
        {"tie_word_embeddings": True},
        {"attention_bias": True},
        {"rope_scaling": {"type": "yarn", "factor": 4.0}},
        {"q_lora_rank": None},
        {"n_group": 8, "topk_group": 4},
        {"num_key_value_heads": 4},
        {"partial_rotary_factor": 0.5},
        {"model_type": "deepseek_v3"},
    ],
    ids=lambda c: next(iter(c)),
)
def test_a_config_it_does_not_compute_is_refused(change):
    with pytest.raises(ValueError):
        M.Glm4MoeLiteConfig.from_config({**PUBLISHED, **change})


def test_the_draw_is_seeded_and_scaled(tiny):
    cfg, p = tiny
    again = M.init_params(cfg, seed=21, device="cpu")
    assert torch.equal(p["layers"][2]["kv_b_proj"], again["layers"][2]["kv_b_proj"])
    other = M.init_params(cfg, seed=22, device="cpu")
    assert not torch.equal(p["lm_head"], other["lm_head"])
    sg = p["layers"][2]["shared_gate_up"].float()
    assert sg.std().item() == pytest.approx(64**-0.5, rel=0.1)
    ones = torch.ones(32, dtype=torch.bfloat16)
    assert torch.equal(p["layers"][2]["kv_a_layernorm"], ones)
    assert "shared_gate_up" not in p["layers"][0] and "w1" in p["layers"][0]


# ---------------------------------------------------------------------------
# the blocks against the reference, teacher-forced
# ---------------------------------------------------------------------------


def test_the_mla_block_matches_the_reference(tiny):
    cfg, p = tiny
    x = _x(2 * 16, 64, seed=1)
    out = M.mla_block(p["layers"][1], cfg, x, 2, fused_tenant_gemm)
    with R.full_float32():
        ref = R.mla_op(R.upcast(p["layers"][1]), TINY, x.float(), 2)
    assert out.dtype == torch.bfloat16 and out.shape == (32, 64)
    assert _gap(out, ref) < BF16_TOL


def test_the_mla_block_is_causal_within_each_prompt(tiny):
    cfg, p = tiny
    x = _x(2 * 16, 64, seed=2)
    base = M.mla_block(p["layers"][1], cfg, x, 2, fused_tenant_gemm)
    later = x.clone()
    later[20:] += 1.0  # prompt 1's positions 4.. change
    out = M.mla_block(p["layers"][1], cfg, later, 2, fused_tenant_gemm)
    assert torch.equal(out[:20], base[:20])
    assert not torch.equal(out[20:], base[20:])


def test_the_mla_block_makes_three_calls(tiny):
    """q_a and kv_a in one call, q_b and kv_b in one, o_proj."""
    cfg, p = tiny
    log = _Log()
    M.mla_block(p["layers"][1], cfg, _x(32, 64, seed=3), 2, log)
    assert [(xs, ws) for xs, ws, _ in log.calls] == [
        ([(32, 64), (32, 64)], [(64, 48), (64, 40)]),
        ([(32, 48), (32, 32)], [(48, 128), (32, 160)]),
        ([(32, 64)], [(64, 64)]),
    ]


def test_the_shared_and_routed_layer_matches_the_reference(tiny, clean_stats):
    cfg, p = tiny
    x = _x(32, 64, seed=4)
    out, experts = moe.routed_experts(
        p["layers"][2], x, 4, scale=cfg.routed_scaling_factor, gemm=fused_tenant_gemm
    )
    with R.full_float32():
        ref, ref_experts = R.moe_ffn(R.upcast(p["layers"][2]), TINY, x.float())
    assert torch.equal(experts.sort(-1).values, ref_experts.sort(-1).values)
    assert _gap(out, ref) < BF16_TOL
    # the shared expert is a large part of the sum: left out, the layer is off
    routed_only = {k: v for k, v in p["layers"][2].items() if not k.startswith("shared")}
    without, _ = moe.routed_experts(
        routed_only, x, 4, scale=cfg.routed_scaling_factor, gemm=fused_tenant_gemm
    )
    assert _gap(without, ref) > 10 * BF16_TOL
    s = moe.moe_stats()
    assert s["shared_calls"] == 2 and s["shared_rows"] == 32


def test_the_dense_layer_matches_the_reference(tiny):
    _, p = tiny
    x = _x(32, 64, seed=5)
    out = M.dense_ffn(p["layers"][0], x, fused_tenant_gemm)
    with R.full_float32():
        ref = R.dense_ffn(R.upcast(p["layers"][0]), x.float())
    assert _gap(out, ref) < BF16_TOL


# ---------------------------------------------------------------------------
# the shared expert's place in the expert layer's steps
# ---------------------------------------------------------------------------


def test_the_shared_expert_is_issued_before_the_count_read_yields(tiny, clean_stats):
    _, p = tiny
    log = _Log()
    steps = moe.routed_experts_steps(p["layers"][2], _x(32, 64, seed=6), 4, gemm=log)
    next(steps)  # paused at the count read
    before = list(log.calls)
    assert before == [
        ([(32, 64)], [(64, 8)], []),  # the router
        ([(32, 64)], [(64, 64)], ["epilogue", "out"]),  # shared gate‖up
        ([(32, 32)], [(32, 64)], ["out"]),  # shared down
    ]
    assert moe.moe_stats()["shared_calls"] == 2 and moe.moe_stats()["layers"] == 0
    out, experts = moe.run_steps(steps)
    after = log.calls[len(before):]
    counts = torch.bincount(experts.reshape(-1), minlength=8).tolist()
    rows = [(n, 64) for n in counts]
    assert after == [
        (rows, [(64, 64)] * 8, ["epilogue", "out"]),
        ([(n, 32) for n in counts], [(32, 64)] * 8, ["out", "row_scale"]),
    ]


def test_without_a_shared_expert_the_layer_makes_the_calls_it_made(tiny, clean_stats):
    """The router, then gate‖up with the SwiGLU epilogue into one buffer,
    then down with the slots' gates into another: nothing before the yield
    but the router, nothing else after it."""
    _, p = tiny
    routed_only = {k: v for k, v in p["layers"][2].items() if not k.startswith("shared")}
    log = _Log()
    x = _x(32, 64, seed=7)
    steps = moe.routed_experts_steps(routed_only, x, 4, gemm=log)
    next(steps)
    assert log.calls == [([(32, 64)], [(64, 8)], [])]
    out, experts = moe.run_steps(steps)
    counts = torch.bincount(experts.reshape(-1), minlength=8).tolist()
    assert log.calls[1:] == [
        ([(n, 64) for n in counts], [(64, 64)] * 8, ["epilogue", "out"]),
        ([(n, 32) for n in counts], [(32, 64)] * 8, ["out", "row_scale"]),
    ]
    s = moe.moe_stats()
    assert s["shared_calls"] == s["shared_rows"] == 0
    assert s["epilogue_calls"] == 2 and s["copied_calls"] == 0
    # the layer with the shared expert adds it to this sum (rounded once,
    # where this sum was rounded on its own)
    with_shared, _ = moe.routed_experts(p["layers"][2], x, 4)
    shared = moe.shared_expert(p["layers"][2], x)
    assert _gap(with_shared, out.float() + shared.float()) < 1e-2


# ---------------------------------------------------------------------------
# the whole prefill
# ---------------------------------------------------------------------------


def test_the_prefill_matches_the_reference(tiny):
    cfg, p = tiny
    ids = torch.randint(0, 256, (4, 16), generator=torch.Generator().manual_seed(15))
    keep = {}
    logits = M.prefill(p, cfg, ids, keep=keep)
    ref, chosen = R.forward(p, TINY, ids)
    assert logits.shape == (4, 256) and logits.dtype == torch.float32
    assert sorted(keep["experts"]) == sorted(chosen) == MOE_LAYERS
    same = [
        (keep["experts"][i].sort(-1).values == chosen[i].sort(-1).values).all(-1)
        for i in chosen
    ]
    assert torch.cat(same).float().mean().item() > 0.9
    # a top-4 set that flips on a bfloat16 near-tie is another function of
    # the prompt from there on: the logits are held where every token of the
    # prompt routed as the reference did in every layer
    whole = torch.stack(same).all(0).view(4, 16).all(-1)
    assert whole.sum() >= 2
    assert _gap(logits[whole], ref[whole]) < BF16_TOL
    assert len(keep["hidden"]) == 5 and len(keep["op"]) == len(keep["ffn"]) == 4
    for i in range(4):
        h = keep["hidden"][i] + keep["op"][i]
        assert torch.equal(keep["hidden"][i + 1], h + keep["ffn"][i])


def test_prefills_interleaved_step_by_step_are_each_their_own(tiny):
    cfg, p = tiny
    g = torch.Generator().manual_seed(15)
    ids = [torch.randint(0, 256, (2, 16), generator=g) for _ in range(2)]
    steps = [M.prefill_steps(p, cfg, i) for i in ids]
    out, pauses = [None, None], 0
    while any(o is None for o in out):
        for k, s in enumerate(steps):
            if out[k] is None:
                try:
                    next(s)
                    pauses += 1
                except StopIteration as done:
                    out[k] = done.value
    assert pauses == 2 * len(MOE_LAYERS)  # one pause a MoE layer a prefill
    for i, o in zip(ids, out):
        assert torch.equal(o, M.prefill(p, cfg, i))


def test_prompts_do_not_see_each_other(tiny):
    cfg, p = tiny
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator().manual_seed(10))
    both = M.prefill(p, cfg, ids)
    alone = M.prefill(p, cfg, ids[:1])
    assert torch.allclose(both[:1], alone, atol=1e-5)


def test_the_registry_stays_the_jax_package_s():
    jax_configs = pytest.importorskip("repro.configs")
    from repro_torch import configs

    assert configs.list_archs() == jax_configs.list_archs()
    assert not any("glm" in a for a in configs.list_archs())


# ---------------------------------------------------------------------------
# counters and spans
# ---------------------------------------------------------------------------


def test_the_shared_expert_s_counters_are_always_on(tiny, clean_stats):
    cfg, p = tiny
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator().manual_seed(12))
    M.prefill(p, cfg, ids)
    s = moe.moe_stats()
    assert s["layers"] == 3 and s["shared_calls"] == 2 * 3
    assert s["shared_rows"] == 3 * 32
    # the routed and the shared expert calls all used the epilogue's buffer
    assert s["epilogue_calls"] == 4 * 3 and s["copied_calls"] == 0


@pytest.mark.parametrize("armed", [True, False])
def test_spans_appear_under_a_profiler_only_when_armed(tiny, clean_stats, armed):
    from torch.profiler import ProfilerActivity, profile

    cfg, p = tiny
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator().manual_seed(14))
    set_tracing(armed)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        M.prefill(p, cfg, ids)
    names = [e.name for e in prof.events()]
    counts = {s: names.count(s) for s in MLA_SPANS + [moe.SHARED_SPAN]}
    if armed:
        assert counts == {
            M.SPAN_PREFIX + "proj": 2 * 4,  # the latents and q/kv; o_proj
            M.SPAN_PREFIX + "core": 4,
            moe.SHARED_SPAN: 3,
        }
    else:
        assert not any(counts.values())
