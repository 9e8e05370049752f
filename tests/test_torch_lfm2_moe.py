"""LFM2-MoE prefill through the fused GEMM (``repro_torch.models.lfm2_moe``,
``.routed_experts``) against the plain float32 reference
(``repro_torch.models.lfm2_moe_ref``), at small sizes on the CPU with
seeded weights; the fused GEMM with empty tenants and at the 64-tenant
launch table's capacity; the MoE counters and spans.

The model is port-only (the JAX package has no LFM2): the registry of
architectures stays the JAX package's.  The comparison tolerance is the
repository's bfloat16 one (3e-2 of the reference's largest magnitude): the
program rounds every GEMM output and every activation to bfloat16.
"""

import json
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused_tenant_gemm, set_tracing  # noqa: E402
from repro_torch.models import lfm2_moe as M  # noqa: E402
from repro_torch.models import lfm2_moe_ref as R  # noqa: E402
from repro_torch.models import routed_experts as moe  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PUBLISHED = json.loads((ROOT / "cardbench/configs/lfm2-24b-a2b.json").read_text())
BF16_TOL = 3e-2
TINY = {
    **PUBLISHED,
    "vocab_size": 256,
    "hidden_size": 64,
    "intermediate_size": 96,
    "moe_intermediate_size": 32,
    "num_attention_heads": 4,
    "num_key_value_heads": 2,
    "num_experts": 8,
    "num_hidden_layers": 5,
    "layer_types": ["conv", "conv", "full_attention", "conv", "full_attention"],
}
MOE_SPANS = [moe.SPAN_PREFIX + p for p in moe.PHASES]
LFM2_SPANS = [M.SPAN_PREFIX + p for p in ("conv", "attention", "ffn")]


def _gap(out, ref):
    return ((out.float() - ref).abs().max() / ref.abs().max()).item()


@pytest.fixture(scope="module")
def tiny():
    cfg = M.Lfm2MoeConfig.from_config(TINY)
    return cfg, M.init_params(cfg, seed=11, device="cpu")


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


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------


def test_the_published_config_reads_whole():
    cfg = M.Lfm2MoeConfig.from_config(PUBLISHED)
    assert cfg.num_hidden_layers == 40 and cfg.head_dim == 64
    assert cfg.layer_types.count("full_attention") == 10
    assert [i for i, k in enumerate(cfg.layer_types) if k != "conv"] == list(
        range(2, 40, 4)
    )
    assert cfg.rope_theta == 1e6 and cfg.num_experts == 64
    assert not cfg.is_moe(1) and cfg.is_moe(2)
    # 23.84 B parameters with the embedding tied (47.7 GB in bfloat16)
    shapes = M.param_shapes(cfg)
    leaves = [shapes["embed"], shapes["embedding_norm"]]
    leaves += [s for layer in shapes["layers"] for s in layer.values()]
    assert sum(math.prod(s) for s in leaves) == 23_843_661_440
    assert PUBLISHED["reduced"] == []


@pytest.mark.parametrize(
    "change",
    [{"conv_bias": True}, {"tie_word_embeddings": False}, {"model_type": "lfm2"}],
)
def test_a_config_it_does_not_compute_is_refused(change):
    with pytest.raises(ValueError):
        M.Lfm2MoeConfig.from_config({**PUBLISHED, **change})


def test_the_draw_is_seeded_and_scaled(tiny):
    cfg, p = tiny
    again = M.init_params(cfg, seed=11, device="cpu")
    assert torch.equal(p["layers"][3]["gate_up"], again["layers"][3]["gate_up"])
    other = M.init_params(cfg, seed=12, device="cpu")
    assert not torch.equal(p["embed"], other["embed"])
    gu = p["layers"][3]["gate_up"].float()
    assert gu.std().item() == pytest.approx(64**-0.5, rel=0.1)
    assert p["layers"][3]["expert_bias"].dtype == torch.float32
    ones = torch.ones(16, dtype=torch.bfloat16)
    assert torch.equal(p["layers"][2]["q_layernorm"], ones)


# ---------------------------------------------------------------------------
# the blocks against the reference, teacher-forced
# ---------------------------------------------------------------------------


def test_the_conv_block_matches_the_reference(tiny):
    cfg, p = tiny
    x = _x(2 * 16, 64, seed=1)
    out = M.conv_block(p["layers"][0], x, 2, fused_tenant_gemm)
    with R.full_float32():
        ref = R.conv_op(R.upcast(p["layers"][0]), TINY, x.float(), 2)
    assert out.dtype == torch.bfloat16 and _gap(out, ref) < BF16_TOL


def test_the_conv_is_causal_within_each_prompt(tiny):
    _, p = tiny
    x = _x(2 * 16, 64, seed=2)
    base = M.conv_block(p["layers"][0], x, 2, fused_tenant_gemm)
    later = x.clone()
    later[20:] += 1.0  # prompt 1's positions 4.. change
    out = M.conv_block(p["layers"][0], later, 2, fused_tenant_gemm)
    assert torch.equal(out[:20], base[:20])
    assert not torch.equal(out[20:], base[20:])


def test_the_attention_block_matches_the_reference(tiny):
    cfg, p = tiny
    x = _x(2 * 16, 64, seed=3)
    out = M.attention_block(p["layers"][2], cfg, x, 2, fused_tenant_gemm)
    with R.full_float32():
        ref = R.attention_op(R.upcast(p["layers"][2]), TINY, x.float(), 2)
    assert _gap(out, ref) < BF16_TOL


def test_the_dense_ffn_matches_the_reference(tiny):
    _, p = tiny
    x = _x(32, 64, seed=4)
    out = M.dense_ffn(p["layers"][1], x, fused_tenant_gemm)
    with R.full_float32():
        ref = R.dense_ffn(R.upcast(p["layers"][1]), x.float())
    assert _gap(out, ref) < BF16_TOL


def test_a_bias_changes_the_choice_but_not_the_weights():
    g = torch.Generator().manual_seed(5)
    scores = torch.sigmoid(torch.randn((32, 8), generator=g))
    bias = torch.zeros(8)
    bias[7] = 10.0  # expert 7 chosen by every token, whatever its score
    gates, experts = moe.route_top_k(scores, bias, 4, True, 1.0)
    assert (experts == 7).any(-1).all()
    chosen = scores.gather(-1, experts)
    assert torch.allclose(gates, chosen / (chosen.sum(-1, keepdim=True) + 1e-6))
    plain, _ = moe.route_top_k(scores, torch.zeros(8), 4, True, 1.0)
    assert not torch.equal(plain, gates)
    # the reference routes alike
    p = {"router": torch.eye(8), "expert_bias": bias}
    ref_gates, ref_experts = R.route(p, TINY, torch.logit(scores))
    assert torch.equal(ref_experts.sort(-1).values, experts.sort(-1).values)
    assert torch.allclose(ref_gates, gates, atol=1e-6)


def test_unnormalised_gates_follow_the_config():
    scores = torch.tensor([[0.9, 0.8, 0.1, 0.2]])
    gates, experts = moe.route_top_k(scores, torch.zeros(4), 2, False, 2.0)
    assert experts.tolist() == [[0, 1]]
    assert torch.allclose(gates, torch.tensor([[1.8, 1.6]]))


def test_the_routed_experts_match_the_reference(tiny, clean_stats):
    _, p = tiny
    x = _x(32, 64, seed=6)
    out, experts = moe.routed_experts(p["layers"][3], x, 4, gemm=fused_tenant_gemm)
    with R.full_float32():
        ref, ref_experts = R.moe_ffn(R.upcast(p["layers"][3]), TINY, x.float())
    assert torch.equal(experts.sort(-1).values, ref_experts.sort(-1).values)
    assert _gap(out, ref) < BF16_TOL


def test_a_64_tenant_routed_call_with_empty_experts(clean_stats):
    """64 experts, the launch table's capacity, each a tenant of one call;
    64 tokens x 4 slots leave some experts with no rows."""
    g = torch.Generator().manual_seed(7)
    d, f, E = 32, 16, 64
    p = {
        "router": (torch.randn((d, E), generator=g) * d**-0.5).bfloat16(),
        "expert_bias": torch.zeros(E),
        "gate_up": (torch.randn((E, d, 2 * f), generator=g) * d**-0.5).bfloat16(),
        "down": (torch.randn((E, f, d), generator=g) * f**-0.5).bfloat16(),
    }
    x = _x(64, d, seed=8)
    calls = []

    def gemm(xs, ws, **kw):
        calls.append([t.shape[0] for t in xs])
        return fused_tenant_gemm(xs, ws, **kw)

    out, experts = moe.routed_experts(p, x, 4, gemm=gemm)
    counts = torch.bincount(experts.reshape(-1), minlength=E).tolist()
    assert calls == [[64], counts, counts]  # router, gate_up, down
    assert 0 in counts and len(counts) == 64
    cfg = {"num_experts_per_tok": 4, "moe_intermediate_size": f}
    with R.full_float32():
        p32 = {k: v.float() for k, v in p.items()}
        ref, ref_experts = R.moe_ffn(p32, cfg, x.float())
    assert torch.equal(experts.sort(-1).values, ref_experts.sort(-1).values)
    assert _gap(out, ref) < BF16_TOL
    assert moe.moe_stats()["empty_experts"] == counts.count(0)


@pytest.mark.parametrize("rows", [[0, 5, 0, 9], [3, 0], [0, 0, 4]])
def test_the_fused_gemm_takes_tenants_with_no_rows(rows):
    xs = [_x(t, 24, seed=t + 1) for t in rows]
    ws = [_x(24, 40, seed=100 + i) for i in range(len(rows))]
    outs = fused_tenant_gemm(xs, ws, grid_mode="compact")
    for x, w, o in zip(xs, ws, outs):
        assert o.shape == (x.shape[0], 40) and o.dtype == torch.float32
        assert torch.allclose(o, x.float() @ w.float(), atol=1e-4)


# ---------------------------------------------------------------------------
# the whole prefill
# ---------------------------------------------------------------------------


def test_the_prefill_matches_the_reference(tiny):
    cfg, p = tiny
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator().manual_seed(9))
    keep = {}
    logits = M.prefill(p, cfg, ids, keep=keep)
    ref, chosen = R.forward(p, TINY, ids)
    assert logits.shape == (2, 256) and logits.dtype == torch.float32
    assert sorted(keep["experts"]) == sorted(chosen) == [2, 3, 4]
    same = [
        (keep["experts"][i].sort(-1).values == chosen[i].sort(-1).values).all(-1)
        for i in chosen
    ]
    assert torch.cat(same).float().mean().item() > 0.9
    # a top-4 set that flips on a bfloat16 near-tie is another function of
    # the prompt from there on: the logits are held where every token of the
    # prompt routed as the reference did in every layer
    whole = torch.stack(same).all(0).view(2, 16).all(-1)
    assert whole.any()
    assert _gap(logits[whole], ref[whole]) < BF16_TOL
    assert len(keep["hidden"]) == 6 and len(keep["op"]) == len(keep["ffn"]) == 5
    # the stream is the sum of what each layer added, in bfloat16
    for i in range(5):
        h = keep["hidden"][i] + keep["op"][i]
        assert torch.equal(keep["hidden"][i + 1], h + keep["ffn"][i])


def test_prefills_interleaved_step_by_step_are_each_their_own(tiny):
    """Two prefills run as steps in turn (as a server with two batches in
    flight runs them, pausing each at its count reads) give what each gives
    alone, bit for bit."""
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
    assert pauses == 2 * 3  # one pause a MoE layer a prefill
    for i, o in zip(ids, out):
        assert torch.equal(o, M.prefill(p, cfg, i))


def test_prompts_do_not_see_each_other(tiny):
    cfg, p = tiny
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator().manual_seed(10))
    both = M.prefill(p, cfg, ids)
    alone = M.prefill(p, cfg, ids[:1])
    assert torch.allclose(both[:1], alone, atol=1e-5)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smoke_s_lfm2_layer_is_the_cell_s():
    cs = _chip_smoke()
    cfg = PUBLISHED
    mix = json.loads((ROOT / "cardbench/mixes/prefill-4x4096.json").read_text())
    T, d, f, E, k, bias = cs.LFM2_LAYER
    assert T == mix["prompts"] * mix["prompt_tokens"]
    assert (d, f, E, k) == (cfg["hidden_size"], cfg["moe_intermediate_size"],
                            cfg["num_experts"], cfg["num_experts_per_tok"])
    assert bias == cfg["expert_bias_std"]
    assert cs.LFM2_HEAD == (cfg["vocab_size"], mix["prompts"])


class _View:
    """A bfloat16 view ``at`` bytes into the storage at ``base``, as the
    launcher sees it: addresses only, nothing allocated."""

    def __init__(self, base, at=0):
        self.base, self.at = base, at

    def data_ptr(self):
        return self.base + self.at

    def untyped_storage(self):
        return _View(self.base)


@pytest.mark.parametrize("dense", [False, True], ids=["compact", "dense"])
@pytest.mark.parametrize("call", ["gate_up", "down"])
def test_chip_smoke_s_lfm2_layer_has_empty_and_staged_experts(call, dense):
    """The card's check of the cell's expert calls: 64 tenants, the routed
    rows of one layer with some experts empty.  Its operands, one row
    buffer's split and one stack's unbind, reach every live tenant through
    two shared tensor maps; per-tenant copies would leave all but the
    first ``TENSOR_MAPS / 2`` live tenants on the staged feed."""
    import repro_torch.kernels as K

    cs = _chip_smoke()
    counts = cs.lfm2_counts(torch, "cpu")
    assert len(counts) == 64 and sum(counts) == 16_384 * 4
    assert [e for e, n in enumerate(counts) if n == 0] == list(cs.LFM2_EMPTY)
    shapes = tuple(cs.lfm2_calls(counts)[call])
    assert len(shapes) == 64 and shapes[0][1:] == ((2048, 3072) if call == "gate_up"
                                                   else (1536, 2048))
    lds = tuple(k for _, k, _ in shapes), tuple(n for _, _, n in shapes)
    table = K.tenant_table(shapes, *lds, dense, True, 132)
    assert len(table.tenants) == 64
    starts = [sum(counts[:e]) for e in range(64)]
    shared = [_View(1 << 40, 2 * k * r) for r, (_, k, _) in zip(starts, shapes)]
    shared += [_View(1 << 41, 2 * k * n * e) for e, (_, k, n) in enumerate(shapes)]
    copies = [_View((1 << 40) + (i << 32)) for i in range(128)]
    live = 64 - len(cs.LFM2_EMPTY)
    assert cs.mapped_tenants(K, table, shared) == live
    assert cs.mapped_tenants(K, table, copies) == cs.TENSOR_MAPS // 2


def test_the_registry_stays_the_jax_package_s():
    jax_configs = pytest.importorskip("repro.configs")
    from repro_torch import configs

    assert configs.list_archs() == jax_configs.list_archs()
    assert not any("lfm2" in a for a in configs.list_archs())


# ---------------------------------------------------------------------------
# counters and spans
# ---------------------------------------------------------------------------


def test_moe_stats_count_exactly(tiny, clean_stats):
    cfg, p = tiny
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator().manual_seed(12))
    keep = {}
    M.prefill(p, cfg, ids, keep=keep)
    counts = [torch.bincount(keep["experts"][i].reshape(-1), minlength=8).tolist()
              for i in (2, 3, 4)]
    s = moe.moe_stats()
    assert s["layers"] == 3 and s["tokens"] == 3 * 32 and s["slots"] == 3 * 32 * 4
    assert s["count_reads"] == 3
    assert s["max_rows"] == sum(max(c) for c in counts)
    assert s["empty_experts"] == sum(c.count(0) for c in counts)
    # disarmed: no clock and no per-layer rows
    assert s["phase_ns"] == dict.fromkeys(moe.PHASES, 0)
    assert s["armed_layers"] == s["layer_ns"] == 0 and s["routed"] == []


def test_armed_the_phases_are_timed_and_the_rows_kept(tiny, clean_stats):
    cfg, p = tiny
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator().manual_seed(13))
    set_tracing(True)
    keep = {}
    M.prefill(p, cfg, ids, keep=keep)
    s = moe.moe_stats()
    assert s["armed_layers"] == 3
    assert all(v > 0 for v in s["phase_ns"].values())
    ns = s["phase_ns"]
    assert ns["route"] + ns["dispatch"] + ns["experts"] <= s["layer_ns"]
    assert s["routed"] == [
        tuple(torch.bincount(keep["experts"][i].reshape(-1), minlength=8).tolist())
        for i in (2, 3, 4)
    ]
    moe.reset_moe_stats()
    assert moe.moe_stats()["layers"] == 0


def _span_names(prof):
    return [e.name for e in prof.events()]


@pytest.mark.parametrize("armed", [True, False])
def test_spans_appear_under_a_profiler_only_when_armed(tiny, clean_stats, armed):
    from torch.profiler import ProfilerActivity, profile

    cfg, p = tiny
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator().manual_seed(14))
    set_tracing(armed)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        M.prefill(p, cfg, ids)
    names = _span_names(prof)
    counts = {s: names.count(s) for s in MOE_SPANS + LFM2_SPANS}
    if armed:
        assert counts == {
            **dict.fromkeys(MOE_SPANS, 3),
            M.SPAN_PREFIX + "conv": 3,
            M.SPAN_PREFIX + "attention": 2,
            M.SPAN_PREFIX + "ffn": 5,
        }
    else:
        assert not any(counts.values())
        assert moe.moe_stats()["phase_ns"] == dict.fromkeys(moe.PHASES, 0)
