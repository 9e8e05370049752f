"""The fused GEMM's epilogue (``fused_tenant_gemm(..., epilogue=,
row_scale=, out=)``) and the expert layer that uses it
(``repro_torch.models.routed_experts``), on the CPU.

The plain version is held against the PyTorch ops it stands for (f32
products, SiLU·up and the row scale in f32, one rounding to bfloat16); the
epilogue's launch table is walked here as the CUDA source walks it, gated
tiles reading w's gate and up columns, and its counts held against that
walk.  The layer is held against the f32 reference, and, where its call
ignores the epilogue or replaces an output (as the benchmark's control and
its dropped-expert fault do), against the layer as it was composed before
the epilogue, bit for bit.  The kernels themselves are checked on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import fused_tenant_gemm, set_tracing  # noqa: E402
from repro_torch.kernels.partitioned_matmul import (  # noqa: E402
    K_SLICES,
    NARROW,
    Segment,
    Tenant,
    epilogue_table,
    launch_table,
    tenant_table,
    tile_shape,
)
from repro_torch.models import lfm2_moe_ref as R  # noqa: E402
from repro_torch.models import routed_experts as moe  # noqa: E402

# ragged experts: empty ones, a single row, rows past one and two tiles
ROWS = [0, 5, 1, 0, 130, 64, 65, 17]


def _bf16(shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(torch.bfloat16)


def _experts(rows, d, n, seed=0):
    x = _bf16((sum(rows), d), seed)
    ws = [_bf16((d, n), seed + 1 + i, d**-0.5) for i in range(len(rows))]
    return list(x.split(rows)), ws


def _f32(xs, ws):
    """The plain version's f32 outputs of the same compact call."""
    return fused_tenant_gemm(xs, ws, grid_mode="compact")


def _views_of(outs, buf, rows):
    """Whether ``outs`` are ``buf``'s rows, tenant after tenant."""
    start = 0
    for o, t in zip(outs, rows):
        assert o.shape == (t, buf.shape[1]) and o.dtype == torch.bfloat16
        if t:
            assert o.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
            assert o.storage_offset() == buf.storage_offset() + start * buf.stride(0)
        start += t
    return True


# ---------------------------------------------------------------------------
# the plain version against the composed ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("f", [40, 96, 64])
def test_swiglu_is_silu_gate_times_up_rounded_once(f):
    xs, ws = _experts(ROWS, 48, 2 * f)
    buf = torch.full((sum(ROWS), f), 7.0, dtype=torch.bfloat16)
    outs = fused_tenant_gemm(xs, ws, grid_mode="compact", epilogue="swiglu", out=buf)
    assert _views_of(outs, buf, ROWS)
    for x, w, o, y in zip(xs, ws, outs, _f32(xs, ws)):
        assert torch.allclose(y, x.float() @ w.float(), atol=1e-4)
        want = (F.silu(y[:, :f]) * y[:, f:]).to(torch.bfloat16)
        assert torch.equal(o, want)


def test_a_row_scale_weights_each_row_of_the_buffer():
    xs, ws = _experts(ROWS, 40, 72, seed=3)
    scale = torch.rand(sum(ROWS), generator=torch.Generator().manual_seed(4))
    buf = torch.empty((sum(ROWS), 72), dtype=torch.bfloat16)
    outs = fused_tenant_gemm(xs, ws, grid_mode="compact", row_scale=scale, out=buf)
    assert _views_of(outs, buf, ROWS)
    for y, o, s in zip(_f32(xs, ws), outs, scale.split(ROWS)):
        assert torch.equal(o, (y * s[:, None]).to(torch.bfloat16))


def test_swiglu_and_a_row_scale_together_and_an_out_view():
    f = 33
    xs, ws = _experts(ROWS, 24, 2 * f, seed=5)
    wide = torch.zeros((sum(ROWS), f + 3), dtype=torch.bfloat16)
    buf = wide[:, 1 : f + 1]  # unit-stride rows, pitch f + 3
    scale = torch.linspace(-2, 2, sum(ROWS))
    outs = fused_tenant_gemm(xs, ws, epilogue="swiglu", row_scale=scale, out=buf)
    assert _views_of(outs, buf, ROWS)
    assert not wide[:, 0].any() and not wide[:, f + 1 :].any()
    for y, o, s in zip(_f32(xs, ws), outs, scale.split(ROWS)):
        want = (F.silu(y[:, :f]) * y[:, f:] * s[:, None]).to(torch.bfloat16)
        assert torch.equal(o, want)


def test_out_alone_rounds_the_sums_once_into_one_buffer():
    xs, ws = _experts(ROWS, 16, 20, seed=6)
    buf = torch.empty((sum(ROWS), 20), dtype=torch.bfloat16)
    outs = fused_tenant_gemm(xs, ws, out=buf)
    assert _views_of(outs, buf, ROWS)
    for y, o in zip(_f32(xs, ws), outs):
        assert torch.equal(o, y.to(torch.bfloat16))


@pytest.mark.parametrize(
    "kw, xs_dtype, error",
    [
        (dict(epilogue="swiglu", grid_mode="dense", out=torch.empty((11, 4),
         dtype=torch.bfloat16)), torch.bfloat16, ValueError),
        (dict(epilogue="gelu"), torch.bfloat16, ValueError),
        (dict(epilogue="swiglu"), torch.float32, TypeError),
        (dict(row_scale=torch.ones(11)), torch.bfloat16, ValueError),
        (dict(row_scale=torch.ones(3), out=torch.empty((11, 8), dtype=torch.bfloat16)),
         torch.bfloat16, ValueError),
        (dict(row_scale=torch.ones(11, dtype=torch.float64),
              out=torch.empty((11, 8), dtype=torch.bfloat16)), torch.bfloat16,
         ValueError),
        (dict(out=torch.empty((11, 8), dtype=torch.float32)), torch.bfloat16,
         ValueError),
        (dict(out=torch.empty((11, 4), dtype=torch.bfloat16)), torch.bfloat16,
         ValueError),
        (dict(out=torch.empty((8, 11), dtype=torch.bfloat16).t()), torch.bfloat16,
         ValueError),
    ],
    ids=["dense", "unknown", "float32", "no-out", "scale-rows", "scale-dtype",
         "out-dtype", "out-shape", "out-columns-strided"],
)
def test_the_epilogue_s_arguments_are_checked(kw, xs_dtype, error):
    xs = [torch.ones((t, 6), dtype=xs_dtype) for t in (4, 7)]
    ws = [torch.ones((6, 8), dtype=xs_dtype)] * 2
    with pytest.raises(error):
        fused_tenant_gemm(xs, ws, **kw)


def test_one_buffer_needs_one_width():
    xs = [torch.ones((2, 6), dtype=torch.bfloat16)] * 2
    ws = [torch.ones((6, 8), dtype=torch.bfloat16), torch.ones((6, 10),
                                                              dtype=torch.bfloat16)]
    with pytest.raises(ValueError, match="width"):
        fused_tenant_gemm(xs, ws, epilogue="swiglu")
    with pytest.raises(ValueError, match="halves"):
        fused_tenant_gemm(xs[:1], [torch.ones((6, 9), dtype=torch.bfloat16)],
                          epilogue="swiglu")


# ---------------------------------------------------------------------------
# the epilogue's launch table, walked as the kernel walks it
# ---------------------------------------------------------------------------


def _walk(table):
    """Every live tile of a compact bfloat16 table: ``(segment, tenant,
    row0, col0, bm, bn, r_end, c_end)``, in the order ``wide_tile`` takes
    them (no tenant here has rows past its live ones)."""
    for s in table.segments:
        t = table.tenants[s.tenant]
        bm, bn = tile_shape(t.rows, s.cols, True, table.narrow, s.glu)
        live_rows = -(-t.rows // bm)
        for b in range(live_rows * -(-s.cols // bn)):
            row0, col0 = b % live_rows * bm, b // live_rows * bn
            yield s, t, row0, col0, bm, bn, min(bm, t.out_rows - row0), min(
                bn, s.cols - col0
            )


def _interpret(table, bufs, scale=None):
    """Run an epilogue table on flat float32 NumPy buffers as the kernel
    would: a gated tile's B is w's 64 columns at col0 and at cols + col0,
    its output silu(gate) * up; each row times ``scale`` at its row of the
    output buffer.  Returns the writes of every element of the output."""
    out = table.segments[0].out
    writes = np.zeros(bufs[out].shape, np.int64)
    for s, t, row0, col0, bm, bn, r_end, c_end in _walk(table):
        r, c = row0 + np.arange(r_end), col0 + np.arange(c_end)
        k = np.arange(t.depth)
        x = bufs[t.x][t.x_off + r[:, None] * t.ldx + k[None, :]]
        n = np.arange(2 * s.cols if s.glu else s.cols)
        w = bufs[s.w][s.w_off + k[:, None] * s.ldw + n[None, :]]
        if s.glu:
            g, u = x @ w[:, c], x @ w[:, s.cols + c]
            val = g / (1 + np.exp(-g)) * u
        else:
            val = x @ w[:, c]
        if scale is not None:
            val = val * scale[s.out_off // s.ldo + r][:, None]
        idx = s.out_off + r[:, None] * s.ldo + c[None, :]
        bufs[out][idx] = val
        writes[idx] += 1
    return writes


@pytest.mark.parametrize("sms", [0, 10**9], ids=["per-segment", "narrow-launch"])
@pytest.mark.parametrize("glu", [True, False], ids=["swiglu", "scaled"])
@pytest.mark.parametrize("f", [40, 96, 200])
def test_the_epilogue_table_writes_each_output_once(f, glu, sms):
    rows, d = ROWS, 80
    n = 2 * f if glu else f
    rng = np.random.default_rng(f)
    xs = [rng.standard_normal((t, d)).astype(np.float32) for t in rows]
    ws = [rng.standard_normal((d, n)).astype(np.float32) for _ in rows]
    shapes = tuple((t, d, n) for t in rows)
    ldo = f + 5
    table = epilogue_table(shapes, (d,) * len(rows), (n,) * len(rows), ldo, glu, sms)
    assert table.epilogue and not table.dense and table.bf16
    E = len(rows)
    out = np.full(sum(rows) * ldo, np.nan, np.float32)
    bufs = [x.ravel() for x in xs] + [w.ravel() for w in ws] + [out]
    scale = rng.standard_normal(sum(rows)).astype(np.float32)
    writes = _interpret(table, bufs, scale).reshape(-1, ldo)
    np.testing.assert_array_equal(writes[:, :f], 1)
    np.testing.assert_array_equal(writes[:, f:], 0)
    got = bufs[2 * E].reshape(-1, ldo)[:, :f]
    row = 0
    for x, w, t in zip(xs, ws, rows):
        y = x.astype(np.float64) @ w
        if glu:
            y = y[:, :f] / (1 + np.exp(-y[:, :f])) * y[:, f:]
        want = y * scale[row : row + t, None]
        np.testing.assert_allclose(got[row : row + t], want, rtol=1e-4, atol=1e-4)
        row += t


def test_a_gated_segment_is_flagged_and_counted_over_gate_and_up():
    shapes = ((130, 64, 192), (0, 64, 192), (65, 64, 192))
    table = epilogue_table(shapes, (64,) * 3, (201,) * 3, 96, True, 0)
    assert [s.glu for s in table.segments] == [True, True]
    assert [s.cols for s in table.segments] == [96, 96]
    assert [s.out_off for s in table.segments] == [0, 130 * 96]
    # gated tiles: 128 x 64 output, two 64-column blocks of w
    assert tile_shape(130, 96, True, False, True) == (128, NARROW)
    assert table.grid == 2 * 2 + 1 * 2
    c = table.counts
    assert c.macs_useful == (130 + 65) * 64 * 192
    assert c.macs_issued == 6 * 128 * (2 * NARROW) * 64
    assert c.feed_staged_macs == c.macs_issued  # rows of 201 values: staged
    # the same tiles ungated: half the columns multiplied
    plain = tenant_table(((130, 64, 96),), (64,), (201,), False, True, 0)
    assert plain.counts.macs_useful * 2 == 130 * 64 * 192


def test_the_epilogue_runs_in_compact_bf16_launches_only():
    tenants = [Tenant(0, 0, 8, 8, 8, 8)]
    seg = [Segment(1, 0, 16, 2, 0, 8, 8, 0, True)]
    for dense, bf16 in ((True, True), (False, False)):
        with pytest.raises(ValueError, match="compact bfloat16"):
            launch_table(tenants, seg, dense=dense, bf16=bf16, epilogue=True)
    with pytest.raises(ValueError, match="compact bfloat16"):
        launch_table(tenants, seg, dense=False, bf16=True)  # gated, no epilogue
    assert launch_table(tenants, seg, dense=False, bf16=True, epilogue=True).grid == 1
    assert K_SLICES[1] == 64


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


def _layer(E=16, d=48, f=40, seed=20):
    g = torch.Generator().manual_seed(seed)
    return {
        "router": (torch.randn((d, E), generator=g) * d**-0.5).bfloat16(),
        "expert_bias": torch.randn(E, generator=g) * 0.02,
        "gate_up": (torch.randn((E, d, 2 * f), generator=g) * d**-0.5).bfloat16(),
        "down": (torch.randn((E, f, d), generator=g) * f**-0.5).bfloat16(),
    }


def _before_the_epilogue(p, x, k, gemm):
    """The layer as it was composed before the epilogue: f32 outputs
    concatenated, rounded, SiLU·up in bfloat16, the down outputs rounded,
    put back in token order and weighted by the gates in f32."""
    T, d = x.shape
    (logits,) = gemm([x], [p["router"]])
    gates, experts = moe.route_top_k(
        torch.sigmoid(logits.float()), p["expert_bias"], k, True, 1.0
    )
    flat = experts.reshape(-1)
    counts = torch.bincount(flat, minlength=p["router"].shape[1]).tolist()
    order = torch.argsort(flat, stable=True)
    rows = x.index_select(0, order // k)
    gu = torch.cat(gemm(list(rows.split(counts)), list(p["gate_up"].unbind(0)),
                        grid_mode="compact"))
    f = gu.shape[1] // 2
    act = F.silu(gu[:, :f].to(x.dtype)) * gu[:, f:].to(x.dtype)
    y = torch.cat(gemm(list(act.split(counts)), list(p["down"].unbind(0)),
                       grid_mode="compact")).to(x.dtype)
    by_token = torch.empty_like(y)
    by_token[order] = y
    out = (by_token.view(T, k, d).float() * gates[..., None]).sum(1)
    return out.to(x.dtype), experts


def _f32_call(xs, ws, **kw):
    """A call with the documented signature that takes no notice of the
    epilogue (as the benchmark's control does): f32 outputs."""
    return fused_tenant_gemm(xs, ws, grid_mode=kw.get("grid_mode", "auto"))


def _dropping(call):
    """``call`` with the first tenant with rows of every expert call
    zeroed (as the benchmark's dropped-expert fault does)."""

    def dropped(xs, ws, **kw):
        outs = call(xs, ws, **kw)
        if len(ws) > 3:
            e = next(i for i, x in enumerate(xs) if x.shape[0])
            outs[e] = torch.zeros_like(outs[e])
        return outs

    return dropped


@pytest.fixture
def clean_stats():
    was = set_tracing(False)
    moe.reset_moe_stats()
    yield
    moe.reset_moe_stats()
    set_tracing(was)


def test_the_layer_with_the_epilogue_matches_the_reference(clean_stats):
    p = _layer()
    x = _bf16((64, 48), 21)
    out, experts = moe.routed_experts(p, x, 4)
    with R.full_float32():
        p32 = {k: v.float() for k, v in p.items()}
        cfg = {"num_experts_per_tok": 4, "moe_intermediate_size": 40}
        ref, ref_experts = R.moe_ffn(p32, cfg, x.float())
    same = (experts.sort(-1).values == ref_experts.sort(-1).values).all(-1)
    assert same.float().mean() > 0.9
    gap = (out[same].float() - ref[same]).abs().max() / ref[same].abs().max()
    assert gap.item() < 3e-2
    # no worse than the layer before the epilogue
    before, _ = _before_the_epilogue(p, x, 4, fused_tenant_gemm)
    gap_before = (before[same].float() - ref[same]).abs().max() / ref[same].abs().max()
    assert gap.item() <= 1.5 * gap_before.item()
    s = moe.moe_stats()
    assert s["epilogue_calls"] == 2 and s["copied_calls"] == 0


def test_the_layer_uses_the_buffers_it_passes(clean_stats):
    p = _layer(seed=22)
    x = _bf16((32, 48), 23)
    seen = []

    def call(xs, ws, **kw):
        outs = fused_tenant_gemm(xs, ws, **kw)
        if "out" in kw:
            seen.append((kw.get("epilogue"), kw.get("row_scale") is not None,
                         kw["out"].shape, kw["out"].dtype))
        return outs

    moe.routed_experts(p, x, 4, gemm=call)
    assert seen == [("swiglu", False, (128, 40), torch.bfloat16),
                    (None, True, (128, 48), torch.bfloat16)]


@pytest.mark.parametrize(
    "call, before",
    [(_f32_call, _f32_call), (_dropping(_f32_call), _dropping(_f32_call))],
    ids=["ignores-the-epilogue", "drops-an-expert-f32"],
)
def test_a_call_that_does_not_fill_the_buffer_gives_the_old_composition(
    clean_stats, call, before
):
    p = _layer(seed=24)
    x = _bf16((64, 48), 25)
    out, experts = moe.routed_experts(p, x, 4, gemm=call)
    want, want_experts = _before_the_epilogue(p, x, 4, before)
    assert torch.equal(experts, want_experts)
    assert torch.equal(out, want)
    s = moe.moe_stats()
    assert s["copied_calls"] == 2 and s["epilogue_calls"] == 0


def test_a_dropped_expert_is_still_dropped_through_the_epilogue(clean_stats):
    p = _layer(seed=26)
    x = _bf16((64, 48), 27)
    out, experts = moe.routed_experts(p, x, 4, gemm=_dropping(fused_tenant_gemm))
    s = moe.moe_stats()
    assert s["copied_calls"] == 2 and s["epilogue_calls"] == 0
    want, _ = _before_the_epilogue(p, x, 4, _dropping(_f32_call))
    whole, _ = moe.routed_experts(p, x, 4)
    gap = ((out.float() - want.float()).abs().max() / want.float().abs().max()).item()
    assert gap < 3e-2
    first = int(experts.reshape(-1).min())  # the first expert with rows
    hit = (experts == first).any(-1)
    assert not torch.equal(out[hit], whole[hit])
    assert torch.equal(out[~hit], whole[~hit])


def test_the_layer_is_deterministic(clean_stats):
    p = _layer(seed=28)
    x = _bf16((64, 48), 29)
    a, _ = moe.routed_experts(p, x, 4)
    b, _ = moe.routed_experts(p, x, 4)
    assert torch.equal(a, b)


def test_the_epilogue_counters_count_exactly(clean_stats):
    p = _layer(seed=30)
    x = _bf16((32, 48), 31)
    for _ in range(3):
        moe.routed_experts(p, x, 4)
    moe.routed_experts(p, x, 4, gemm=_f32_call)
    s = moe.moe_stats()
    assert s["layers"] == 4
    assert s["epilogue_calls"] == 6 and s["copied_calls"] == 2
    moe.reset_moe_stats()
    s = moe.moe_stats()
    assert s["epilogue_calls"] == s["copied_calls"] == 0
