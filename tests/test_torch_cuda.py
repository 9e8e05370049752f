"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels build at
first use) and skips elsewhere.  Run on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports no JAX: the card's machine has none.  ``chip_smoke.py``
covers the main path's shapes; these tests cover what it does not — partition
blocks that are not multiples of the CTA tiles (64 × 64 in float32, 64 or
128 a side in bfloat16: masked column, row and depth bounds), operands at
any alignment read in place (bfloat16: by TMA where origin and row pitch
are 16-byte aligned, else by the staged feed), the wrapper's checks and the
launch counters.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from collections import Counter

from repro_torch.kernels import (
    fused_tenant_gemm,
    launch_counts,
    launch_stats,
    ops,
    pad_operands,
    partitioned_matmul,
    partitioned_matmul_ref,
)
import importlib

from repro_torch.kernels.partitioned_matmul import MAX_SEGMENTS, MAX_TENANTS

pm = importlib.import_module("repro_torch.kernels.partitioned_matmul")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


SHAPES = [(300, 200, 100), (40, 70, 300), (129, 64, 65), (1, 33, 7), (512, 512, 96)]


def _operands(shapes, dtype, device, integer, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape):
        if integer:
            v = torch.randint(-4, 5, shape, generator=gen, device=device)
        else:
            v = torch.randn(shape, generator=gen, device=device)
        return v.to(dtype)

    return [draw((t, k)) for t, k, _ in shapes], [draw((k, n)) for _, k, n in shapes]


def _plain(padded, block_n):
    xs_pad, w_pad, owner, vt, _ = padded
    dev = xs_pad.device
    owner_d, vt_d = torch.from_numpy(owner).to(dev), torch.from_numpy(vt).to(dev)
    return partitioned_matmul_ref(xs_pad, w_pad, owner_d, vt_d, block_n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "blocks", [(32, 64, 96), (192, 32, 64), (64, 96, 32), (128, 128, 128), (16, 16, 16)]
)
def test_integer_operands_bit_exact_at_any_partition_block(cuda, blocks, dtype):
    bt, bk, bn = blocks
    kw = dict(block_t=bt, block_k=bk, block_n=bn)
    padded = pad_operands(*_operands(SHAPES, dtype, cuda, integer=True), **kw)
    dense = partitioned_matmul(*padded, grid_mode="dense", **kw)
    compact = partitioned_matmul(*padded, grid_mode="compact", **kw)
    plain = _plain(padded, bn)
    torch.cuda.synchronize()
    assert torch.equal(dense, compact)
    assert torch.equal(dense, plain)


@pytest.mark.parametrize("grid_mode", ["dense", "compact"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_random_operands_match_per_tenant_matmul(cuda, dtype, grid_mode):
    xs, ws = _operands(SHAPES, dtype, cuda, integer=False, seed=1)
    kw = dict(block_t=64, block_k=64, block_n=64, grid_mode=grid_mode)
    outs = fused_tenant_gemm(xs, ws, **kw)
    for x, w, out in zip(xs, ws, outs):
        ref = x.float() @ w.float()
        err = (out - ref).abs().max() / ref.abs().max()
        assert out.shape == ref.shape and err < 1e-4


def test_dead_tiles_are_zero_even_in_a_dirty_allocator(cuda):
    # fill the caching allocator with non-zero blocks first: an unwritten
    # tile of the compact output would show up as garbage
    junk = [torch.full((512, 512), 7.0, device=cuda) for _ in range(8)]
    del junk
    xs = torch.ones((2, 256, 128), device=cuda)
    w = torch.ones((128, 256), device=cuda)
    for mode in ("dense", "compact"):
        out = partitioned_matmul(xs, w, [0, 1], [0, 100], grid_mode=mode)
        assert torch.all(out[:, :128] == 0)
        assert torch.all(out[128:, 128:] == 0) and torch.all(out[:100, 128:] == 128)


def test_counters_count_launches_only(cuda):
    before = launch_counts()
    xs = torch.ones((1, 128, 128), device=cuda)
    w = torch.ones((128, 128), device=cuda)
    # nothing live: the launch holds only zero-fill tiles (nothing else
    # zeroes the output), and it counts
    out = partitioned_matmul(xs, w, [0], [0], grid_mode="compact")
    assert torch.all(out == 0)
    partitioned_matmul(xs, w, [0], [128], grid_mode="compact")
    partitioned_matmul(xs, w, [0], [128], grid_mode="dense")
    partitioned_matmul(xs.cpu(), w.cpu(), [0], [128])  # plain version: no launch
    fused_tenant_gemm([xs[0, :0]], [w], grid_mode="dense")  # no tile: no launch
    after = launch_counts()
    assert after["compact"] == before["compact"] + 2
    assert after["dense"] == before["dense"] + 1


# odd depths and widths: rows of x and w on 4-byte (f32) and 2-byte (bf16)
# boundaries, outputs with odd row strides, a tenant with no depth
UNALIGNED = [(37, 363, 101), (129, 147, 65), (1, 33, 7), (300, 153, 100), (5, 0, 9)]


@pytest.mark.parametrize("grid_mode", ["dense", "compact"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unaligned_tenants_bit_exact_through_both_entry_points(cuda, dtype, grid_mode):
    xs, ws = _operands(UNALIGNED, dtype, cuda, integer=True, seed=2)
    outs = fused_tenant_gemm(xs, ws, grid_mode=grid_mode)
    kw = dict(block_t=64, block_k=32, block_n=32)
    padded = pad_operands(xs, ws, **kw)
    stacked = partitioned_matmul(*padded, grid_mode=grid_mode, **kw)
    plain = _plain(padded, 32)
    torch.cuda.synchronize()
    assert torch.equal(stacked, plain)
    for x, w, out in zip(xs, ws, outs):
        assert torch.equal(out, x.float() @ w.float())


@pytest.mark.parametrize("grid_mode", ["dense", "compact"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unaligned_tenants_random_operands(cuda, dtype, grid_mode):
    xs, ws = _operands(UNALIGNED[:4], dtype, cuda, integer=False, seed=3)
    outs = fused_tenant_gemm(xs, ws, grid_mode=grid_mode)
    kw = dict(block_t=128, block_k=128, block_n=128)
    padded = pad_operands(xs, ws, **kw)
    stacked = partitioned_matmul(*padded, grid_mode=grid_mode, **kw)
    plain = _plain(padded, 128)
    assert ((stacked - plain).abs().max() / plain.abs().max()).item() < 1e-4
    for x, w, out in zip(xs, ws, outs):
        ref = x.float() @ w.float()
        assert ((out - ref).abs().max() / ref.abs().max()).item() < 1e-4


@pytest.mark.parametrize("grid_mode", ["dense", "compact"])
def test_fused_reads_operands_in_place(cuda, grid_mode, monkeypatch):
    def no_padding(*args, **kwargs):
        raise AssertionError("pad_operands on the card path")

    monkeypatch.setattr(ops, "pad_operands", no_padding)
    big = torch.randint(-4, 5, (64, 300), device=cuda).float()
    xs = [big[:50, 3:150], big[1:2, :33]]  # row-strided views, odd offsets
    ws = [torch.randint(-4, 5, (147, 65), device=cuda).float()]
    ws.append(torch.randint(-4, 5, (33, 7), device=cuda).float())
    outs = fused_tenant_gemm(xs, ws, grid_mode=grid_mode)
    for x, w, out in zip(xs, ws, outs):
        assert out.dtype == torch.float32 and out.is_contiguous()
        assert out.shape == (x.shape[0], w.shape[1])
        assert torch.equal(out, x @ w)


def test_mixed_dtypes_cast_only_the_bf16_side(cuda):
    x = torch.randint(-4, 5, (40, 70), device=cuda).to(torch.bfloat16)
    w = torch.randint(-4, 5, (70, 30), device=cuda).float()
    (out,) = fused_tenant_gemm([x], [w])
    assert torch.equal(out, x.float() @ w)


# every T, K and N beside each of the others' values once: 64- and 128-row
# and -column tiles, depths under a K slice and off one, rows of 2 and 4
# bytes and of 16-byte multiples
FEEDS = [
    (t, k, (1, 2, 100, 513)[(i + j) % 4])
    for i, t in enumerate((1, 64, 65, 129))
    for j, k in enumerate((1, 63, 147, 1025))
]


def _views(shapes, pitch, offset, device, seed):
    """Integer-valued bfloat16 operands as views into larger buffers: rows
    ``pitch(cols)`` values apart, ``offset`` values from a buffer's start."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(rows, cols):
        flat = torch.randint(-4, 5, (offset + rows * pitch(cols),), generator=gen,
                             device=device).to(torch.bfloat16)
        return flat[offset:].view(rows, pitch(cols))[:, :cols]

    return [draw(t, k) for t, k, _ in shapes], [draw(k, n) for _, k, n in shapes]


@pytest.fixture(params=[0, 10**9], ids=["per-segment", "narrow-launch"])
def tile_rule(request, monkeypatch):
    """The launch's tile rule, through the card's multiprocessors as the
    launch sees them: none (each segment's own tile shape), or more than
    the launch's 64 x 64 tiles (those throughout); the table caches are
    cleared around it."""
    monkeypatch.setattr(pm, "sm_count", lambda index: request.param)
    pm.tenant_table.cache_clear()
    yield request.param
    pm.tenant_table.cache_clear()


@pytest.mark.parametrize("grid_mode", ["dense", "compact"])
@pytest.mark.parametrize(
    "pitch, offset",
    [
        (lambda c: c, 0),  # contiguous: TMA where the rows are 16-byte multiples
        (lambda c: -(-c // 8) * 8 + 8, 8),  # aligned views: TMA, pitch != cols
        (lambda c: c + 1, 1),  # 2-byte boundaries: the staged feed
        (lambda c: -(-c // 2) * 2 + 2, 2),  # 4-byte boundaries: the staged feed
    ],
    ids=["contiguous", "aligned-views", "2-byte", "4-byte"],
)
def test_bf16_feeds_bit_exact_at_every_tile_shape(
    cuda, pitch, offset, grid_mode, tile_rule
):
    xs, ws = _views(FEEDS, pitch, offset, cuda, seed=5)
    outs = fused_tenant_gemm(xs, ws, grid_mode=grid_mode)
    for x, w, out in zip(xs, ws, outs):
        assert out.is_contiguous() and torch.equal(out, x.float() @ w.float())


def test_bf16_tenants_past_the_tensor_maps_are_staged(cuda):
    # 40 aligned tenants want 80 tensor maps, more than one launch encodes:
    # the rest take the staged feed, in the same launch
    shapes = [(64 + i, 64 * (1 + i % 3), 64 + 8 * i) for i in range(40)]
    xs, ws = _views(shapes, lambda c: c, 0, cuda, seed=6)
    before = launch_counts()
    outs = fused_tenant_gemm(xs, ws, grid_mode="compact")
    after = launch_counts()
    assert after["compact"] == before["compact"] + 1
    for x, w, out in zip(xs, ws, outs):
        assert torch.equal(out, x.float() @ w.float())


def test_wrapper_raises_past_the_table_capacity(cuda):
    n = MAX_TENANTS + 1
    xs = [torch.ones((2, 3), device=cuda)] * n
    ws = [torch.ones((3, 4), device=cuda)] * n
    with pytest.raises(ValueError, match="MAX_TENANTS"):
        fused_tenant_gemm(xs, ws, block_t=128, block_k=128, block_n=128)
    n_blocks = MAX_SEGMENTS + 1
    xs = torch.ones((2, 16, 16), device=cuda)
    w = torch.ones((16, 16 * n_blocks), device=cuda)
    owner = [i % 2 for i in range(n_blocks)]
    with pytest.raises(ValueError, match="MAX_SEGMENTS"):
        partitioned_matmul(xs, w, owner, [16, 16], block_t=16, block_k=16, block_n=16)


def test_wrapper_checks_devices_and_layout(cuda):
    xs = torch.ones((1, 128, 128), device=cuda)
    with pytest.raises(ValueError, match="on"):
        partitioned_matmul(xs, torch.ones((128, 128)), [0], [128])
    with pytest.raises(ValueError, match="contiguous"):
        partitioned_matmul(xs, torch.ones((128, 128), device=cuda).t(), [0], [128])
    with pytest.raises(ValueError, match="owner entries"):
        partitioned_matmul(xs, torch.ones((128, 128), device=cuda), [3], [128])


# ---------------------------------------------------------------------------
# the epilogue: the expert layer's calls, bfloat16 SiLU·up and gate-weighted
# rows written into one buffer by the compact kernel's own instantiation
# ---------------------------------------------------------------------------

# tokens x 4 slots of the LFM2 cell's prefill step, its widths, 64 experts
CELL_SLOTS, CELL_D, CELL_F, CELL_E = 16_384 * 4, 2048, 1536, 64


def _cell_rows(device):
    """Rows per expert of one routed layer: ~1,024 each, four empty."""
    gen = torch.Generator().manual_seed(40)
    rows = torch.multinomial(torch.ones(CELL_E), CELL_SLOTS, replacement=True,
                             generator=gen)
    counts = torch.bincount(rows, minlength=CELL_E).tolist()
    for e in (3, 17, 40, 63):
        counts[(e + 1) % CELL_E] += counts[e]
        counts[e] = 0
    return counts


def _expert_operands(rows, d, n, device, seed, extra=0, offset=0):
    """One sorted row buffer split into the experts' x and a (E, d, n) stack
    of w, bfloat16, rows ``extra`` values longer than their columns and
    ``offset`` values into their storage."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(r, c, scale):
        flat = torch.randn(offset + r * (c + extra), generator=gen, device=device)
        return (flat * scale).to(torch.bfloat16)[offset:].view(r, c + extra)[:, :c]

    x = draw(sum(rows), d, 1.0)
    stack = draw(len(rows) * d, n, d**-0.5)
    return list(x.split(rows)), [stack[e * d : (e + 1) * d] for e in range(len(rows))]


def _held(got, want32):
    """``got`` (bfloat16) is ``want32`` rounded: within one bfloat16 ulp."""
    torch.testing.assert_close(got.float(), want32, rtol=2**-7, atol=1e-5)


def _epilogue_calls(cuda, rows, d, f, **view):
    """gate‖up with the SwiGLU epilogue and down with a row scale, each into
    one buffer, against the default path's f32 outputs; one launch each."""
    xs, ws = _expert_operands(rows, d, 2 * f, cuda, seed=41, **view)
    S = sum(rows)
    act = torch.empty((S, f), dtype=torch.bfloat16, device=cuda)
    before = launch_counts()
    outs = fused_tenant_gemm(xs, ws, grid_mode="compact", epilogue="swiglu", out=act)
    assert launch_counts()["compact"] == before["compact"] + 1
    ref = fused_tenant_gemm(xs, ws, grid_mode="compact")
    for o, t, y in zip(outs, act.split(rows), ref):
        assert o.data_ptr() == t.data_ptr() and o.shape == t.shape
        _held(o, torch.nn.functional.silu(y[:, :f]) * y[:, f:])
    downs = _expert_operands(rows, f, d, cuda, seed=42, **view)[1]
    gates = torch.rand(S, generator=torch.Generator(device=cuda).manual_seed(43),
                       device=cuda)
    y = torch.empty((S, d), dtype=torch.bfloat16, device=cuda)
    before = launch_counts()
    outs = fused_tenant_gemm(act.split(rows), downs, grid_mode="compact",
                             row_scale=gates, out=y)
    assert launch_counts()["compact"] == before["compact"] + 1
    ref = fused_tenant_gemm(act.split(rows), downs, grid_mode="compact")
    for o, r, g in zip(outs, ref, gates.split(rows)):
        # the same sums, times the same gate, rounded once
        assert torch.equal(o, (r * g[:, None]).to(torch.bfloat16))
    return act, y


def test_the_epilogue_at_the_cell_s_expert_calls(cuda):
    """64 ragged experts of ~1,024 rows at d = 2,048 and f = 1,536, each x
    a split of one row buffer and each w a slice of one stack: two shared
    tensor maps a call feed every tenant by TMA."""
    _epilogue_calls(cuda, _cell_rows(cuda), CELL_D, CELL_F)


@pytest.mark.parametrize(
    "view",
    [{}, {"extra": 1, "offset": 1}, {"extra": 3, "offset": 2}],
    ids=["contiguous", "2-byte", "4-byte"],
)
@pytest.mark.parametrize("f", [96, 33])
def test_the_epilogue_at_unaligned_pitches(cuda, f, view):
    """Rows on 16-, 2- and 4-byte boundaries (TMA, the staged feed), an f
    that is not a multiple of 64 (the up block past w's last column)."""
    _epilogue_calls(cuda, [0, 37, 129, 1, 200, 0, 64, 65], 147, f, **view)


def test_the_epilogue_writes_only_the_buffer_s_columns(cuda):
    rows, d, f = [0, 37, 129, 1, 200], 147, 96
    xs, ws = _expert_operands(rows, d, 2 * f, cuda, seed=44)
    wide = torch.full((sum(rows), f + 3), 5.0, dtype=torch.bfloat16, device=cuda)
    buf = wide[:, 1 : f + 1]  # rows of an odd pitch: no 4-byte stores
    scale = torch.linspace(-1, 1, sum(rows), device=cuda)
    outs = fused_tenant_gemm(xs, ws, epilogue="swiglu", row_scale=scale, out=buf)
    assert torch.all(wide[:, 0] == 5) and torch.all(wide[:, f + 1 :] == 5)
    for o, y, s in zip(outs, fused_tenant_gemm(xs, ws, grid_mode="compact"),
                       scale.split(rows)):
        _held(o, torch.nn.functional.silu(y[:, :f]) * y[:, f:] * s[:, None])


def test_the_epilogue_refuses_dense_and_float32(cuda):
    xs = [torch.ones((4, 8), device=cuda)]
    ws = [torch.ones((8, 16), device=cuda)]
    with pytest.raises(TypeError):
        fused_tenant_gemm(xs, ws, epilogue="swiglu")
    with pytest.raises(ValueError, match="compact"):
        fused_tenant_gemm([xs[0].bfloat16()], [ws[0].bfloat16()],
                          epilogue="swiglu", grid_mode="dense")


# ---------------------------------------------------------------------------
# shared tensor maps: operands that are row-views of one storage read one map
# ---------------------------------------------------------------------------


def _fed(fn, xs, ws, **kw):
    """``fn(xs, ws, **kw)`` and the launcher's counts of its operands by
    feed (``launch_stats()["feed"]``), held against ``operand_feeds`` of
    the launch's table."""
    before = launch_stats()["feed"]
    got = fn(xs, ws, **kw)
    after = launch_stats()["feed"]
    fed = {k: after[k] - before[k] for k in after}
    shapes = tuple((x.shape[0], x.shape[1], w.shape[1]) for x, w in zip(xs, ws))
    lds = tuple(x.stride(0) for x in xs), tuple(w.stride(0) for w in ws)
    sms = pm.sm_count(xs[0].device.index)
    if "out" in kw:
        table = pm.epilogue_table(shapes, *lds, kw["out"].stride(0),
                                  kw.get("epilogue") == "swiglu", sms)
    else:
        table = pm.tenant_table(shapes, *lds, kw["grid_mode"] == "dense", True, sms)
    want = Counter(f for _, _, _, f in pm.operand_feeds(table, (*xs, *ws)))
    assert fed == {k: want[k] for k in fed}
    return got, fed


def test_shared_maps_are_the_per_tenant_copies_bit_for_bit(cuda):
    """The cell's two expert calls, x one sorted buffer's split and w one
    stack's unbind (every operand through two shared maps), against the same
    calls on per-tenant copies (a map each for the first 12 tenants, the
    other live ones staged): the same bits."""
    rows = _cell_rows(cuda)
    live = sum(1 for r in rows if r)
    S, d, f = sum(rows), CELL_D, CELL_F
    gen = torch.Generator(device=cuda).manual_seed(45)

    def draw(*shape, scale=1.0):
        v = torch.randn(shape, generator=gen, device=cuda) * scale
        return v.to(torch.bfloat16)

    x, gate_up, down = draw(S, d), draw(CELL_E, d, 2 * f, scale=d**-0.5), draw(
        CELL_E, f, d, scale=f**-0.5)
    gates = torch.rand(S, generator=gen, device=cuda)
    calls = {}
    for name, xs, ws in (("shared", list(x.split(rows)), list(gate_up.unbind(0))),
                         ("copies", [t.clone() for t in x.split(rows)],
                          [w.clone() for w in gate_up.unbind(0)])):
        act = torch.empty((S, f), dtype=torch.bfloat16, device=cuda)
        _, up_fed = _fed(fused_tenant_gemm, xs, ws, epilogue="swiglu", out=act)
        a = list(act.split(rows))
        dws = list(down.unbind(0))
        if name == "copies":
            a, dws = [t.clone() for t in a], [w.clone() for w in dws]
        y = torch.empty((S, d), dtype=torch.bfloat16, device=cuda)
        _, down_fed = _fed(fused_tenant_gemm, a, dws, row_scale=gates, out=y)
        calls[name] = act, y, up_fed, down_fed
    shared, copies = calls["shared"], calls["copies"]
    assert torch.equal(shared[0], copies[0]) and torch.equal(shared[1], copies[1])
    assert torch.isfinite(shared[1].float()).all()
    mapped = pm.MAX_MAPS
    for fed in shared[2:]:
        assert fed == {"own_map": 0, "shared_map": 2 * live, "staged": 0}
    for fed in copies[2:]:
        assert fed == {"own_map": mapped, "shared_map": 0, "staged": 2 * live - mapped}


def _near(outs, xs, ws):
    """Every output finite and within 1e-4 of a float32 matmul of the same
    operands."""
    for x, w, o in zip(xs, ws, outs):
        ref = x.float() @ w.float()
        assert torch.isfinite(o).all()
        if ref.numel():
            assert ((o - ref).abs().max() / ref.abs().max()).item() < 1e-4


@pytest.mark.parametrize("grid_mode", ["dense", "compact"])
def test_a_shared_x_past_a_tenant_s_rows_never_reaches_its_output(cuda, grid_mode):
    """Tenants whose rows end mid-tile in one storage, the rows between and
    after them no tenant's, holding NaN and Inf: their 128-row boxes read
    those rows, whose sums are never stored."""
    gen = torch.Generator(device=cuda).manual_seed(46)
    K = 192
    buf = torch.randn((700, K), generator=gen, device=cuda).to(torch.bfloat16)
    buf[100:150] = float("nan")
    buf[150:160, ::2] = float("inf")
    buf[600:] = float("-inf")
    xs = [buf[0:100], buf[160:300], buf[300:301], buf[400:600]]
    ws = [torch.randn((K, n), generator=gen, device=cuda).to(torch.bfloat16)
          for n in (64, 136, 56, 256)]
    outs, fed = _fed(fused_tenant_gemm, xs, ws, grid_mode=grid_mode)
    assert fed == {"own_map": 4, "shared_map": 4, "staged": 0}
    _near(outs, xs, ws)


def test_a_stacked_w_off_the_k_slice_keeps_a_map_of_its_own(cuda):
    """Experts of depth 100 (not a whole number of 64-deep K slices) in one
    stack, the neighbouring experts' first rows Inf: each w is read
    through a map of its own, zero past its depth, so no 0 x Inf."""
    gen = torch.Generator(device=cuda).manual_seed(47)
    K, N = 100, 192
    stack = torch.randn((4, K, N), generator=gen, device=cuda).to(torch.bfloat16)
    stack[1, :8] = float("inf")
    stack[3, :8] = float("-inf")
    # x rows 104 values apart (208 bytes): TMA-fed, one shared map
    x = torch.randn((300, K + 4), generator=gen, device=cuda).to(torch.bfloat16)
    xs, ws = [x[:130, :K], x[130:, :K]], [stack[0], stack[2]]
    for mode in ("dense", "compact"):
        outs, fed = _fed(fused_tenant_gemm, xs, ws, grid_mode=mode)
        assert fed == {"own_map": 2, "shared_map": 2, "staged": 0}
        _near(outs, xs, ws)


def test_a_launch_mixes_shared_own_and_staged_operands(cuda):
    """Experts of one storage (shared maps), tenants with buffers of their
    own (their own maps) and one tenant on a view 2 bytes off (staged), in
    one launch."""
    gen = torch.Generator(device=cuda).manual_seed(48)
    K, N = 256, 192

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)

    rows, stack = draw(500, K), draw(3, K, N)
    off = draw(90 * K + 1)[1:].view(90, K)  # 2 bytes past a 16-byte boundary
    xs = [*rows.split([200, 0, 300])[::2], draw(77, K), off, draw(64, K)]
    ws = [stack[0], stack[2], draw(K, N), draw(K, N), stack[1]]
    for mode in ("dense", "compact"):
        outs, fed = _fed(fused_tenant_gemm, xs, ws, grid_mode=mode)
        # x: the two splits share; the own-buffer ones map alone, the view
        # 2 bytes off is staged; w: the three stack slices share
        assert fed == {"own_map": 4, "shared_map": 5, "staged": 1}
        _near(outs, xs, ws)


# heavy-b128's first wave at batch 8 (table1-heavy, layer 0 of each tenant)
HEAVY_WAVE = [(24200, 363, 96), (100352, 147, 64), (100352, 147, 64),
              (432, 900, 100), (432, 900, 64), (2048, 256, 256), (2888, 153, 256),
              (1024, 512, 1536)]
# sha256 of the wave's f32 outputs from the operands of ``_wave_digest``,
# taken with the kernels as they were before the epilogue was added, on an
# NVIDIA H100 80GB HBM3: the default path's arithmetic is unchanged
HEAVY_WAVE_DIGEST = "a29459f25020cc5a2b26578ef47780343705ab7793039fb0180e0bf500a331d0"


def _wave_digest(device):
    import hashlib

    gen = torch.Generator().manual_seed(45)
    xs = [torch.randn((t, k), generator=gen).to(torch.bfloat16).to(device)
          for t, k, _ in HEAVY_WAVE]
    ws = [torch.randn((k, n), generator=gen).to(torch.bfloat16).to(device)
          for _, k, n in HEAVY_WAVE]
    h = hashlib.sha256()
    for o in fused_tenant_gemm(xs, ws, grid_mode="auto"):
        h.update(o.cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize(
    "shapes, dense",
    [
        ([(300, 200, 100), (300, 200, 7), (300, 200, 513)], True),  # N differs
        ([(300, 200, 100), (299, 200, 100)], False),  # rows differ
        ([(300, 200, 100), (300, 201, 100)], False),  # depths differ
        (HEAVY_WAVE, False),
    ],
    ids=["same-rows-and-depth", "ragged-rows", "ragged-depth", "heavy-wave"],
)
def test_an_auto_call_on_the_card_reads_only_the_shapes(cuda, shapes, dense):
    """The card's auto mode takes the kernel the tenants' shapes name and
    neither tunes nor counts the JAX package's partition blocks."""
    xs, ws = _operands(shapes, torch.bfloat16, cuda, integer=True, seed=7)
    tuned = ops.autotune_blocks.cache_info()
    counted = ops._geometry_accounting.cache_info()
    before = launch_counts()
    outs = fused_tenant_gemm(xs, ws, grid_mode="auto")
    after = launch_counts()
    assert ops.autotune_blocks.cache_info() == tuned
    assert ops._geometry_accounting.cache_info() == counted
    assert pm._dense_fits(tuple(shapes)) == dense
    assert after["dense"] == before["dense"] + dense
    assert after["compact"] == before["compact"] + (not dense)
    for x, w, out in zip(xs, ws, outs):
        assert torch.equal(out, x.float() @ w.float())


def test_the_default_path_is_the_parent_s_bit_for_bit(cuda):
    """A call without the epilogue computes what it computed before it."""
    assert _wave_digest(cuda) == HEAVY_WAVE_DIGEST


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_decode_step_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs import get
    from repro_torch.models.model import decode_step, init_cache, init_params

    cfg = get("llama3.2-3b").smoke
    cpu_params = init_params(cfg, 0, device="cpu")
    gpu_params = _to(cpu_params, cuda)
    caches = init_cache(cfg, 2, 8, device="cpu"), init_cache(cfg, 2, 8, device=cuda)
    lens = np.array([0, 3])
    for step in range(3):
        tok = torch.tensor([[step + 1], [400 - step]])
        ref, _ = decode_step(cfg, cpu_params, caches[0], tok, torch.from_numpy(lens))
        lens_d = torch.from_numpy(lens).to(cuda)
        out, _ = decode_step(cfg, gpu_params, caches[1], tok.to(cuda), lens_d)
        # bf16 activations: the tolerance of tests/test_torch_models.py
        torch.testing.assert_close(out.float().cpu(), ref.float(), rtol=3e-2, atol=3e-2)
        lens = lens + 1
