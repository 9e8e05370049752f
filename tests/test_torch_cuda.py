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

from repro_torch.kernels import (
    fused_tenant_gemm,
    launch_counts,
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
