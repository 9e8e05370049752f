"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels build at
first use) and skips elsewhere.  Run on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports no JAX: the card's machine has none.  ``chip_smoke.py``
covers the main path's shapes; these tests cover what it does not — partition
blocks that are not multiples of the 64 × 64 CTA tile (masked column, row
and depth bounds), the wrapper's checks and the launch counters.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (
    fused_tenant_gemm,
    launch_counts,
    pad_operands,
    partitioned_matmul,
    partitioned_matmul_ref,
)

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
    out = partitioned_matmul(xs, w, [0], [0], grid_mode="compact")  # nothing live
    assert torch.all(out == 0) and launch_counts() == before
    partitioned_matmul(xs, w, [0], [128], grid_mode="compact")
    partitioned_matmul(xs, w, [0], [128], grid_mode="dense")
    partitioned_matmul(xs.cpu(), w.cpu(), [0], [128])  # plain version: no launch
    after = launch_counts()
    assert after["compact"] == before["compact"] + 1
    assert after["dense"] == before["dense"] + 1


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
