"""Multi-tenant partitioned weight-stationary GEMM — the paper's kernel on Hopper.

Counterpart of ``repro.kernels.partitioned_matmul``.  The paper partitions
a systolic array *vertically*: every tenant owns a contiguous range of PE
columns, and a one-gate PE change (``Mul_En``) keeps the multipliers of a
tenant's idle rows and depth from firing.  Here, as in the JAX package:

* PE columns        →  the GEMM **N dimension**;
* vertical slices   →  disjoint contiguous **N-block ranges**, one per tenant
  (the ``owner`` map — the partition table of Algorithm 1);
* ``Mul_En`` gating →  ``grid_mode="dense"`` launches every output tile and
  gates each dead K step (past a tenant's valid rows or reduction depth);
  ``grid_mode="compact"`` launches only the live tiles, from a run list built
  on the host, so dead work is neither scheduled nor fetched.

All tenants share ONE kernel launch.  The kernels are hand-written CUDA C++
(``csrc/partitioned_matmul.cu``), built at first use by ``_build.py``.  On
CPU tensors :func:`partitioned_matmul` computes the plain version
(``ref.partitioned_matmul_ref``); on CUDA tensors it launches a kernel or
raises.

The host side (dtype contract, live-block tables, accounting) is NumPy, as
the JAX package's host side is; ``grid_accounting`` counts in the partition
blocks ``(block_t, block_k, block_n)``, which decide liveness and ownership.
The kernels' CTA tile is their own (see the CUDA source).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import partitioned_matmul_ref

DEFAULT_BLOCK_T = 128
DEFAULT_BLOCK_K = 128
DEFAULT_BLOCK_N = 128

_ALLOWED_DTYPES = (torch.bfloat16, torch.float32)

GRID_MODES = ("dense", "compact")

# launches of each kernel in this process; each wrapper adds one where it
# launches its kernel and nowhere else (the CPU path launches nothing)
dense_launches = 0
compact_launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches since the process started or the last reset."""
    return {"dense": dense_launches, "compact": compact_launches}


def reset_launch_counts() -> None:
    global dense_launches, compact_launches
    dense_launches = compact_launches = 0


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _itemsize(dtype) -> int:
    """Bytes per element of a ``torch.dtype`` or its name (``"float32"``)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype.removeprefix("torch."))
    return dtype.itemsize


def _validate_promote(
    xs: torch.Tensor, w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Enforce the bf16/f32 operand contract; promote mixed pairs to f32."""
    for name, arr in (("xs", xs), ("w", w)):
        if arr.dtype not in _ALLOWED_DTYPES:
            raise TypeError(
                f"{name} dtype {arr.dtype} unsupported: the partitioned-WS "
                "kernel accepts bfloat16 or float32 operands (cast ints / "
                "f16 / f64 on the host first)"
            )
    if xs.dtype != w.dtype:  # bf16 × f32 → promote both to f32
        common = torch.promote_types(xs.dtype, w.dtype)
        xs, w = xs.to(common), w.to(common)
    return xs, w


def _host_ints(a) -> np.ndarray:
    """Partition state as a host int64 array (it is host state by design:
    Algorithm 1 recomputes it per scheduling round)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.int64)


# ---------------------------------------------------------------------------
# live-block enumeration + accounting (host side, concrete partition state)
# ---------------------------------------------------------------------------


def _live_extents(
    owner: np.ndarray,
    valid_t: np.ndarray,
    valid_k: np.ndarray,
    *,
    T: int,
    K: int,
    block_t: int,
    block_k: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Per N-block live extents: (t_blocks_live, k_blocks_live) arrays.

    A block column owned by tenant ``e`` has ``ceil(valid_t[e]/block_t)``
    live T-blocks and ``ceil(valid_k[e]/block_k)`` live K-blocks — live
    blocks always form a contiguous prefix.
    """
    vt = np.clip(valid_t[owner], 0, T)
    vk = np.clip(valid_k[owner], 0, K)
    tl = -(-vt // block_t)
    kl = -(-vk // block_k)
    tl = np.where(kl > 0, tl, 0)  # a zero-depth reduction has no live tiles
    return tl.astype(np.int64), kl.astype(np.int64)


def _tables_from_extents(
    tl: np.ndarray, kl: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    nidx, tidx, kidx, last = [], [], [], []
    for n in range(tl.shape[0]):
        kn = int(kl[n])
        for t in range(int(tl[n])):
            for k in range(kn):
                nidx.append(n)
                tidx.append(t)
                kidx.append(k)
                last.append(1 if k == kn - 1 else 0)
    return (
        np.asarray(nidx, np.int32),
        np.asarray(tidx, np.int32),
        np.asarray(kidx, np.int32),
        np.asarray(last, np.int32),
    )


def live_block_tables(
    owner,
    valid_t,
    valid_k,
    *,
    T: int,
    K: int,
    block_t: int = DEFAULT_BLOCK_T,
    block_k: int = DEFAULT_BLOCK_K,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Flattened live-block index tables ``(nidx, tidx, kidx, last_k)``.

    Entry ``i`` names the ``i``-th live ``(n, t, k)`` block in the order the
    compact schedule walks them; ``last_k[i]`` flags the final step of its
    K-run.  K is innermost and every K-run is contiguous.
    """
    tl, kl = _live_extents(
        _host_ints(owner),
        _host_ints(valid_t),
        _host_ints(valid_k),
        T=T,
        K=K,
        block_t=block_t,
        block_k=block_k,
    )
    return _tables_from_extents(tl, kl)


def compact_run_list(
    tl: np.ndarray,
    kl: np.ndarray,
    *,
    block_t: int,
    block_k: int,
    block_n: int,
    tile_rows: int,
    tile_cols: int,
) -> np.ndarray:
    """The compact kernel's launch list: one int32 row per CTA.

    A row is ``(cta_col, cta_row, k_end, row_end)``: the CTA's column tile
    (column block ``n`` is cut into ``ceil(block_n / tile_cols)`` of them),
    its row tile, the live depth ``k_live · block_k`` and the live row bound
    ``t_live · block_t`` of the block column.  Only tiles holding live rows
    appear, so the list covers exactly the live ``(n, t)`` blocks.
    """
    sub = _ceil_div(block_n, tile_cols)
    row_end = tl.astype(np.int64) * block_t
    row_tiles = -(-row_end // tile_rows)
    per_n = row_tiles * sub  # CTAs of each block column, j-major then t
    n = np.repeat(np.arange(tl.shape[0]), per_n)
    i = np.arange(n.size) - np.repeat(np.cumsum(per_n) - per_n, per_n)
    j, t = np.divmod(i, np.maximum(row_tiles[n], 1))
    runs = np.stack([n * sub + j, t, kl[n] * block_k, row_end[n]], axis=1)
    return runs.astype(np.int32).reshape(-1, 4)


@dataclasses.dataclass(frozen=True)
class BlockAccounting:
    """Per-call grid/traffic accounting of one ``partitioned_matmul``.

    ``blocks_total`` is the dense iteration space ``n·t·k``;
    ``blocks_scheduled`` is what the chosen grid mode walks (dense: all of
    it; compact: live blocks only); ``blocks_live`` is the MAC-firing
    subset; ``blocks_skipped`` are scheduled-but-gated steps.  Byte counts
    follow a one-fetch-per-scheduled-block model (x and w blocks in, one f32
    out block per drained (n, t) run) — the same model as the JAX package,
    so the two count the same numbers.
    """

    grid_mode: str
    block_t: int
    block_k: int
    block_n: int
    blocks_total: int
    blocks_scheduled: int
    blocks_live: int
    blocks_skipped: int
    x_bytes_fetched: int
    w_bytes_fetched: int
    out_bytes_written: int

    @property
    def bytes_fetched(self) -> int:
        return self.x_bytes_fetched + self.w_bytes_fetched

    @property
    def schedule_efficiency(self) -> float:
        """Live fraction of scheduled steps (1.0 = zero dead work)."""
        if not self.blocks_scheduled:
            return 1.0
        return self.blocks_live / self.blocks_scheduled

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)} | {
            "bytes_fetched": self.bytes_fetched,
            "schedule_efficiency": self.schedule_efficiency,
        }


def grid_accounting(
    *,
    T: int,
    K: int,
    N: int,
    owner,
    valid_t,
    valid_k=None,
    block_t: int = DEFAULT_BLOCK_T,
    block_k: int = DEFAULT_BLOCK_K,
    block_n: int = DEFAULT_BLOCK_N,
    x_dtype=torch.float32,
    w_dtype=torch.float32,
    grid_mode: str = "dense",
) -> BlockAccounting:
    """Predict the grid/traffic accounting of a ``partitioned_matmul`` call.

    Pure host arithmetic over the concrete partition state (the block-size
    autotuner ranks candidates with it).
    """
    if grid_mode not in GRID_MODES:
        raise ValueError(f"grid_mode must be one of {GRID_MODES}, got {grid_mode!r}")
    owner = _host_ints(owner)
    valid_t = _host_ints(valid_t)
    valid_k = (
        np.full(valid_t.shape, K, np.int64) if valid_k is None else _host_ints(valid_k)
    )
    n_blocks = _ceil_div(N, block_n)
    t_blocks = _ceil_div(T, block_t)
    k_blocks = _ceil_div(K, block_k)
    tl, kl = _live_extents(
        owner, valid_t, valid_k, T=T, K=K, block_t=block_t, block_k=block_k
    )
    live = int((tl * kl).sum())
    live_runs = int(tl.sum())  # drained (n, t) tiles
    total = n_blocks * t_blocks * k_blocks
    if grid_mode == "dense":
        scheduled, runs = total, n_blocks * t_blocks
    else:
        scheduled, runs = live, live_runs
    return BlockAccounting(
        grid_mode=grid_mode,
        block_t=block_t,
        block_k=block_k,
        block_n=block_n,
        blocks_total=total,
        blocks_scheduled=scheduled,
        blocks_live=live,
        blocks_skipped=scheduled - live,
        x_bytes_fetched=scheduled * block_t * block_k * _itemsize(x_dtype),
        w_bytes_fetched=scheduled * block_k * block_n * _itemsize(w_dtype),
        out_bytes_written=runs * block_t * block_n * 4,
    )


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def kernel_smem_bytes() -> int:
    """Static shared memory one CTA of either kernel needs (both operand
    types are staged as float32, so the need does not depend on them)."""
    return _build.geometry()[3]


def _upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """int32 partition tables to the card, asynchronously on the current
    stream (pinned staging; the caching host allocator keeps the staging
    buffer alive until the copy is done)."""
    staged = torch.from_numpy(np.ascontiguousarray(host, np.int32)).pin_memory()
    return staged.to(device, non_blocking=True)


def _check_cuda_operands(xs: torch.Tensor, w: torch.Tensor) -> None:
    if w.device != xs.device:
        raise ValueError(f"xs is on {xs.device} but w is on {w.device}")
    if not (xs.is_contiguous() and w.is_contiguous()):
        raise ValueError("the CUDA kernels need contiguous xs and w")
    props = torch.cuda.get_device_properties(xs.device)
    limit = getattr(
        props, "shared_memory_per_block_optin", props.shared_memory_per_block
    )
    need = kernel_smem_bytes()
    if need > limit:
        raise ValueError(
            f"the kernels' CTA tile needs {need} B of shared memory but "
            f"{props.name} allows {limit} B per block"
        )


def _dense_launch(xs, w, owner, valid_t, valid_k, *, block_t, block_k, block_n):
    global dense_launches
    _, T, K = xs.shape
    N = w.shape[1]
    out = torch.empty((T, N), dtype=torch.float32, device=xs.device)
    if out.numel() == 0:
        return out
    tables = _upload(np.concatenate([owner, valid_t, valid_k]), xs.device)
    base, n_own, E = tables.data_ptr(), owner.size, valid_t.size
    with torch.cuda.device(xs.device):
        err = _build.load().pm_dense(
            int(xs.dtype == torch.bfloat16),
            xs.data_ptr(),
            w.data_ptr(),
            out.data_ptr(),
            base,
            base + 4 * n_own,
            base + 4 * (n_own + E),
            T,
            K,
            N,
            block_t,
            block_k,
            block_n,
            torch.cuda.current_stream(xs.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"dense kernel launch failed: CUDA error {err}")
    dense_launches += 1
    return out


def _compact_launch(xs, w, owner, valid_t, valid_k, *, block_t, block_k, block_n):
    global compact_launches
    _, T, K = xs.shape
    N = w.shape[1]
    tl, kl = _live_extents(
        owner, valid_t, valid_k, T=T, K=K, block_t=block_t, block_k=block_k
    )
    tile_rows, tile_cols, _, _ = _build.geometry()
    runs = compact_run_list(
        tl,
        kl,
        block_t=block_t,
        block_k=block_k,
        block_n=block_n,
        tile_rows=tile_rows,
        tile_cols=tile_cols,
    )
    # unvisited tiles must read zero: zero the whole output first (the TPU
    # version masks them after the call instead)
    out = torch.zeros((T, N), dtype=torch.float32, device=xs.device)
    if runs.shape[0] == 0:  # nothing live: the contract output is all zeros
        return out
    tables = _upload(np.concatenate([runs.ravel(), owner]), xs.device)
    base = tables.data_ptr()
    with torch.cuda.device(xs.device):
        err = _build.load().pm_compact(
            int(xs.dtype == torch.bfloat16),
            xs.data_ptr(),
            w.data_ptr(),
            out.data_ptr(),
            base,
            runs.shape[0],
            base + 4 * runs.size,
            T,
            K,
            N,
            block_n,
            torch.cuda.current_stream(xs.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"compact kernel launch failed: CUDA error {err}")
    compact_launches += 1
    return out


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------


def partitioned_matmul(
    xs: torch.Tensor,
    w: torch.Tensor,
    owner,
    valid_t,
    valid_k=None,
    *,
    block_t: int = DEFAULT_BLOCK_T,
    block_k: int = DEFAULT_BLOCK_K,
    block_n: int = DEFAULT_BLOCK_N,
    grid_mode: str = "dense",
) -> torch.Tensor:
    """Fused multi-tenant GEMM.  See ``ref.partitioned_matmul_ref``.

    xs:      (E, T, K) — per-tenant activations, zero-padded to shared T/K.
    w:       (K, N)    — tenant weights concatenated along N.
    owner:   (N // block_n,) ints — column-block → tenant (partition map).
    valid_t: (E,) ints — valid streamed rows per tenant.
    valid_k: (E,) ints — valid reduction depth per tenant (default: K).
    Returns  (T, N) f32 on xs's device.

    The partition state (``owner``/``valid_t``/``valid_k``: tensors, arrays
    or lists) is read on the host.  The JAX version must reject traced
    partition state in compact mode; eager PyTorch has no tracers, so that
    check has no counterpart here.

    On CPU tensors the result is the plain version; on CUDA tensors
    ``grid_mode="dense"`` launches every output tile and gates dead K steps,
    ``"compact"`` launches only the live tiles — identical results.
    Operands must be bfloat16 or float32 (mixed pairs promote to float32).
    """
    xs, w = _validate_promote(xs, w)
    E, T, K = xs.shape
    K2, N = w.shape
    if K2 != K:
        raise ValueError(f"K mismatch: xs {K} vs w {K2}")
    for name, dim, blk in (("T", T, block_t), ("K", K, block_k), ("N", N, block_n)):
        if dim % blk:
            raise ValueError(
                f"{name}={dim} not divisible by block {blk}; "
                "pad in ops.fused_tenant_gemm"
            )
    n_blocks = N // block_n
    owner = _host_ints(owner)
    if owner.shape != (n_blocks,):
        raise ValueError(f"owner must be ({n_blocks},), got {owner.shape}")
    if owner.size and (owner.min() < 0 or owner.max() >= E):
        raise ValueError(f"owner entries must lie in [0, {E})")
    valid_t = _host_ints(valid_t)
    valid_k = np.full((E,), K, np.int64) if valid_k is None else _host_ints(valid_k)
    if valid_t.shape != (E,) or valid_k.shape != (E,):
        raise ValueError(
            f"valid_t and valid_k must be ({E},), got {valid_t.shape} and "
            f"{valid_k.shape}"
        )
    if grid_mode not in GRID_MODES:
        raise ValueError(f"grid_mode must be one of {GRID_MODES}, got {grid_mode!r}")
    if xs.device.type == "cpu":
        return partitioned_matmul_ref(
            xs, w, torch.from_numpy(owner), torch.from_numpy(valid_t), block_n
        )
    if xs.device.type != "cuda":
        raise ValueError(f"no kernel for device {xs.device}")
    _check_cuda_operands(xs, w)
    launch = _dense_launch if grid_mode == "dense" else _compact_launch
    return launch(
        xs,
        w,
        owner,
        valid_t,
        valid_k,
        block_t=block_t,
        block_k=block_k,
        block_n=block_n,
    )

