"""Hopper CUDA kernels: the paper's partitioned-WS GEMM (+ plain versions)."""

from repro_torch.kernels.ops import (
    BLOCK_CANDIDATES,
    FusedGemmStats,
    autotune_blocks,
    build_owner_map,
    fused_tenant_gemm,
    pad_operands,
    record_gemm_stats,
    sequential_tenant_gemm,
)
from repro_torch.kernels.partitioned_matmul import (
    GRID_MODES,
    BlockAccounting,
    compact_run_list,
    grid_accounting,
    kernel_smem_bytes,
    launch_counts,
    live_block_tables,
    partitioned_matmul,
    reset_launch_counts,
)
from repro_torch.kernels.ref import matmul_ref, partitioned_matmul_ref

__all__ = [
    "BLOCK_CANDIDATES",
    "BlockAccounting",
    "FusedGemmStats",
    "GRID_MODES",
    "autotune_blocks",
    "build_owner_map",
    "compact_run_list",
    "fused_tenant_gemm",
    "grid_accounting",
    "kernel_smem_bytes",
    "launch_counts",
    "live_block_tables",
    "matmul_ref",
    "pad_operands",
    "partitioned_matmul",
    "partitioned_matmul_ref",
    "record_gemm_stats",
    "reset_launch_counts",
    "sequential_tenant_gemm",
]
