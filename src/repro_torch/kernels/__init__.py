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
    LaunchTable,
    grid_accounting,
    launch_table,
    live_block_tables,
    partitioned_matmul,
    stacked_table,
    tenant_matmul,
    tenant_table,
)
from repro_torch.kernels.ref import matmul_ref, partitioned_matmul_ref
from repro_torch.kernels.tracing import (
    TableCounts,
    launch_counts,
    launch_stats,
    reset_launch_counts,
    reset_launch_stats,
    set_tracing,
)

__all__ = [
    "BLOCK_CANDIDATES",
    "BlockAccounting",
    "FusedGemmStats",
    "GRID_MODES",
    "LaunchTable",
    "TableCounts",
    "autotune_blocks",
    "build_owner_map",
    "fused_tenant_gemm",
    "grid_accounting",
    "launch_counts",
    "launch_stats",
    "launch_table",
    "live_block_tables",
    "matmul_ref",
    "pad_operands",
    "partitioned_matmul",
    "partitioned_matmul_ref",
    "record_gemm_stats",
    "reset_launch_counts",
    "reset_launch_stats",
    "sequential_tenant_gemm",
    "set_tracing",
    "stacked_table",
    "tenant_matmul",
    "tenant_table",
]
