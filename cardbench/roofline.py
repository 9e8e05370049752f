"""The yardstick's arithmetic: the card's peaks and a GEMM's work.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W power limit): 989 TFLOP/s on the tensor cores in bfloat16 and
float16, 67 TFLOP/s in float32 outside them, 3.35 TB/s of HBM.

A GEMM ``x @ w`` with x of (T, K) and w of (K, N) does ``2 T K N`` useful
FLOPs, reads each operand byte once and writes its (T, N) float32 output
once.  A fused call's bound is the larger of its FLOPs over the peak and its
bytes over the memory rate, summed over the call's tenants first: the least
time the card could take for the call, whatever the kernel reads again.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
ITEM_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
OUT_BYTES = 4  # fused_tenant_gemm writes float32


def gemm_flops(t: int, k: int, n: int) -> int:
    return 2 * t * k * n


def gemm_bytes(t: int, k: int, n: int, dtype: str) -> int:
    return (t * k + k * n) * ITEM_BYTES[dtype] + t * n * OUT_BYTES


def call_flops(shapes) -> int:
    return sum(gemm_flops(t, k, n) for t, k, n in shapes)


def call_bytes(shapes, dtype: str) -> int:
    return sum(gemm_bytes(t, k, n, dtype) for t, k, n in shapes)


def call_bound_s(shapes, dtype: str) -> float:
    """Least seconds the card needs for one fused call over ``shapes``."""
    by_ops = call_flops(shapes) / PEAK_FLOPS[dtype]
    by_bytes = call_bytes(shapes, dtype) / PEAK_BYTES_PER_S
    return max(by_ops, by_bytes)

