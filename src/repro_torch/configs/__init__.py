"""Registry of the ported architectures (``get(arch_id)``).

Only llama3.2-3b is ported; the JAX package's other nine configurations wait
for their model families (ROADMAP.md, "Modules to port").
"""

from __future__ import annotations

from repro_torch.configs import llama32_3b
from repro_torch.configs.base import STANDARD_SHAPES, ArchSpec, ShapeCell

ARCHS: dict[str, ArchSpec] = {s.arch_id: s for s in (llama32_3b.SPEC,)}


def get(arch_id: str) -> ArchSpec:
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}") from None


def list_archs() -> list[str]:
    return list(ARCHS)


__all__ = ["ARCHS", "ArchSpec", "ShapeCell", "STANDARD_SHAPES", "get", "list_archs"]
