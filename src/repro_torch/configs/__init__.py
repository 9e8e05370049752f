"""Registry of the 10 assigned architectures (``get(arch_id)``)."""

from __future__ import annotations

from repro_torch.configs import (
    dbrx_132b,
    deepseek_coder_33b,
    internvl2_26b,
    llama32_3b,
    mamba2_780m,
    mistral_nemo_12b,
    nemotron4_15b,
    phi35_moe,
    recurrentgemma_2b,
    whisper_small,
)
from repro_torch.configs.base import (
    STANDARD_SHAPES,
    ArchSpec,
    ShapeCell,
    input_specs,
    params_spec,
)

_ALL = (
    whisper_small.SPEC,
    internvl2_26b.SPEC,
    dbrx_132b.SPEC,
    phi35_moe.SPEC,
    deepseek_coder_33b.SPEC,
    llama32_3b.SPEC,
    nemotron4_15b.SPEC,
    mistral_nemo_12b.SPEC,
    mamba2_780m.SPEC,
    recurrentgemma_2b.SPEC,
)

ARCHS: dict[str, ArchSpec] = {s.arch_id: s for s in _ALL}

# Per-arch tuned profiles of the JAX package's multi-pod dry run (mesh shape,
# Q-chunks, attention chunk, microbatches), kept so the registries agree.
TUNED_PROFILES: dict[str, dict] = {
    "deepseek-coder-33b": {"mesh": (32, 8)},
    "llama3.2-3b": {"mesh": (32, 8)},
    "whisper-small": {"mesh": (32, 8)},
    # q-heads divide 16 → keep default mesh; Q-chunking only:
    "dbrx-132b": {"mesh": (16, 16)},
    "phi3.5-moe-42b-a6.6b": {"mesh": (16, 16)},
    "internvl2-26b": {"mesh": (16, 16)},
    "mistral-nemo-12b": {"mesh": (16, 16)},
    "nemotron-4-15b": {"mesh": (16, 16)},
    "mamba2-780m": {"mesh": (16, 16)},
    "recurrentgemma-2b": {"mesh": (16, 16)},
}
for _p in TUNED_PROFILES.values():
    _p.setdefault("q_chunks", 4)
    _p.setdefault("attn_chunk", 1024)
    _p.setdefault("microbatches", 32)


def get(arch_id: str) -> ArchSpec:
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}") from None


def list_archs() -> list[str]:
    return list(ARCHS)


__all__ = [
    "ARCHS",
    "ArchSpec",
    "ShapeCell",
    "STANDARD_SHAPES",
    "get",
    "list_archs",
    "input_specs",
    "params_spec",
]
