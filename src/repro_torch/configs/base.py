"""Architecture registry plumbing (the port's copy of ``repro.configs.base``).

Every architecture file defines a ``SPEC: ArchSpec`` with ``model`` (the
exact published configuration), ``smoke`` (a reduced same-family
configuration for CPU tests) and ``skip_shapes`` (cells that do not apply,
with reasons).  ``input_specs`` and ``params_spec`` give every input and
parameter of a (cell × config) pair as tensors on the meta device: shapes
and dtypes, nothing allocated (the JAX package's ``ShapeDtypeStruct``s).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.model import ModelConfig, init_cache, init_params


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned input-shape cell (seq_len × global_batch × step kind)."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


STANDARD_SHAPES: tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    model: ModelConfig
    smoke: ModelConfig
    skip_shapes: tuple[str, ...] = ()
    skip_reasons: tuple[tuple[str, str], ...] = ()

    def shapes(self) -> list[ShapeCell]:
        return [s for s in STANDARD_SHAPES if s.name not in self.skip_shapes]

    def cell(self, name: str) -> ShapeCell:
        for s in STANDARD_SHAPES:
            if s.name == name:
                if name in self.skip_shapes:
                    reasons = dict(self.skip_reasons)
                    raise ValueError(
                        f"{self.arch_id} skips {name}: "
                        f"{reasons.get(name, 'inapplicable')}"
                    )
                return s
        raise KeyError(name)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(
    cfg: ModelConfig, cell: ShapeCell, batch: int | None = None, seq: int | None = None
) -> dict[str, Any]:
    """Meta-device stand-ins for every input of the cell's step.

    train  -> {tokens, labels [, frames | patches]}
    prefill-> {tokens [, frames | patches]}
    decode -> {token, cache, cache_len}  (cache of seq_len entries)
    """
    B = batch if batch is not None else cell.global_batch
    S = seq if seq is not None else cell.seq_len
    out: dict[str, Any] = {}
    if cell.kind in ("train", "prefill"):
        S_tok = S
        if cfg.frontend == "vision":
            # "seq_len" counts the backbone sequence: patches + text tokens.
            S_tok = max(S - cfg.n_patches, 1)
            out["patches"] = _spec((B, cfg.n_patches, cfg.d_model), torch.bfloat16)
        elif cfg.frontend == "audio":
            out["frames"] = _spec((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
        out["tokens"] = _spec((B, S_tok), torch.int32)
        if cell.kind == "train":
            out["labels"] = _spec((B, S_tok), torch.int32)
        return out
    if cell.kind == "decode":
        out["token"] = _spec((B, 1), torch.int32)
        out["cache_len"] = _spec((B,), torch.int32)
        out["cache"] = init_cache(cfg, B, S, device="meta")
        return out
    raise ValueError(cell.kind)


def params_spec(cfg: ModelConfig) -> Any:
    """The model parameters on the meta device (no allocation)."""
    return init_params(cfg, device="meta")
