"""Architecture registry plumbing (the port's copy of ``repro.configs.base``).

Every architecture file defines a ``SPEC: ArchSpec`` with ``model`` (the
exact published configuration), ``smoke`` (a reduced same-family
configuration for CPU tests) and ``skip_shapes`` (cells that do not apply,
with reasons).  ``input_specs`` and ``params_spec`` are not ported yet.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.model import ModelConfig


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
