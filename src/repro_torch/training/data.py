"""Deterministic synthetic LM data pipeline.

Counterpart of ``repro.training.data``.  Every batch is a pure function of
(seed, step) — restart-safe: resuming from a checkpoint at step k
regenerates exactly the batches k, k+1, … with no data-order state to
persist.  The tokens are drawn with NumPy exactly as the JAX package draws
them (a Zipf body overwritten by a repeating n-gram per sequence), so both
packages see the same tokens and labels.

The stub frontend inputs (``frames``, ``patches``) are N(0, 0.02²)
pseudo-embeddings in bf16, drawn on the CPU from a ``torch.Generator``
seeded from (seed, step, name) with a stable hash of the name, so a batch
is the same on every device and in every process.  (The JAX package folds
in Python's ``hash(name)``, which is salted per process.)
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.distributed.sharding import batch_shardings, place
from repro_torch.launch.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    zipf_a: float = 1.2
    ngram: int = 8  # length of the learnable repeating pattern


def _host_batch(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(np.uint64(cfg.seed * 1_000_003 + step))
    # zipf body (clipped to vocab), then overwrite a periodic n-gram
    z = rng.zipf(cfg.zipf_a, size=(cfg.batch, cfg.seq + 1)) - 1
    toks = np.minimum(z, cfg.vocab - 1).astype(np.int32)
    grams = rng.integers(0, cfg.vocab, size=(cfg.batch, cfg.ngram), dtype=np.int32)
    reps = -(-(cfg.seq + 1) // cfg.ngram)
    pattern = np.tile(grams, (1, reps))[:, : cfg.seq + 1]
    mask = rng.random((cfg.batch, cfg.seq + 1)) < 0.75
    toks = np.where(mask, pattern, toks)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _extra_seed(seed: int, step: int, name: str) -> int:
    digest = hashlib.sha256(f"{seed}/{step}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_batch(
    cfg: DataConfig,
    step: int,
    mesh: Mesh | None = None,
    extras: dict[str, Any] | None = None,
    *,
    device="cuda",
) -> dict[str, torch.Tensor]:
    """Batch for ``step``: {tokens, labels} (int32) and the stub frontend
    inputs named in ``extras`` ({name: shape}), placed on ``mesh`` by
    ``batch_shardings``, or else on ``device``.  On a mesh that a process
    group backs, every rank draws the same global batch and keeps its
    shard (DTensors): the shards joined are the one-device batch."""
    dev = resolve_device(device) if mesh is None else None
    host = _host_batch(cfg, step)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()}
    for name, shape in (extras or {}).items():
        gen = torch.Generator().manual_seed(_extra_seed(cfg.seed, step, name))
        draw = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
        batch[name] = (draw * 0.02).to(torch.bfloat16)
    if mesh is not None:
        return place(batch, batch_shardings(batch, mesh))
    return {k: v.to(dev) for k, v in batch.items()}


def batch_iterator(
    cfg: DataConfig,
    mesh: Mesh | None = None,
    start_step: int = 0,
    extras: dict[str, Any] | None = None,
    *,
    device="cuda",
):
    step = start_step
    while True:
        yield step, make_batch(cfg, step, mesh, extras, device=device)
        step += 1
