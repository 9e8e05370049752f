"""Gradient compression for the data-parallel all-reduce.

Counterpart of ``repro.distributed.compression``.  Two schemes, both with
**error feedback** (the compression residual is carried to the next step):

* ``int8`` — blockwise symmetric int8 quantisation.  The cross-replica
  reduction is a reduce-scatter leg (an all-to-all of int8 chunks), a
  local f32 mean, and an int8 all-gather leg;
* ``topk`` — magnitude top-k sparsification, reduced densely.

Where the JAX package names a ``shard_map`` axis, these functions take a
``torch.distributed`` process group.  ``group=None`` is one replica: every
collective over it returns its input, so the sum over replicas is the
tensor itself and the compression still rounds exactly as it would.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch._tree import tree_map
from repro_torch.distributed.collectives import all_gather, all_reduce_, all_to_all_


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"  # none | int8 | topk
    block: int = 256  # int8 quantisation block
    topk_frac: float = 0.01  # fraction of entries kept by topk


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the replicas of ``group``."""
    if group is None:
        return x
    return all_reduce_(x.clone(), group) / dist.get_world_size(group)


# ---------------------------------------------------------------------------
# int8 blockwise quantisation
# ---------------------------------------------------------------------------


def _pad_to(x: torch.Tensor, m: int) -> tuple[torch.Tensor, int]:
    n = x.numel()
    return F.pad(x.reshape(-1), (0, (-n) % m)), n


def quantize_int8(g: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """g -> (int8 codes (n_blocks, block), f32 per-block scales (n_blocks, 1))."""
    flat, _ = _pad_to(g, block)
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(
    q: torch.Tensor, scale: torch.Tensor, shape, size: int
) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)[:size]
    return flat.reshape(shape)


def int8_psum_mean(g: torch.Tensor, group=None, block: int = 256) -> torch.Tensor:
    """Mean-all-reduce of ``g`` over ``group`` with int8 on the wire: the
    reduce-scatter leg is an all-to-all of int8 chunks (each replica reduces
    1/R of the tensor), then a local f32 mean, then an int8 all-gather."""
    R = _world(group)
    flat, size = _pad_to(g, block * R)
    q, scale = quantize_int8(flat.reshape(R, -1), block)  # q: (R·nb, block)
    nb = q.shape[0] // R
    q = q.reshape(R, nb, block)
    scale = scale.reshape(R, nb, 1)
    if group is not None:  # replica r receives chunk r from everyone
        q_rs, s_rs = torch.empty_like(q), torch.empty_like(scale)
        all_to_all_(q_rs, q, group)
        all_to_all_(s_rs, scale, group)
        q, scale = q_rs, s_rs
    local = torch.mean(q.float() * scale, dim=0)  # (nb, block)
    q2, s2 = quantize_int8(local, block)
    q2 = q2.reshape(nb, block)
    if group is None:
        qg, sg = q2[None], s2[None]
    else:
        qg, sg = all_gather(q2, 0, group), all_gather(s2, 0, group)
    out = (qg.float() * sg).reshape(-1)[:size]
    return out.reshape(g.shape)


# ---------------------------------------------------------------------------
# top-k sparsification
# ---------------------------------------------------------------------------


def _topk_dense(flat: torch.Tensor, k: int) -> torch.Tensor:
    """``flat`` with all but its ``k`` largest magnitudes zeroed; equal
    magnitudes are taken in index order, as ``jax.lax.top_k`` takes them."""
    idx = torch.sort(flat.abs(), descending=True, stable=True)[1][:k]
    return torch.zeros_like(flat).index_put((idx,), flat[idx])


def topk_psum_mean(g: torch.Tensor, group=None, frac: float = 0.01) -> torch.Tensor:
    """Mean-all-reduce keeping only each replica's top-k |g| entries."""
    flat = g.reshape(-1)
    dense = _topk_dense(flat, max(1, int(flat.numel() * frac)))
    # the dense all-reduce stands in for an index-union collective; the
    # wire bytes of a real deployment are 2k words (indices + values)
    return pmean(dense, group).reshape(g.shape)


# ---------------------------------------------------------------------------
# error-feedback wrapper
# ---------------------------------------------------------------------------


def init_error_state(grads: Any) -> Any:
    return tree_map(torch.zeros_like, grads)


def compressed_mean(
    grads: Any, err: Any, group, cfg: CompressionConfig
) -> tuple[Any, Any]:
    """(grads + err) --compress--> mean over ``group``; returns
    (mean, new_err), new_err being what compression destroyed locally."""
    if cfg.kind == "none":
        return tree_map(lambda g: pmean(g, group), grads), err

    def leaf(g, e):
        corrected = g + e
        if cfg.kind == "int8":
            q, s = quantize_int8(corrected, cfg.block)
            local_hat = dequantize_int8(q, s, corrected.shape, corrected.numel())
            reduced = int8_psum_mean(corrected, group, cfg.block)
        elif cfg.kind == "topk":
            flat = corrected.reshape(-1)
            k = max(1, int(flat.numel() * cfg.topk_frac))
            local_hat = _topk_dense(flat, k).reshape(corrected.shape)
            reduced = topk_psum_mean(corrected, group, cfg.topk_frac)
        else:
            raise ValueError(cfg.kind)
        return reduced, corrected - local_hat

    pairs = tree_map(leaf, grads, err)
    if not isinstance(grads, dict):
        return pairs
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)
