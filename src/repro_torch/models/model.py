"""Model assembly for the dense (llama-style) family, in plain PyTorch.

Counterpart of ``repro.models.model`` for the dense family's decode path:
``ModelConfig``, ``init_params``, ``init_cache`` and ``decode_step``.  The
parameter tree has the JAX package's layout — per-layer parameters stacked
on a leading layer axis under ``"blocks"``, weights ``(in, out)`` — and the
JAX ``lax.scan`` over that axis is a Python loop here.

The moe, ssm, hybrid and encdec families and the full-sequence paths
(``forward``, ``prefill``, ``loss_fn``) are not ported yet; asking for them
raises ``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch._device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import AttnConfig

Params = dict[str, Any]

_NOT_PORTED = (
    "is not ported yet: ROADMAP.md, 'Modules to port', item 4 "
    "(model families moe, ssm, hybrid, encdec)"
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    mlp_kind: str = "swiglu"
    norm: str = "rms"  # rms | ln
    use_rope: bool = True
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    attn_chunk: int = 512
    attn_q_chunks: int = 1
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # ssm
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    # hybrid
    window: int = 2048
    lru_width: int = 0
    pattern: tuple[str, ...] = ()
    # encdec
    n_enc_layers: int = 0
    enc_seq: int = 1500
    max_dec_seq: int = 8192
    # frontend stub
    frontend: str = "none"  # none | audio | vision
    n_patches: int = 256
    # training
    remat: bool = True

    @property
    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim,
            causal=True,
            window=None,
            use_rope=self.use_rope,
            rope_theta=self.rope_theta,
            qkv_bias=self.qkv_bias,
            chunk=self.attn_chunk,
            q_chunks=self.attn_q_chunks,
        )

    def param_count(self) -> int:
        """Exact parameter count, from the shapes ``init_params`` makes."""
        _check_ported(self)
        a = self.attn_cfg
        attn = 2 * self.d_model * a.q_dim + 2 * self.d_model * a.kv_dim
        if a.qkv_bias:
            attn += a.q_dim + 2 * a.kv_dim
        n_mats = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        block = 2 * self.d_model + attn + n_mats * self.d_model * self.d_ff
        return 2 * self.vocab * self.d_model + self.d_model + self.n_layers * block


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} {_NOT_PORTED}")
    if cfg.norm != "rms" or cfg.frontend != "none":
        raise NotImplementedError(
            f"norm {cfg.norm!r} / frontend {cfg.frontend!r} {_NOT_PORTED}"
        )


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a tree stacked on a leading layer axis (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> Params:
    """Random parameters drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed`` (not the JAX package's numbers: carry those across
    with ``models.convert.params_from_jax``)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, d = cfg.n_layers, cfg.d_model
    return {
        "embed": L.embed_init(gen, cfg.vocab, d),
        "final_norm": {"scale": torch.ones((d,), device=dev)},
        "lm_head": L.dense_init(gen, d, cfg.vocab),
        "blocks": {
            "attn_norm": {"scale": torch.ones((n, d), device=dev)},
            "attn": L.init_attention(gen, cfg.attn_cfg, lead=(n,)),
            "mlp_norm": {"scale": torch.ones((n, d), device=dev)},
            "mlp": L.init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, lead=(n,)),
        },
    }


def init_cache(
    cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, *, device="cuda"
) -> Params:
    """Decode cache for a (batch, max_seq) serving session:
    k/v of shape (n_layers, batch, max_seq, n_kv_heads, head_dim)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
    }


# ---------------------------------------------------------------------------
# decode (single-token serve step against the cache)
# ---------------------------------------------------------------------------


def _decode_attn(
    p: Params,
    cfg_a: AttnConfig,
    x: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    live: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention of one new token per row against its cache.

    Cache: (B, S, KV, D).  The new k/v are written in place at row ``b``'s
    position ``cache_len[b]`` — only for rows where ``live`` is true when it
    is given (the JAX package writes every row into a new cache and keeps
    the live rows by a masked merge; writing the live rows in place is the
    same result without copying the cache).
    """
    B = x.shape[0]
    S = k_cache.shape[1]
    q, k, v = L._project_qkv(p, cfg_a, x, cache_len[:, None])
    rows = torch.arange(B, device=x.device)
    slot = cache_len.long()
    for cache, new in ((k_cache, k), (v_cache, v)):
        new = new[:, 0].to(cache.dtype)
        if live is not None:
            new = torch.where(live[:, None, None], new, cache[rows, slot])
        cache[rows, slot] = new
    # the dense family attends causally over the whole cache (the local
    # window and its ring-buffer cache belong to the hybrid family)
    kv_pos = torch.arange(S, device=x.device)[None, :]
    mask = (kv_pos <= cache_len[:, None])[:, None, None, :]
    rep = cfg_a.n_heads // cfg_a.n_kv_heads
    scale = 1.0 / math.sqrt(cfg_a.head_dim)
    qg = q[:, 0].float().reshape(B, cfg_a.n_kv_heads, rep, cfg_a.head_dim) * scale
    s = torch.einsum("bkrd,bskd->bkrs", qg, k_cache.float())  # (B, KV, rep, S)
    s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrs,bskd->bkrd", w, v_cache.float())
    out = out.reshape(B, 1, cfg_a.q_dim).to(x.dtype)
    return out @ p["wo"]


def decode_step(
    cfg: ModelConfig,
    params: Params,
    cache: Params,
    token: torch.Tensor,
    cache_len: torch.Tensor,
    live: torch.Tensor | None = None,
):
    """One serving step: (B, 1) token ids -> (B, 1, vocab) logits.

    ``cache_len``: (B,) ints — current sequence length per batch row.  The
    cache is updated in place (rows where ``live`` is true, or every row)
    and returned, so ``logits, cache = decode_step(...)`` reads as in the
    JAX package.
    """
    _check_ported(cfg)
    x = params["embed"][token].to(torch.bfloat16)  # (B, 1, d)
    for i in range(cfg.n_layers):
        bp = _layer(params["blocks"], i)
        z = L.rmsnorm(bp["attn_norm"], x)
        kc, vc = cache["k"][i], cache["v"][i]
        x = x + _decode_attn(bp["attn"], cfg.attn_cfg, z, kc, vc, cache_len, live)
        x = x + L.mlp(bp["mlp"], L.rmsnorm(bp["mlp_norm"], x), cfg.mlp_kind)
    x = L.rmsnorm(params["final_norm"], x)
    return x @ params["lm_head"], cache
