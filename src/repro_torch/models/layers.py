"""Neural layers of the dense decode path, in plain PyTorch.

Counterpart of the parts of ``repro.models.layers`` that the dense family's
decode step uses.  Parameters are nested dicts of tensors in the JAX
package's layout — weights ``(in, out)``, so a projection is ``x @ w`` — so
``models.convert`` carries a JAX parameter tree across unchanged.  Compute
dtype is bf16, normalisation, rotary embedding and softmax in f32, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------


def dense_init(
    gen: torch.Generator,
    in_dim: int,
    out_dim: int,
    *,
    lead: tuple[int, ...] = (),
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """``(*lead, in_dim, out_dim)`` weights ~ N(0, 1/in_dim), drawn in f32
    on the generator's device and stored as ``dtype``."""
    shape = (*lead, in_dim, out_dim)
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return w.mul_(1.0 / math.sqrt(in_dim)).to(dtype)


def embed_init(
    gen: torch.Generator, vocab: int, dim: int, dtype=torch.bfloat16
) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, device=gen.device)
    return w.to(dtype)


# ---------------------------------------------------------------------------
# norms and rotary position embedding
# ---------------------------------------------------------------------------


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


def rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
) -> torch.Tensor:
    """Apply RoPE.  x: (..., S, H, D); positions: (..., S) ints."""
    half = x.shape[-1] // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device)
        * (math.log(theta) / half)
    )
    angles = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention projections (GQA)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    window: int | None = None  # local attention window (tokens back)
    use_rope: bool = True
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    chunk: int = 512  # KV-block size of the JAX package's chunked prefill
    q_chunks: int = 1

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def init_attention(
    gen: torch.Generator, cfg: AttnConfig, lead: tuple[int, ...] = ()
) -> Params:
    p: Params = {
        "wq": dense_init(gen, cfg.d_model, cfg.q_dim, lead=lead),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, lead=lead),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, lead=lead),
        "wo": dense_init(gen, cfg.q_dim, cfg.d_model, lead=lead),
    }
    if cfg.qkv_bias:
        for name, dim in (("bq", cfg.q_dim), ("bk", cfg.kv_dim), ("bv", cfg.kv_dim)):
            p[name] = torch.zeros((*lead, dim), device=gen.device)
    return p


def _project_qkv(p: Params, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor):
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(
    gen: torch.Generator, d_model: int, d_ff: int, kind: str, lead: tuple[int, ...] = ()
) -> Params:
    """kind: 'swiglu' | 'geglu' | 'gelu' | 'relu2' (squared ReLU)."""
    if kind in ("swiglu", "geglu"):
        return {
            "gate": dense_init(gen, d_model, d_ff, lead=lead),
            "up": dense_init(gen, d_model, d_ff, lead=lead),
            "down": dense_init(gen, d_ff, d_model, lead=lead),
        }
    return {
        "up": dense_init(gen, d_model, d_ff, lead=lead),
        "down": dense_init(gen, d_ff, d_model, lead=lead),
    }


def mlp(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(x @ p["gate"]) * (x @ p["up"])
    elif kind == "geglu":
        h = F.gelu(x @ p["gate"], approximate="tanh") * (x @ p["up"])
    elif kind == "gelu":
        h = F.gelu(x @ p["up"], approximate="tanh")
    elif kind == "relu2":
        h = torch.square(F.relu(x @ p["up"]))
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return h @ p["down"]
