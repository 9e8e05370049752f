"""Neural layers of the decode paths, in plain PyTorch.

Counterpart of the parts of ``repro.models.layers`` that the five model
families' decode steps use.  Parameters are nested dicts of tensors in the
JAX package's layout — weights ``(in, out)``, so a projection is ``x @ w`` —
so ``models.convert`` carries a JAX parameter tree across unchanged.
Compute dtype is bf16, normalisation, rotary embedding and softmax in f32,
as in the JAX package.

Initialisers take ``gen``: a ``torch.Generator`` (the tensors are drawn on
its device), or the meta device, which gives every shape and dtype and
allocates nothing (``param_count``, ``configs.params_spec``).  ``lead`` is
the stacked leading axes (layers, experts).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]

# f32 elements drawn at once: a stacked weight is drawn a block of rows at a
# time, so the f32 temporary stays at 256 MiB whatever its leading axes
_DRAW_ELEMS = 1 << 26


# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------


def _init_device(gen) -> torch.device:
    """The device an initialiser's ``gen`` draws on."""
    return gen.device if isinstance(gen, torch.Generator) else torch.device(gen)


def normal(gen, shape: tuple[int, ...], scale: float = 1.0, dtype=torch.bfloat16):
    """``shape`` ~ N(0, scale²), drawn in f32 and stored as ``dtype``."""
    dev = _init_device(gen)
    out = torch.empty(shape, dtype=dtype, device=dev)
    if dev.type == "meta":
        return out
    rows = out.view(-1, shape[-1])
    step = max(1, _DRAW_ELEMS // shape[-1])
    for r in range(0, rows.shape[0], step):
        blk = rows[r : r + step]
        draw = torch.randn(blk.shape, generator=gen, device=dev, dtype=torch.float32)
        blk.copy_(draw.mul_(scale))
    return out


def uniform(gen, shape: tuple[int, ...], low: float, high: float) -> torch.Tensor:
    """``shape`` ~ U[low, high) in f32."""
    dev = _init_device(gen)
    if dev.type == "meta":
        return torch.empty(shape, device=dev)
    u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
    return u.mul_(high - low).add_(low)


def full(gen, shape: tuple[int, ...], value: float) -> torch.Tensor:
    """An f32 constant of ``shape`` (norm scales, biases)."""
    return torch.full(shape, value, dtype=torch.float32, device=_init_device(gen))


def dense_init(
    gen,
    in_dim: int,
    out_dim: int,
    *,
    lead: tuple[int, ...] = (),
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """``(*lead, in_dim, out_dim)`` weights ~ N(0, 1/in_dim), drawn in f32
    on the generator's device and stored as ``dtype``."""
    return normal(gen, (*lead, in_dim, out_dim), 1.0 / math.sqrt(in_dim), dtype)


def embed_init(gen, vocab: int, dim: int, dtype=torch.bfloat16) -> torch.Tensor:
    return normal(gen, (vocab, dim), 1.0, dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_rmsnorm(gen, dim: int, lead: tuple[int, ...] = ()) -> Params:
    return {"scale": full(gen, (*lead, dim), 1.0)}


def init_layernorm(gen, dim: int, lead: tuple[int, ...] = ()) -> Params:
    return {"scale": full(gen, (*lead, dim), 1.0), "bias": full(gen, (*lead, dim), 0.0)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


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


def init_attention(gen, cfg: AttnConfig, lead: tuple[int, ...] = ()) -> Params:
    p: Params = {
        "wq": dense_init(gen, cfg.d_model, cfg.q_dim, lead=lead),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, lead=lead),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, lead=lead),
        "wo": dense_init(gen, cfg.q_dim, cfg.d_model, lead=lead),
    }
    if cfg.qkv_bias:
        for name, dim in (("bq", cfg.q_dim), ("bk", cfg.kv_dim), ("bv", cfg.kv_dim)):
            p[name] = full(gen, (*lead, dim), 0.0)
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
    gen, d_model: int, d_ff: int, kind: str, lead: tuple[int, ...] = ()
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


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x · sigmoid(x)`` as the JAX package evaluates ``jax.nn.silu``: the
    sigmoid as ``1 / (1 + exp(-x))``, each step rounded to ``x``'s dtype
    (``F.silu`` rounds once, from f32, and so differs by an ulp of bf16 on
    about a third of the values)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return x * (one / (one + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of GELU as ``jax.nn.gelu`` evaluates it: its constants
    take ``x``'s dtype and each step rounds to it, so on bf16 this is the
    JAX package's gelu bit for bit (``F.gelu(approximate="tanh")`` keeps
    the constants and the steps in f32, and rounds once)."""
    c1 = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    c2 = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c2 * (x + c1 * x**3))))


def mlp(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = silu(x @ p["gate"]) * (x @ p["up"])
    elif kind == "geglu":
        h = gelu(x @ p["gate"]) * (x @ p["up"])
    elif kind == "gelu":
        h = gelu(x @ p["up"])
    elif kind == "relu2":
        h = torch.square(F.relu(x @ p["up"]))
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return h @ p["down"]


# ---------------------------------------------------------------------------
# conv1d (short causal depthwise conv — Mamba/RecurrentGemma temporal mix)
# ---------------------------------------------------------------------------


def init_conv1d(gen, dim: int, width: int, lead: tuple[int, ...] = ()) -> Params:
    return {
        "w": normal(gen, (*lead, width, dim), 1.0 / math.sqrt(width)),
        "b": full(gen, (*lead, dim), 0.0),
    }


def causal_conv1d(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time.  x: (B, S, dim)."""
    width = p["w"].shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = sum(
        pad[:, i : i + x.shape[1], :] * p["w"][i].to(x.dtype) for i in range(width)
    )
    return out + p["b"].to(x.dtype)


def conv1d_step(p: Params, window: torch.Tensor, x_t: torch.Tensor):
    """Single decode step.  window: (B, width-1, dim) history; x_t: (B, dim).

    Returns (y_t, new_window)."""
    full_win = torch.cat([window, x_t[:, None, :]], dim=1)  # (B, width, d)
    y = torch.einsum("bwd,wd->bd", full_win.float(), p["w"].float())
    y = (y + p["b"]).to(x_t.dtype)
    return y, full_win[:, 1:, :]
