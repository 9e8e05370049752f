"""RG-LRU recurrent block (RecurrentGemma / Griffin), in plain PyTorch.

Counterpart of ``repro.models.rglru``.  The recurrence, per channel:

    r_t = sigmoid(W_a x_t + b_a)            # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            # input gate
    a_t = exp(-c · softplus(Λ) · r_t)       # c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Over a sequence it runs as a plain loop over time in f32 (the JAX package
runs an associative scan: the same recurrence, summed in another order);
decode is one step.  The block: conv1d → RG-LRU, gated by a GELU branch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    causal_conv1d,
    conv1d_step,
    dense_init,
    full,
    gelu,
    init_conv1d,
    uniform,
)

Params = dict[str, Any]
_C = 8.0


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    lru_width: int
    conv_width: int = 4


def init_rglru(gen, cfg: RGLRUConfig, lead: tuple[int, ...] = ()) -> Params:
    w = cfg.lru_width
    # Λ init so that a^c in [0.9, 0.999] (Griffin appendix)
    u = uniform(gen, (*lead, w), 0.9**2, 0.999**2)
    lam = torch.log(torch.expm1(-torch.log(u) / (2.0 * _C)))
    return {
        "in_x": dense_init(gen, cfg.d_model, w, lead=lead),  # conv/LRU branch
        "in_gate": dense_init(gen, cfg.d_model, w, lead=lead),  # its gate
        "conv": init_conv1d(gen, w, cfg.conv_width, lead=lead),
        "wa": dense_init(gen, w, w, lead=lead),
        "wx": dense_init(gen, w, w, lead=lead),
        "ba": full(gen, (*lead, w), 0.0),
        "bx": full(gen, (*lead, w), 0.0),
        "lambda": lam,
        "out": dense_init(gen, w, cfg.d_model, lead=lead),
    }


def _gates(p: Params, x: torch.Tensor):
    """Returns (a, beta·i·x) for the linear recurrence, in f32."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["wa"].float() + p["ba"])
    i = torch.sigmoid(xf @ p["wx"].float() + p["bx"])
    log_a = -_C * F.softplus(p["lambda"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * i * xf


def rglru_forward(p: Params, cfg: RGLRUConfig, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence RG-LRU block.  u: (B, S, d_model)."""
    x = u @ p["in_x"]
    gate = gelu(u @ p["in_gate"])
    a, b = _gates(p, causal_conv1d(p["conv"], x))  # (B, S, w) each, f32
    h = torch.empty_like(b)
    state = torch.zeros_like(b[:, 0])
    for t in range(u.shape[1]):
        state = a[:, t] * state + b[:, t]
        h[:, t] = state
    return (h.to(u.dtype) * gate) @ p["out"]


def rglru_init_cache(
    cfg: RGLRUConfig, batch: int, dtype=torch.bfloat16, *, device="cuda"
) -> Params:
    """The decode cache: an f32 state and a conv window of ``dtype``."""
    w = cfg.lru_width
    return {
        "state": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype, device=device),
    }


def rglru_step(p: Params, cfg: RGLRUConfig, cache: Params, u_t: torch.Tensor):
    """Single decode step.  u_t: (B, d_model) -> (y_t, new_cache)."""
    x = u_t @ p["in_x"]
    gate = gelu(u_t @ p["in_gate"])
    x, conv_win = conv1d_step(p["conv"], cache["conv"], x)
    a, b = _gates(p, x)
    h = a * cache["state"] + b
    y = h.to(u_t.dtype) * gate
    return y @ p["out"], {"state": h, "conv": conv_win}
