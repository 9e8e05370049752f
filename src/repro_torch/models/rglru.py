"""RG-LRU recurrent block (RecurrentGemma / Griffin), in plain PyTorch.

Counterpart of ``repro.models.rglru``.  The recurrence, per channel:

    r_t = sigmoid(W_a x_t + b_a)            # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            # input gate
    a_t = exp(-c · softplus(Λ) · r_t)       # c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Over a sequence it runs as a scan in log2(S) doubling steps in f32, as
the JAX package's associative scan runs in log depth (the same recurrence;
the two trees of products round in a different order); decode is one
step.  The block: conv1d → RG-LRU, gated by a GELU branch.

Tensor parallelism: where the params dict is a
``distributed.sharding.SplitParams``, this rank holds its slice of the
``lru`` channels along "model": ``in_x`` and ``in_gate`` by column, the
per-channel conv, ``lambda``, ``ba`` and ``bx``, and the rows of ``wa``,
``wx`` and ``out``.  A product over ``wa``'s or ``wx``'s rows is a partial
sum over every channel, reduce-scattered to the rank's own
(``scatter_from_model``); ``out``'s is summed by ``reduce_from_model``.
The decode cache keeps every channel (its spec leaves ``lru`` whole), so
a decode step all-gathers the rank's new state and conv input, B × lru
each, rather than gathering the block's lru² weights a token.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
    scatter_from_model,
)
from repro_torch.models.layers import (
    causal_conv1d,
    conv1d_step,
    dense_init,
    full,
    gelu,
    init_conv1d,
    leaf,
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
    lam = leaf(torch.log(torch.expm1(-torch.log(u) / (2.0 * _C))))
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


def _gates(p: Params, x: torch.Tensor, tp=None):
    """Returns (a, beta·i·x) for the linear recurrence, in f32; ``x`` this
    rank's channels where ``tp`` is given."""
    xf = x.float()
    if tp is None:
        r = torch.sigmoid(xf @ p["wa"].float() + p["ba"])
        i = torch.sigmoid(xf @ p["wx"].float() + p["bx"])
    else:  # both partial products in one reduce-scatter to this rank's channels
        parts = torch.stack([xf @ p["wa"].float(), xf @ p["wx"].float()])
        pa, px = scatter_from_model(parts, -1, tp).unbind(0)
        r = torch.sigmoid(pa + p["ba"])
        i = torch.sigmoid(px + p["bx"])
    log_a = -_C * F.softplus(p["lambda"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * i * xf


def rglru_forward(p: Params, cfg: RGLRUConfig, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence RG-LRU block.  u: (B, S, d_model)."""
    tp = getattr(p, "tp", None)
    if tp is not None:
        u = copy_to_model(u, tp)
    x = u @ p["in_x"]
    gate = gelu(u @ p["in_gate"])
    a, b = _gates(p, causal_conv1d(p["conv"], x), tp)  # (B, S, w) each, f32
    out = (_linear_scan(a, b).to(u.dtype) * gate) @ p["out"]
    return out if tp is None else reduce_from_model(out, tp)


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t·h_{t-1} + b_t`` along axis 1 from ``h_{-1} = 0``.

    Each doubling step composes every element with the one ``off`` before
    it, so after it element ``t`` holds the recurrence over its last
    ``2·off`` inputs: log2(S) steps of a few whole-tensor ops each, where a
    loop over time launches S steps of tiny ones."""
    S, off = a.shape[1], 1
    while off < S:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1)
        if 2 * off < S:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


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
    tp = getattr(p, "tp", None)
    w = p["in_x"].shape[-1]
    mine = slice(None) if tp is None else slice(tp.rank * w, (tp.rank + 1) * w)
    x_t = u_t @ p["in_x"]
    gate = gelu(u_t @ p["in_gate"])
    x, conv_win = conv1d_step(p["conv"], cache["conv"][..., mine], x_t)
    a, b = _gates(p, x, tp)
    h = a * cache["state"][:, mine] + b
    y = (h.to(u_t.dtype) * gate) @ p["out"]
    if tp is None:
        return y, {"state": h, "conv": conv_win}
    # every channel's new state and conv input, for the whole cache
    new = gather_from_model(torch.stack([h, x_t.float()]), -1, tp)
    win = torch.cat([cache["conv"][:, 1:], new[1][:, None].to(x_t.dtype)], dim=1)
    return reduce_from_model(y, tp), {"state": new[0], "conv": win}
