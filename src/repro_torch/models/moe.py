"""Token-choice top-k Mixture-of-Experts (DBRX 16e/top-4, Phi-3.5-MoE 16e/top-2).

Counterpart of ``repro.models.moe``.  Dispatch is capacity-based and
sort-based (no (T × E × C) one-hot tensor):

1. router logits (f32) → top-k (expert, gate) per token, ties to the lower
   expert id as ``jax.lax.top_k`` breaks them;
2. flatten the T·k assignments and rank each within its expert by a stable
   sort over expert ids; ranks past the capacity
   ``C = ceil(T·k/E · capacity_factor)`` are dropped;
3. scatter token activations into an (E, C, d) buffer, run the expert FFNs
   as one batched einsum, gather back and combine weighted by the gates.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models.layers import dense_init, gelu, normal, silu

Params = dict[str, Any]


def init_moe(
    gen,
    d_model: int,
    d_ff: int,
    n_experts: int,
    kind: str = "swiglu",
    lead: tuple[int, ...] = (),
) -> Params:
    # every expert tensor, the down projection included, is N(0, 1/d_model)
    scale = 1.0 / math.sqrt(d_model)

    def ew(a: int, b: int) -> torch.Tensor:
        return normal(gen, (*lead, n_experts, a, b), scale)

    p: Params = {
        "router": dense_init(gen, d_model, n_experts, lead=lead, dtype=torch.float32),
        "down": ew(d_ff, d_model),
    }
    if kind in ("swiglu", "geglu"):
        p["gate"] = ew(d_model, d_ff)
        p["up"] = ew(d_model, d_ff)
    else:
        p["up"] = ew(d_model, d_ff)
    return p


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last axis, equal values in index order."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def moe_ffn(
    p: Params,
    x: torch.Tensor,
    top_k: int,
    kind: str = "swiglu",
    capacity_factor: float = 1.25,
) -> torch.Tensor:
    """Apply the MoE FFN.  x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    E = p["router"].shape[1]
    T = B * S
    xt = x.reshape(T, d)
    dev = x.device

    logits = xt.float() @ p["router"]  # (T, E)
    gate_vals, expert_ids = _top_k(torch.softmax(logits, dim=-1), top_k)
    # renormalise the selected gates (standard for token-choice routing)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    A = T * top_k
    cap = int(math.ceil(T * top_k / E * capacity_factor))
    flat_expert = expert_ids.reshape(A)
    flat_gate = gate_vals.reshape(A)
    flat_token = torch.arange(T, device=dev).repeat_interleave(top_k)

    # rank of each assignment within its expert (stable by token order)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    seg_start = torch.searchsorted(sorted_expert, torch.arange(E, device=dev))
    pos_sorted = torch.arange(A, device=dev) - seg_start[sorted_expert]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)

    keep = pos < cap
    safe_pos = torch.where(keep, pos, 0)
    # scatter tokens into (E, C, d); dropped assignments add nothing
    buf = torch.zeros((E, cap, d), dtype=x.dtype, device=dev)
    rows = torch.where(keep[:, None], xt[flat_token], 0).to(x.dtype)
    buf.index_put_((flat_expert, safe_pos), rows, accumulate=True)

    # batched expert FFN: (E, C, d) x (E, d, f) -> (E, C, f)
    if "gate" in p:
        h_g = torch.einsum("ecd,edf->ecf", buf, p["gate"])
        h_u = torch.einsum("ecd,edf->ecf", buf, p["up"])
        act = silu(h_g) if kind == "swiglu" else gelu(h_g)
        h = act * h_u
    else:
        h = gelu(torch.einsum("ecd,edf->ecf", buf, p["up"]))
    out_buf = torch.einsum("ecf,efd->ecd", h, p["down"])  # (E, C, d)

    # gather back and combine
    picked = torch.where(keep[:, None], out_buf[flat_expert, safe_pos], 0)
    weighted = picked * flat_gate[:, None].to(picked.dtype)
    out = torch.zeros((T, d), dtype=x.dtype, device=dev)
    out.index_add_(0, flat_token, weighted.to(x.dtype))
    return out.reshape(B, S, d)


def aux_load_balance_loss(p: Params, x: torch.Tensor, top_k: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (mean fraction · prob)."""
    d = x.shape[-1]
    E = p["router"].shape[1]
    logits = x.reshape(-1, d).float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    _, ids = _top_k(probs, top_k)
    counts = torch.zeros(E, device=x.device).index_add_(
        0, ids.reshape(-1), torch.ones(ids.numel(), device=x.device)
    )
    frac = counts / counts.sum()
    return E * torch.sum(frac * probs.mean(dim=0))
