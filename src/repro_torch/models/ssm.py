"""Mamba-2 (SSD — state-space duality) block, chunked, in plain PyTorch.

Counterpart of ``repro.models.ssm``: the selective SSM
h_t = exp(A·dt_t)·h_{t-1} + dt_t·B_t·x_t ;  y_t = C_t·h_t + D·x_t,
computed chunk-parallel over a sequence (a masked (Q × Q) decay kernel
inside each chunk, the chunks' final states carried by a loop over chunks)
and one step at a time in decode, which carries a (B, H, P, N) f32 state and
a conv window.  d_inner = expand · d_model in heads of ``head_dim`` (P);
B/C of state size N are shared across heads (n_groups = 1).
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
    init_conv1d,
    silu,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128  # N
    head_dim: int = 64  # P
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256  # Q

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim


def init_ssd(gen, cfg: SSMConfig, lead: tuple[int, ...] = ()) -> Params:
    d_in, H = cfg.d_inner, cfg.n_heads
    # fused input projection: [z (gate), x, B, C, dt]
    proj_out = 2 * d_in + 2 * cfg.d_state + H
    return {
        "in_proj": dense_init(gen, cfg.d_model, proj_out, lead=lead),
        "conv": init_conv1d(gen, d_in + 2 * cfg.d_state, cfg.conv_width, lead=lead),
        "A_log": full(gen, (*lead, H), 0.0),  # A = -exp(A_log)
        "D": full(gen, (*lead, H), 1.0),
        "dt_bias": full(gen, (*lead, H), 0.0),
        "out_proj": dense_init(gen, d_in, cfg.d_model, lead=lead),
    }


def _split_proj(cfg: SSMConfig, zxbcdt: torch.Tensor):
    d_in, N = cfg.d_inner, cfg.d_state
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in : 2 * d_in + 2 * N]
    dt = zxbcdt[..., 2 * d_in + 2 * N :]
    return z, xBC, dt


def ssd_forward(p: Params, cfg: SSMConfig, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD.  u: (B, S, d_model) -> (B, S, d_model)."""
    Bsz, S, _ = u.shape
    H, P, N, Q = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.chunk
    z, xBC, dt = _split_proj(cfg, u @ p["in_proj"])
    xBC = silu(causal_conv1d(p["conv"], xBC))
    x = xBC[..., : cfg.d_inner].reshape(Bsz, S, H, P)
    Bmat = xBC[..., cfg.d_inner : cfg.d_inner + N]  # (B, S, N)
    Cmat = xBC[..., cfg.d_inner + N :]  # (B, S, N)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, S, H)
    a = dt * -torch.exp(p["A_log"])  # (B, S, H) log-decay
    xdt = x.float() * dt[..., None]  # dt-scaled input

    n_chunks = -(-S // Q)
    pad = n_chunks * Q - S

    def chunked(t):  # (B, S, ...) -> (B, n, Q, ...), zero-padded past S
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape((Bsz, n_chunks, Q) + t.shape[2:])

    xc = chunked(xdt)  # (B,n,Q,H,P)
    ac = chunked(a)  # (B,n,Q,H)
    Bc = chunked(Bmat.float())  # (B,n,Q,N)
    Cc = chunked(Cmat.float())  # (B,n,Q,N)

    cum = torch.cumsum(ac, dim=2)  # (B,n,Q,H)
    # intra-chunk decay kernel L[i,j] = exp(cum_i - cum_j) for i >= j
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,n,Q,Q,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=u.device))
    L = torch.where(mask[None, None, :, :, None], torch.exp(diff), 0.0)
    # intra-chunk output: y = (C_i . B_j) * L[i,j] * xdt_j
    G = torch.einsum("bniN,bnjN->bnij", Cc, Bc)  # (B,n,Q,Q)
    y_intra = torch.einsum("bnij,bnijh,bnjhp->bnihp", G, L, xc)

    # per-chunk final states: sum_j exp(cum_Q - cum_j) * B_j x_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,n,Q,H)
    states = torch.einsum("bnjN,bnjh,bnjhp->bnhpN", Bc, decay_to_end, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,n,H)

    # the state entering each chunk, carried across chunks in order
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=u.device)
    h_prev = []
    for c in range(n_chunks):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # (B,n,H,P,N)

    # inter-chunk contribution: C_i · (decay_from_start_i · h_prev)
    y_inter = torch.einsum("bniN,bnih,bnhpN->bnihp", Cc, torch.exp(cum), h_prev)
    y = (y_intra + y_inter).reshape(Bsz, n_chunks * Q, H, P)[:, :S]
    y = y + x.float() * p["D"][None, None, :, None]
    y = y.reshape(Bsz, S, cfg.d_inner).to(u.dtype)
    y = y * silu(z)
    return y @ p["out_proj"]


def ssd_init_cache(
    cfg: SSMConfig, batch: int, dtype=torch.float32, *, device="cuda"
) -> Params:
    """The decode cache: an f32 state and a conv window of ``dtype``."""
    return {
        "state": torch.zeros(
            (batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
            dtype=torch.float32,
            device=device,
        ),
        "conv": torch.zeros(
            (batch, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.d_state),
            dtype=dtype,
            device=device,
        ),
    }


def ssd_step(p: Params, cfg: SSMConfig, cache: Params, u_t: torch.Tensor):
    """Single decode step.  u_t: (B, d_model).  Returns (y_t, new_cache)."""
    H, P, N = cfg.n_heads, cfg.head_dim, cfg.d_state
    z, xBC, dt = _split_proj(cfg, u_t @ p["in_proj"])
    xBC, conv_win = conv1d_step(p["conv"], cache["conv"], xBC)
    xBC = silu(xBC)
    x = xBC[..., : cfg.d_inner].reshape(-1, H, P).float()
    Bmat = xBC[..., cfg.d_inner : cfg.d_inner + N].float()
    Cmat = xBC[..., cfg.d_inner + N :].float()
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, H)
    decay = torch.exp(dt * -torch.exp(p["A_log"]))  # (B, H)
    state = cache["state"] * decay[..., None, None] + torch.einsum(
        "bhp,bN->bhpN", x * dt[..., None], Bmat
    )
    y = torch.einsum("bhpN,bN->bhp", state, Cmat) + x * p["D"][None, :, None]
    y = y.reshape(-1, cfg.d_inner).to(u_t.dtype) * silu(z)
    return y @ p["out_proj"], {"state": state, "conv": conv_win}
