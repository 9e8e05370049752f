"""Mamba-2 (SSD — state-space duality) block, chunked, in plain PyTorch.

Counterpart of ``repro.models.ssm``: the selective SSM
h_t = exp(A·dt_t)·h_{t-1} + dt_t·B_t·x_t ;  y_t = C_t·h_t + D·x_t,
computed chunk-parallel over a sequence (a masked (Q × Q) decay kernel
inside each chunk, the chunks' final states carried by a loop over chunks)
and one step at a time in decode, which carries a (B, H, P, N) f32 state and
a conv window.  d_inner = expand · d_model in heads of ``head_dim`` (P);
B/C of state size N are shared across heads (n_groups = 1).

Tensor parallelism over "model" (a params dict lent split,
``distributed.sharding.SplitParams``): each rank computes its run of the
SSD heads (``layers.head_run``), with its heads' z, x and dt and the B and
C that every head shares (n_groups = 1), and its rows of ``out_proj``
close the block with one ``reduce_from_model``.  The sharding rules cut
``in_proj``'s packed output (z, x, B, C, dt) and the conv's channels
(x, B, C) evenly over "model", which straddles the segments, so the block
gathers those two leaves whole over "model" and reads its columns from
them (``sharding.model_use``: read in parts, the ranks' partial gradients
summed); ``A_log``, ``D`` and ``dt_bias`` are replicated and read in parts
too, and ``out_proj``'s even cut of rows is the run's heads where the
width divides the heads.  In decode the (B, H, P, N) state and the conv
window stay whole on every rank, as the cache's spec keeps them: each
rank steps its heads and all-gathers their new state and their x
channels of the window's new column over "model".
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
)
from repro_torch.models.layers import (
    causal_conv1d,
    conv1d_step,
    dense_init,
    full,
    head_run,
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


def _rank_part(p: Params, cfg: SSMConfig, tp) -> tuple[Params, int]:
    """The leaves of this rank's run of heads, and its head count:
    ``in_proj``'s z, x and dt columns of the run (``zxdt``) and its B and
    C columns (``bc``, the same on every rank); the conv's x channels of
    the run and its B and C channels; ``A_log``, ``D``, ``dt_bias`` of the
    run; ``out_proj``'s rows of the run, this rank's slice where it is
    split."""
    d_in, N, P = cfg.d_inner, cfg.d_state, cfg.head_dim
    h0, h1 = head_run(cfg.n_heads, tp)
    x, heads = slice(h0 * P, h1 * P), slice(h0, h1)
    w, conv, out = p["in_proj"], p["conv"], p["out_proj"]
    zxdt = [w[..., x], w[..., d_in:][..., x], w[..., 2 * d_in + 2 * N :][..., heads]]
    part = {
        "zxdt": torch.cat(zxdt, dim=-1),
        "bc": w[..., 2 * d_in : 2 * d_in + 2 * N],
        "conv": {k: torch.cat([c[..., x], c[..., d_in:]], -1) for k, c in conv.items()},
        "out_proj": out if out.shape[-2] != d_in else out[..., x, :],
    }
    for name in ("A_log", "D", "dt_bias"):
        part[name] = p[name][..., heads]
    return part, h1 - h0


def _project(p: Params, cfg: SSMConfig, u: torch.Tensor, tp):
    """(z, xBC, dt, the params, the head count) of the heads this rank
    computes: all of them where ``tp`` is None, else its run, from two
    products (z, x and dt; B and C, the same on every rank)."""
    if tp is None:
        return (*_split_proj(cfg, u @ p["in_proj"]), p, cfg.n_heads)
    p, H = _rank_part(p, cfg, tp)
    zxdt = u @ p["zxdt"]
    d_in = H * cfg.head_dim
    xBC = torch.cat([zxdt[..., d_in : 2 * d_in], u @ p["bc"]], dim=-1)
    return zxdt[..., :d_in], xBC, zxdt[..., 2 * d_in :], p, H


def ssd_forward(p: Params, cfg: SSMConfig, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD.  u: (B, S, d_model) -> (B, S, d_model); on this
    rank's run of heads where ``p`` is lent split over "model"."""
    Bsz, S, _ = u.shape
    tp = getattr(p, "tp", None)
    if tp is not None:
        u = copy_to_model(u, tp)
    z, xBC, dt, p, H = _project(p, cfg, u, tp)
    P, N, Q = cfg.head_dim, cfg.d_state, cfg.chunk
    d_in = H * P
    xBC = silu(causal_conv1d(p["conv"], xBC))
    x = xBC[..., :d_in].reshape(Bsz, S, H, P)
    Bmat = xBC[..., d_in : d_in + N]  # (B, S, N)
    Cmat = xBC[..., d_in + N :]  # (B, S, N)
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
    # masked before the exp: above the diagonal cum_i - cum_j > 0 can
    # overflow, and exp's gradient there (0 · inf) would be NaN (the JAX
    # package exponentiates first and its gradient is NaN at full width)
    L = torch.exp(torch.where(mask[None, None, :, :, None], diff, -torch.inf))
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
    y = y.reshape(Bsz, S, d_in).to(u.dtype)
    y = y * silu(z)
    out = y @ p["out_proj"]
    return out if tp is None else reduce_from_model(out, tp)


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


def _join_heads(state: torch.Tensor, x_t: torch.Tensor, cfg: SSMConfig, tp):
    """The whole new state (B, H, P, N) and x channels (B, d_inner) of the
    conv window's new column from each rank's run of heads: one
    all-gather over "model" (f32; each run padded to the longest)."""
    Bsz, h, P, N = state.shape
    H, w = cfg.n_heads, tp.size
    longest = -(-H // w)
    mine = torch.cat([state.flatten(2), x_t.unflatten(-1, (h, P)).float()], -1)
    mine = F.pad(mine, (0, 0, 0, longest - h))
    every = gather_from_model(mine, 1, tp).unflatten(1, (w, longest))
    runs = [(r + 1) * H // w - r * H // w for r in range(w)]  # head_run's
    every = torch.cat([every[:, r, :n] for r, n in enumerate(runs)], dim=1)
    state = every[..., : P * N].unflatten(-1, (P, N))
    return state, every[..., P * N :].flatten(1).to(x_t.dtype)


def ssd_step(p: Params, cfg: SSMConfig, cache: Params, u_t: torch.Tensor):
    """Single decode step.  u_t: (B, d_model).  Returns (y_t, new_cache);
    on this rank's run of heads where ``p`` is lent split over "model",
    the new cache whole (``_join_heads``)."""
    P, N = cfg.head_dim, cfg.d_state
    tp = getattr(p, "tp", None)
    state, win = cache["state"], cache["conv"]
    if tp is not None:  # the rank's heads of the state, its channels of the window
        h0, h1 = head_run(cfg.n_heads, tp)
        state = state[:, h0:h1]
        win = torch.cat([win[..., h0 * P : h1 * P], win[..., cfg.d_inner :]], -1)
    z, xBC, dt, p, H = _project(p, cfg, u_t, tp)
    d_in = H * P
    col = xBC  # the window's new column
    xBC, conv_win = conv1d_step(p["conv"], win, xBC)
    xBC = silu(xBC)
    x = xBC[..., :d_in].reshape(-1, H, P).float()
    Bmat = xBC[..., d_in : d_in + N].float()
    Cmat = xBC[..., d_in + N :].float()
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, H)
    decay = torch.exp(dt * -torch.exp(p["A_log"]))  # (B, H)
    state = state * decay[..., None, None] + torch.einsum(
        "bhp,bN->bhpN", x * dt[..., None], Bmat
    )
    y = torch.einsum("bhpN,bN->bhp", state, Cmat) + x * p["D"][None, :, None]
    y = y.reshape(-1, d_in).to(u_t.dtype) * silu(z)
    out = y @ p["out_proj"]
    if tp is None:
        return out, {"state": state, "conv": conv_win}
    state, x_all = _join_heads(state, col[..., :d_in], cfg, tp)
    col = torch.cat([x_all, col[..., d_in:]], dim=-1)
    conv_win = torch.cat([cache["conv"][:, 1:], col[:, None, :]], dim=1)
    return reduce_from_model(out, tp), {"state": state, "conv": conv_win}
