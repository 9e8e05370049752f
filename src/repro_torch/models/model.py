"""Model assembly for the five families' decode paths, in plain PyTorch.

Counterpart of ``repro.models.model``'s decode side: ``ModelConfig``,
``init_params``, ``init_cache`` and ``decode_step`` for every family —

* ``dense``  — llama-style decoder (and the internvl2 backbone);
* ``moe``    — dense backbone with MoE FFNs (dbrx, phi3.5-moe);
* ``ssm``    — Mamba-2 SSD stack (mamba2-780m), attention-free;
* ``hybrid`` — RecurrentGemma: a repeating [RG-LRU, RG-LRU, local-attn]
  pattern, every block followed by an MLP, decoding local attention
  against a ring-buffer window cache;
* ``encdec`` — Whisper's decoder, with cross attention over a frozen
  encoder KV cache.

The parameter tree has the JAX package's layout — per-layer parameters
stacked on a leading layer axis, weights ``(in, out)`` — and the JAX
``lax.scan`` over that axis is a Python loop here.  The full-sequence paths
(``forward``, ``prefill``, ``loss_fn``, the encoder) are not ported yet
(ROADMAP.md, "Modules to port", item 5).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch._device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import AttnConfig
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.models.rglru import (
    RGLRUConfig,
    init_rglru,
    rglru_init_cache,
    rglru_step,
)
from repro_torch.models.ssm import SSMConfig, init_ssd, ssd_init_cache, ssd_step

Params = dict[str, Any]


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
    pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    # encdec
    n_enc_layers: int = 0
    enc_seq: int = 1500
    max_dec_seq: int = 8192  # learned decoder position-table size
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

    @property
    def local_attn_cfg(self) -> AttnConfig:
        return dataclasses.replace(self.attn_cfg, window=self.window)

    @property
    def ssm_cfg(self) -> SSMConfig:
        return SSMConfig(
            d_model=self.d_model,
            d_state=self.ssm_state,
            head_dim=self.ssm_head_dim,
            expand=self.ssm_expand,
        )

    @property
    def rglru_cfg(self) -> RGLRUConfig:
        width = self.lru_width or self.d_model
        return RGLRUConfig(d_model=self.d_model, lru_width=width)

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Exact parameter count, from the shapes ``init_params`` makes on
        the meta device (nothing is allocated)."""
        return sum(t.numel() for t in _leaves(init_params(self, device="meta")))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a tree stacked on a leading layer axis (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _norm_init(cfg: ModelConfig, gen, dim: int, lead: tuple[int, ...] = ()) -> Params:
    if cfg.norm == "rms":
        return L.init_rmsnorm(gen, dim, lead)
    return L.init_layernorm(gen, dim, lead)


def _norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return L.rmsnorm(p, x) if cfg.norm == "rms" else L.layernorm(p, x)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_block(cfg: ModelConfig, gen, lead: tuple[int, ...]) -> Params:
    """Decoder blocks of the dense/moe families."""
    d = cfg.d_model
    p: Params = {
        "attn_norm": _norm_init(cfg, gen, d, lead),
        "attn": L.init_attention(gen, cfg.attn_cfg, lead),
        "mlp_norm": _norm_init(cfg, gen, d, lead),
    }
    if cfg.family == "moe":
        p["moe"] = init_moe(gen, d, cfg.d_ff, cfg.n_experts, cfg.mlp_kind, lead)
    else:
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, lead)
    return p


def _init_hybrid_sub(cfg: ModelConfig, gen, kind: str, lead: tuple[int, ...]) -> Params:
    d = cfg.d_model
    sub: Params = {
        "temporal_norm": _norm_init(cfg, gen, d, lead),
        "mlp_norm": _norm_init(cfg, gen, d, lead),
        "mlp": L.init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, lead),
    }
    if kind == "rec":
        sub["rglru"] = init_rglru(gen, cfg.rglru_cfg, lead)
    else:
        sub["attn"] = L.init_attention(gen, cfg.local_attn_cfg, lead)
    return sub


def _init_hybrid_super(cfg: ModelConfig, gen, lead: tuple[int, ...]) -> Params:
    """RecurrentGemma super-blocks following cfg.pattern."""
    return {
        f"sub{i}": _init_hybrid_sub(cfg, gen, kind, lead)
        for i, kind in enumerate(cfg.pattern)
    }


def _init_enc_block(cfg: ModelConfig, gen, lead: tuple[int, ...]) -> Params:
    d = cfg.d_model
    enc_attn = dataclasses.replace(cfg.attn_cfg, causal=False, use_rope=False)
    return {
        "attn_norm": _norm_init(cfg, gen, d, lead),
        "attn": L.init_attention(gen, enc_attn, lead),
        "mlp_norm": _norm_init(cfg, gen, d, lead),
        "mlp": L.init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, lead),
    }


def _init_dec_block(cfg: ModelConfig, gen, lead: tuple[int, ...]) -> Params:
    d = cfg.d_model
    dec_attn = dataclasses.replace(cfg.attn_cfg, use_rope=False)
    return {
        "attn_norm": _norm_init(cfg, gen, d, lead),
        "attn": L.init_attention(gen, dec_attn, lead),
        "cross_norm": _norm_init(cfg, gen, d, lead),
        "cross": L.init_attention(gen, dec_attn, lead),
        "mlp_norm": _norm_init(cfg, gen, d, lead),
        "mlp": L.init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, lead),
    }


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> Params:
    """Random parameters drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed`` (not the JAX package's numbers: carry those across
    with ``models.convert.params_from_jax``).  On the meta device, the
    shapes and dtypes alone."""
    dev = resolve_device(device)
    gen = dev if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    p: Params = {
        "embed": L.embed_init(gen, cfg.vocab, d),
        "final_norm": _norm_init(cfg, gen, d),
        "lm_head": L.dense_init(gen, d, cfg.vocab),
    }
    if cfg.family in ("dense", "moe"):
        p["blocks"] = _init_block(cfg, gen, (cfg.n_layers,))
    elif cfg.family == "ssm":
        lead = (cfg.n_layers,)
        p["blocks"] = {
            "norm": _norm_init(cfg, gen, d, lead),
            "ssd": init_ssd(gen, cfg.ssm_cfg, lead),
        }
    elif cfg.family == "hybrid":
        n_super, rem = divmod(cfg.n_layers, len(cfg.pattern))
        p["blocks"] = _init_hybrid_super(cfg, gen, (n_super,))
        # leftover layers (26 = 8*3 + 2 for recurrentgemma) are recurrent
        for i in range(rem):
            p[f"tail{i}"] = _init_hybrid_sub(cfg, gen, "rec", ())
    elif cfg.family == "encdec":
        p["enc_blocks"] = _init_enc_block(cfg, gen, (cfg.n_enc_layers,))
        p["dec_blocks"] = _init_dec_block(cfg, gen, (cfg.n_layers,))
        p["enc_final_norm"] = _norm_init(cfg, gen, d)
        p["enc_pos"] = L.normal(gen, (cfg.enc_seq, d), 0.02)
        p["dec_pos"] = L.normal(gen, (cfg.max_dec_seq, d), 0.02)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return p


# ---------------------------------------------------------------------------
# decode (single-token serve step against the caches)
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, *, device="cuda"
) -> Params:
    """Decode cache for a (batch, max_seq) serving session, every leaf with
    the batch on axis 1.  Each layer's state is its own memory (the JAX
    package broadcasts one zero state over the layers), since the decode
    step writes it in place."""
    dev = resolve_device(device)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def stacked(n: int, single: Params) -> Params:
        return {k: zeros(n, *v.shape, dt=v.dtype) for k, v in single.items()}

    kv = (cfg.n_kv_heads, cfg.head_dim)
    if cfg.family in ("dense", "moe"):
        return {
            "k": zeros(cfg.n_layers, batch, max_seq, *kv),
            "v": zeros(cfg.n_layers, batch, max_seq, *kv),
        }
    if cfg.family == "ssm":
        single = ssd_init_cache(cfg.ssm_cfg, batch, dtype, device="meta")
        return stacked(cfg.n_layers, single)
    if cfg.family == "hybrid":
        n_super, rem = divmod(cfg.n_layers, len(cfg.pattern))
        n_attn = sum(1 for k in cfg.pattern if k == "attn") * n_super
        n_rec = sum(1 for k in cfg.pattern if k == "rec") * n_super + rem
        win = min(cfg.window, max_seq)
        rec = rglru_init_cache(cfg.rglru_cfg, batch, dtype, device="meta")
        return {
            "attn_k": zeros(n_attn, batch, win, *kv),
            "attn_v": zeros(n_attn, batch, win, *kv),
            "rec": stacked(n_rec, rec),
        }
    if cfg.family == "encdec":
        return {
            "k": zeros(cfg.n_layers, batch, max_seq, *kv),
            "v": zeros(cfg.n_layers, batch, max_seq, *kv),
            "cross_k": zeros(cfg.n_layers, batch, cfg.enc_seq, *kv),
            "cross_v": zeros(cfg.n_layers, batch, cfg.enc_seq, *kv),
        }
    raise ValueError(cfg.family)


def _merge_into(cache: torch.Tensor, new: torch.Tensor, live) -> None:
    """Write ``new`` into ``cache`` in place, keeping the old rows where
    ``live`` (along axis 0) is false: the JAX package's masked merge."""
    new = new.to(cache.dtype)
    if live is not None:
        new = torch.where(live.view((-1,) + (1,) * (new.dim() - 1)), new, cache)
    cache.copy_(new)


def _decode_attn(
    p: Params,
    cfg_a: AttnConfig,
    x: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    live: torch.Tensor | None = None,
    ring: bool = False,
    update_cache: bool = True,
) -> torch.Tensor:
    """Attention of one new token per row against its cache.

    Cache: (B, S, KV, D).  Every row's new k/v is written in place at its
    slot and attended to; afterwards the rows where ``live`` is false get
    their old entries back.  That is the JAX package's result — it writes
    every row into a new cache, attends, and keeps the live rows by a
    masked merge — without copying the cache.  ``ring=True`` treats the
    cache as a ring buffer of a local-attention window (slot
    ``cache_len % S``); ``update_cache=False`` reads a frozen cache (cross
    attention over the encoder's KV), which is never written.
    """
    B = x.shape[0]
    S = k_cache.shape[1]
    q, k, v = L._project_qkv(p, cfg_a, x, cache_len[:, None])
    if update_cache:
        rows = torch.arange(B, device=x.device)
        slot = (cache_len % S if ring else cache_len).long()
        writes = ((k_cache, k[:, 0]), (v_cache, v[:, 0]))
        kept = [cache[rows, slot] for cache, _ in writes] if live is not None else []
        for cache, new in writes:
            cache[rows, slot] = new.to(cache.dtype)
    base = torch.arange(S, device=x.device)[None, :]
    length = cache_len[:, None].long()
    if ring:
        # true position of ring slot s: the latest write w <= cache_len with
        # w % S == s:  w = cache_len - ((cache_len - s) % S)
        kv_pos = length - ((length - base) % S)
        valid = kv_pos >= 0
    else:
        kv_pos = base
        valid = kv_pos <= length
    mask = valid[:, None, None, :]
    if cfg_a.window is not None:
        mask = mask & (kv_pos > length - cfg_a.window)[:, None, None, :]
    rep = cfg_a.n_heads // cfg_a.n_kv_heads
    scale = 1.0 / math.sqrt(cfg_a.head_dim)
    qg = q[:, 0].float().reshape(B, cfg_a.n_kv_heads, rep, cfg_a.head_dim) * scale
    s = torch.einsum("bkrd,bskd->bkrs", qg, k_cache.float())  # (B, KV, rep, S)
    s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrs,bskd->bkrd", w, v_cache.float())
    out = out.reshape(B, 1, cfg_a.q_dim).to(x.dtype)
    if update_cache and live is not None:
        for (cache, _), old in zip(writes, kept):
            cache[rows, slot] = torch.where(live[:, None, None], cache[rows, slot], old)
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
    x = params["embed"][token].to(torch.bfloat16)  # (B, 1, d)
    if cfg.family in ("dense", "moe"):
        for i in range(cfg.n_layers):
            bp = _layer(params["blocks"], i)
            z = _norm(cfg, bp["attn_norm"], x)
            kc, vc = cache["k"][i], cache["v"][i]
            x = x + _decode_attn(bp["attn"], cfg.attn_cfg, z, kc, vc, cache_len, live)
            z = _norm(cfg, bp["mlp_norm"], x)
            if cfg.family == "moe":
                m = bp["moe"]
                x = x + moe_ffn(m, z, cfg.top_k, cfg.mlp_kind, cfg.capacity_factor)
            else:
                x = x + L.mlp(bp["mlp"], z, cfg.mlp_kind)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            bp = _layer(params["blocks"], i)
            c = _layer(cache, i)
            y, c2 = ssd_step(bp["ssd"], cfg.ssm_cfg, c, _norm(cfg, bp["norm"], x)[:, 0])
            for key in c:
                _merge_into(c[key], c2[key], live)
            x = x + y[:, None, :]
    elif cfg.family == "hybrid":
        x = _hybrid_decode(cfg, params, cache, x, cache_len, live)
    elif cfg.family == "encdec":
        x = _encdec_decode(cfg, params, cache, x, cache_len, live)
    else:
        raise ValueError(cfg.family)
    x = _norm(cfg, params["final_norm"], x)
    return x @ params["lm_head"], cache


def _hybrid_sub_decode(cfg, sp, kind, x, cache, ai, ri, cache_len, live):
    """One hybrid layer: the temporal block (RG-LRU on recurrent layer
    ``ri``, or local attention on ring cache ``ai``), then its MLP."""
    z = _norm(cfg, sp["temporal_norm"], x)
    if kind == "rec":
        rc = _layer(cache["rec"], ri)
        y, rc2 = rglru_step(sp["rglru"], cfg.rglru_cfg, rc, z[:, 0])
        for key in rc:
            _merge_into(rc[key], rc2[key], live)
        x = x + y[:, None, :]
    else:
        kc, vc = cache["attn_k"][ai], cache["attn_v"][ai]
        a_cfg = cfg.local_attn_cfg
        x = x + _decode_attn(sp["attn"], a_cfg, z, kc, vc, cache_len, live, ring=True)
    return x + L.mlp(sp["mlp"], _norm(cfg, sp["mlp_norm"], x), cfg.mlp_kind)


def _hybrid_decode(cfg, params, cache, x, cache_len, live):
    n_super, rem = divmod(cfg.n_layers, len(cfg.pattern))
    ai = ri = 0
    for s in range(n_super):
        bp = _layer(params["blocks"], s)
        for i, kind in enumerate(cfg.pattern):
            x = _hybrid_sub_decode(
                cfg, bp[f"sub{i}"], kind, x, cache, ai, ri, cache_len, live
            )
            ai, ri = (ai, ri + 1) if kind == "rec" else (ai + 1, ri)
    for t in range(rem):
        sp = params[f"tail{t}"]
        x = _hybrid_sub_decode(cfg, sp, "rec", x, cache, ai, ri, cache_len, live)
        ri += 1
    return x


def _encdec_decode(cfg, params, cache, x, cache_len, live):
    table = params["dec_pos"]
    x = x + table[(cache_len.long() % table.shape[0])][:, None, :].to(x.dtype)
    a_cfg = dataclasses.replace(cfg.attn_cfg, use_rope=False)
    x_cfg = dataclasses.replace(a_cfg, causal=False)
    enc_len = torch.full_like(cache_len, cfg.enc_seq - 1)
    for i in range(cfg.n_layers):
        bp = _layer(params["dec_blocks"], i)
        z = _norm(cfg, bp["attn_norm"], x)
        kc, vc = cache["k"][i], cache["v"][i]
        x = x + _decode_attn(bp["attn"], a_cfg, z, kc, vc, cache_len, live)
        z = _norm(cfg, bp["cross_norm"], x)
        # cross attention: query the (precomputed, frozen) encoder KV
        xk, xv = cache["cross_k"][i], cache["cross_v"][i]
        x = x + _decode_attn(bp["cross"], x_cfg, z, xk, xv, enc_len, update_cache=False)
        x = x + L.mlp(bp["mlp"], _norm(cfg, bp["mlp_norm"], x), cfg.mlp_kind)
    return x
