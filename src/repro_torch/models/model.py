"""Model assembly for the five families, in plain PyTorch.

Counterpart of ``repro.models.model``: ``ModelConfig``, ``init_params``,
the full-sequence paths (``forward``, ``prefill``, ``loss_fn``, the
Whisper encoder ``_encode``) and the decode side (``init_cache``,
``decode_step``) for every family —

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
unbind each stack once per call (under autograd, the backward of that is a
single ``stack``, where indexing layer by layer would build a stack-sized
gradient per layer) and rematerialise each layer body when ``cfg.remat``
is set, as ``jax.checkpoint`` does in the JAX package.

Tensor parallelism over "model" (a params tree lent by
``distributed.sharding.lend_params``): where the tree is a ``SplitParams``
its vocab tables are this rank's slices — the embedding looks up the
rank's vocab range and ``reduce_from_model`` joins the rows, the head
gives the rank's slice of the logits, ``loss_fn`` is a cross-entropy
over the split vocab (its max, sum of exponentials and gold logit each
reduced over "model", no (B, S, vocab) tensor gathered), and ``prefill``
and ``decode_step`` return whole logits (the last position's slices
all-gathered).  The layers read their own split from their dicts
(attention and the SSD block a run of heads a rank; the decode step's
attention projects on the placed columns, ``layers.project_on_columns``).
A decode cache whose KV sequence is split over "model" (a
``distributed.sharding.SplitCache``) is written only by the rank whose
positions hold the new slot, and each rank's partial softmax over its
positions is combined by a max and a sum over "model" (log-sum-exp).  A
"model" axis of one rank is never lent (``sharding.model_axis``): there
the paths are the one-device ones.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import leaves
from repro_torch.distributed.collectives import (
    copy_to_model,
    gather_from_model,
    max_over_model,
    reduce_from_model,
)
from repro_torch.models import layers as L
from repro_torch.models.layers import AttnConfig
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.models.rglru import (
    RGLRUConfig,
    init_rglru,
    rglru_forward,
    rglru_init_cache,
    rglru_step,
)
from repro_torch.models.ssm import (
    SSMConfig,
    init_ssd,
    ssd_forward,
    ssd_init_cache,
    ssd_step,
)

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
        return sum(t.numel() for t in leaves(init_params(self, device="meta")))


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a tree stacked on a leading layer axis (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _block(blocks: Params, i: int) -> Params:
    """Layer ``i`` of a stacked subtree, gathered whole where the subtree
    is a stack of local shards (``distributed.sharding.ShardedStack``)."""
    gather = getattr(blocks, "gather_layer", None)
    return _layer(blocks, i) if gather is None else gather(_layer(blocks, i))


def _unstack(tree: Params, n: int) -> list[Params]:
    """The ``n`` layers of a tree stacked on a leading layer axis, each leaf
    unbound once (views)."""
    if isinstance(tree, dict):
        cols = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: c[i] for k, c in cols.items()} for i in range(n)]
    return tree.unbind(0)


def _norm_init(cfg: ModelConfig, gen, dim: int, lead: tuple[int, ...] = ()) -> Params:
    if cfg.norm == "rms":
        return L.init_rmsnorm(gen, dim, lead)
    return L.init_layernorm(gen, dim, lead)


def _norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return L.rmsnorm(p, x) if cfg.norm == "rms" else L.layernorm(p, x)


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings, bf16: on a vocab split over "model" each rank
    looks up the tokens in its range, zero elsewhere, and the ranks' rows
    are summed."""
    table = params["embed"]
    tp = getattr(params, "tp", None)
    if tp is None:
        return table[tokens].to(torch.bfloat16)
    n = table.shape[0]
    idx = tokens.long() - tp.rank * n
    inside = (idx >= 0) & (idx < n)
    rows = table[idx.clamp(0, n - 1)]
    rows = torch.where(inside[..., None], rows, 0)
    return reduce_from_model(rows, tp).to(torch.bfloat16)


def _logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ lm_head``: this rank's vocab slice where it is split."""
    tp = getattr(params, "tp", None)
    if tp is None:
        return x @ params["lm_head"]
    return copy_to_model(x, tp) @ params["lm_head"]


def _whole_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ lm_head`` over the whole vocab (the ranks' slices all-gathered
    where it is split; no gradient then)."""
    tp = getattr(params, "tp", None)
    logits = _logits(params, x)
    return logits if tp is None else gather_from_model(logits, -1, tp)


def _split_nll(logits: torch.Tensor, labels: torch.Tensor, tp) -> torch.Tensor:
    """``logsumexp(logits) - logits[label]`` over the whole vocab from this
    rank's slice of the f32 logits: the global max by one all-reduce, the
    sum of exponentials and the gold logit (zero on the ranks whose slice
    does not hold the label) by another."""
    n = logits.shape[-1]
    m = max_over_model(logits.amax(dim=-1), tp)
    sum_exp = torch.exp(logits - m[..., None]).sum(dim=-1)
    idx = labels - tp.rank * n
    inside = (idx >= 0) & (idx < n)
    gold = torch.take_along_dim(logits, idx.clamp(0, n - 1)[..., None], dim=-1)[..., 0]
    gold = torch.where(inside, gold, 0.0)
    sum_exp, gold = reduce_from_model(torch.stack([sum_exp, gold]), tp).unbind(0)
    return torch.log(sum_exp) + m - gold


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
# full-sequence forward (training / prefill)
# ---------------------------------------------------------------------------


def _dense_block_fwd(
    cfg: ModelConfig, bp: Params, x: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    z = _norm(cfg, bp["attn_norm"], x)
    h = x + L.attention(bp["attn"], cfg.attn_cfg, z, positions)
    z = _norm(cfg, bp["mlp_norm"], h)
    if cfg.family == "moe":
        ff = moe_ffn(bp["moe"], z, cfg.top_k, cfg.mlp_kind, cfg.capacity_factor)
    else:
        ff = L.mlp(bp["mlp"], z, cfg.mlp_kind)
    return h + ff


def _hybrid_sub_fwd(
    cfg: ModelConfig, sp: Params, kind: str, x: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    z = _norm(cfg, sp["temporal_norm"], x)
    if kind == "rec":
        t = rglru_forward(sp["rglru"], cfg.rglru_cfg, z)
    else:
        t = L.attention(sp["attn"], cfg.local_attn_cfg, z, positions)
    h = x + t
    return h + L.mlp(sp["mlp"], _norm(cfg, sp["mlp_norm"], h), cfg.mlp_kind)


def _scan_blocks(
    cfg: ModelConfig, blocks: Params, x: torch.Tensor, body
) -> torch.Tensor:
    """``body(layer_params, h)`` over the stacked layers in order, each layer
    rematerialised in the backward pass when ``cfg.remat`` is set.  A
    stack of local shards (``distributed.sharding.ShardedStack``) has each
    layer gathered whole inside its body."""
    n = leaves(blocks)[0].shape[0]
    gather = getattr(blocks, "gather_layer", None)
    if gather is not None:  # a sharded stack: each layer gathered in its body
        inner = body

        def body(bp, h):
            return inner(gather(bp), h)

    for bp in _unstack(blocks, n):
        x = L.remat(body, bp, x) if cfg.remat else body(bp, x)
    return x


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    frames: torch.Tensor | None = None,
    patches: torch.Tensor | None = None,
    return_hidden: bool = False,
) -> torch.Tensor:
    """Full-sequence logits (or final hidden states).

    tokens: (B, S) ints.  ``frames`` (audio stub, B×enc_seq×d) feeds the
    encdec encoder; ``patches`` (vision stub, B×n_patches×d) is prepended
    to the token embeddings (internvl2).  Returns (B, S, vocab) logits for
    the token positions, or the normed (B, S, d) hidden states when
    ``return_hidden`` (prefill needs only the last position's logits).
    """
    B, S = tokens.shape
    x = _embed(params, tokens)
    n_prefix = 0
    if cfg.frontend == "vision":
        if patches is None:
            raise ValueError("vision frontend needs `patches`")
        x = torch.cat([patches.to(x.dtype), x], dim=1)
        n_prefix = patches.shape[1]
    positions = L._positions(B, x.shape[1], x.device)

    if cfg.family in ("dense", "moe"):

        def body(bp, h):
            return _dense_block_fwd(cfg, bp, h, positions)

        x = _scan_blocks(cfg, params["blocks"], x, body)
    elif cfg.family == "ssm":

        def body(bp, h):
            return h + ssd_forward(bp["ssd"], cfg.ssm_cfg, _norm(cfg, bp["norm"], h))

        x = _scan_blocks(cfg, params["blocks"], x, body)
    elif cfg.family == "hybrid":

        def body(bp, h):
            for i, kind in enumerate(cfg.pattern):
                h = _hybrid_sub_fwd(cfg, bp[f"sub{i}"], kind, h, positions)
            return h

        x = _scan_blocks(cfg, params["blocks"], x, body)
        i = 0
        while f"tail{i}" in params:
            x = _hybrid_sub_fwd(cfg, params[f"tail{i}"], "rec", x, positions)
            i += 1
    elif cfg.family == "encdec":
        if frames is None:
            raise ValueError("encdec needs `frames` (audio stub)")
        mem = _encode(cfg, params, frames)
        x = x + params["dec_pos"][:S].to(x.dtype)
        a_cfg = dataclasses.replace(cfg.attn_cfg, use_rope=False)

        def body(bp, h):
            z = _norm(cfg, bp["attn_norm"], h)
            h = h + L.attention(bp["attn"], a_cfg, z, positions)
            z = _norm(cfg, bp["cross_norm"], h)
            h = h + L.cross_attention(bp["cross"], a_cfg, z, mem)
            return h + L.mlp(bp["mlp"], _norm(cfg, bp["mlp_norm"], h), cfg.mlp_kind)

        x = _scan_blocks(cfg, params["dec_blocks"], x, body)
    else:
        raise ValueError(cfg.family)

    x = _norm(cfg, params["final_norm"], x)
    if n_prefix:
        x = x[:, n_prefix:]
    if return_hidden:
        return x
    return _whole_logits(params, x)


def _encode(cfg: ModelConfig, params: Params, frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over stubbed frame embeddings (B, enc_seq, d)."""
    x = frames.to(torch.bfloat16) + params["enc_pos"].to(torch.bfloat16)
    Bz, Se, _ = x.shape
    pos = L._positions(Bz, Se, x.device)
    enc_attn = dataclasses.replace(cfg.attn_cfg, causal=False, use_rope=False)

    def body(bp, h):
        h = h + L.attention(bp["attn"], enc_attn, _norm(cfg, bp["attn_norm"], h), pos)
        return h + L.mlp(bp["mlp"], _norm(cfg, bp["mlp_norm"], h), cfg.mlp_kind)

    x = _scan_blocks(cfg, params["enc_blocks"], x, body)
    return _norm(cfg, params["enc_final_norm"], x)


def loss_fn(cfg: ModelConfig, params: Params, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy (labels = tokens shifted by the caller);
    over the split vocab where ``params`` splits it over "model"."""
    hidden = forward(
        cfg,
        params,
        batch["tokens"],
        frames=batch.get("frames"),
        patches=batch.get("patches"),
        return_hidden=True,
    )
    logits = _logits(params, hidden).float()
    labels = batch["labels"].long()
    tp = getattr(params, "tp", None)
    if tp is not None:
        return torch.mean(_split_nll(logits, labels, tp))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    return torch.mean(logz - gold)


def prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    frames: torch.Tensor | None = None,
    patches: torch.Tensor | None = None,
) -> torch.Tensor:
    """Prefill = full forward returning last-position logits; the vocab
    projection runs on the last position only."""
    hidden = forward(
        cfg, params, tokens, frames=frames, patches=patches, return_hidden=True
    )
    return _whole_logits(params, hidden[:, -1:])


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
    seq=None,
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

    ``seq`` (a ``ModelAxis``): the cache holds this rank's run of the
    positions, S/width of them: the rank whose run holds a row's slot
    writes it, and the ranks' partial softmaxes are combined.  Where ``p``
    is lent split over "model", the new token's q (and k, v) are projected
    on this rank's placed columns and joined over "model" before rope
    (``layers.project_on_columns``: the cache holds every kv head), and
    the rank keeps its columns of the output for its rows of ``wo``.
    """
    B = x.shape[0]
    S_l = k_cache.shape[1]
    lo, S = (seq.rank * S_l, S_l * seq.size) if seq is not None else (0, S_l)
    tp = getattr(p, "tp", None)
    pos = cache_len[:, None]
    if update_cache:
        q, k, v = L.project_on_columns(p, cfg_a, x, pos, tp)
        rows = torch.arange(B, device=x.device)
        slot = (cache_len % S if ring else cache_len).long() - lo
        own = None
        if seq is not None:  # the slot lies in this rank's run of positions
            own = ((slot >= 0) & (slot < S_l))[:, None, None]
            slot = slot.clamp(0, S_l - 1)
        writes = ((k_cache, k[:, 0]), (v_cache, v[:, 0]))
        keep = live is not None or own is not None
        kept = [cache[rows, slot] for cache, _ in writes] if keep else [None, None]
        for (cache, new), old in zip(writes, kept):
            new = new.to(cache.dtype)
            cache[rows, slot] = new if own is None else torch.where(own, new, old)
    else:
        (q,) = L.project_on_columns(p, cfg_a, x, pos, tp, kv=False)
    base = lo + torch.arange(S_l, device=x.device)[None, :]
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
    if seq is None:
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("bkrs,bskd->bkrd", w, v_cache.float())
    else:  # log-sum-exp over the ranks' runs: a max, then two sums in one
        m = max_over_model(s.amax(dim=-1), seq)
        e = torch.exp(s - m[..., None])
        pv = torch.einsum("bkrs,bskd->bkrd", e, v_cache.float())
        part = reduce_from_model(torch.cat([e.sum(-1)[..., None], pv], dim=-1), seq)
        out = part[..., 1:] / part[..., :1]
    out = out.reshape(B, 1, cfg_a.q_dim).to(x.dtype)
    if update_cache and live is not None:
        for (cache, _), old in zip(writes, kept):
            cache[rows, slot] = torch.where(live[:, None, None], cache[rows, slot], old)
    if tp is None:
        return out @ p["wo"]
    n = p["wo"].shape[-2]
    return reduce_from_model(out[..., tp.rank * n : (tp.rank + 1) * n] @ p["wo"], tp)


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
    x = _embed(params, token)  # (B, 1, d)
    seq = getattr(cache, "seq", {})
    if cfg.family in ("dense", "moe"):
        for i in range(cfg.n_layers):
            bp = _block(params["blocks"], i)
            z = _norm(cfg, bp["attn_norm"], x)
            kc, vc = cache["k"][i], cache["v"][i]
            x = x + _decode_attn(
                bp["attn"], cfg.attn_cfg, z, kc, vc, cache_len, live, seq=seq.get("k")
            )
            z = _norm(cfg, bp["mlp_norm"], x)
            if cfg.family == "moe":
                m = bp["moe"]
                x = x + moe_ffn(m, z, cfg.top_k, cfg.mlp_kind, cfg.capacity_factor)
            else:
                x = x + L.mlp(bp["mlp"], z, cfg.mlp_kind)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            bp = _block(params["blocks"], i)
            c = _layer(cache, i)
            y, c2 = ssd_step(bp["ssd"], cfg.ssm_cfg, c, _norm(cfg, bp["norm"], x)[:, 0])
            for key in c:
                _merge_into(c[key], c2[key], live)
            x = x + y[:, None, :]
    elif cfg.family == "hybrid":
        x = _hybrid_decode(cfg, params, cache, x, cache_len, live, seq)
    elif cfg.family == "encdec":
        x = _encdec_decode(cfg, params, cache, x, cache_len, live, seq)
    else:
        raise ValueError(cfg.family)
    x = _norm(cfg, params["final_norm"], x)
    return _whole_logits(params, x), cache


def _hybrid_sub_decode(cfg, sp, kind, x, cache, ai, ri, cache_len, live, seq):
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
        x = x + _decode_attn(
            sp["attn"], a_cfg, z, kc, vc, cache_len, live, ring=True, seq=seq
        )
    return x + L.mlp(sp["mlp"], _norm(cfg, sp["mlp_norm"], x), cfg.mlp_kind)


def _hybrid_decode(cfg, params, cache, x, cache_len, live, seq):
    n_super, rem = divmod(cfg.n_layers, len(cfg.pattern))
    ai = ri = 0
    ring = seq.get("attn_k")
    for s in range(n_super):
        bp = _block(params["blocks"], s)
        for i, kind in enumerate(cfg.pattern):
            x = _hybrid_sub_decode(
                cfg, bp[f"sub{i}"], kind, x, cache, ai, ri, cache_len, live, ring
            )
            ai, ri = (ai, ri + 1) if kind == "rec" else (ai + 1, ri)
    for t in range(rem):
        sp = params[f"tail{t}"]
        x = _hybrid_sub_decode(cfg, sp, "rec", x, cache, ai, ri, cache_len, live, ring)
        ri += 1
    return x


def _encdec_decode(cfg, params, cache, x, cache_len, live, seq):
    table = params["dec_pos"]
    x = x + table[(cache_len.long() % table.shape[0])][:, None, :].to(x.dtype)
    a_cfg = dataclasses.replace(cfg.attn_cfg, use_rope=False)
    x_cfg = dataclasses.replace(a_cfg, causal=False)
    enc_len = torch.full_like(cache_len, cfg.enc_seq - 1)
    for i in range(cfg.n_layers):
        bp = _block(params["dec_blocks"], i)
        z = _norm(cfg, bp["attn_norm"], x)
        kc, vc = cache["k"][i], cache["v"][i]
        x = x + _decode_attn(
            bp["attn"], a_cfg, z, kc, vc, cache_len, live, seq=seq.get("k")
        )
        z = _norm(cfg, bp["cross_norm"], x)
        # cross attention: query the (precomputed, frozen) encoder KV
        xk, xv = cache["cross_k"][i], cache["cross_v"][i]
        x = x + _decode_attn(
            bp["cross"], x_cfg, z, xk, xv, enc_len, update_cache=False,
            seq=seq.get("cross_k"),
        )
        x = x + L.mlp(bp["mlp"], _norm(cfg, bp["mlp_norm"], x), cfg.mlp_kind)
    return x
