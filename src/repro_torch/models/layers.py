"""Shared neural layers of the five model families, in plain PyTorch.

Counterpart of ``repro.models.layers``.  Parameters are nested dicts of
tensors in the JAX package's layout — weights ``(in, out)``, so a
projection is ``x @ w`` — so ``models.convert`` carries a JAX parameter
tree across unchanged.  Compute dtype is bf16, normalisation, rotary
embedding and softmax in f32, as in the JAX package.

Full-sequence attention (training, prefill) is **chunked**: an online
softmax over KV blocks, chunk for chunk as the JAX package computes it, so
no (S × S) score tensor is ever held; each chunk's body is rematerialised
under autograd (``remat``), as ``jax.checkpoint`` does there.

Initialisers take ``gen``: a ``torch.Generator`` (the tensors are drawn on
its device), or the meta device, which gives every shape and dtype and
allocates nothing (``param_count``, ``configs.params_spec``).  ``lead`` is
the stacked leading axes (layers, experts).  Every finished leaf passes
through :func:`leaf`, where :func:`on_each_leaf` may place it before the
next is drawn.  Where the hook has a ``draw`` (``training.train_loop
.init_params_sharded``), :func:`normal` and :func:`full` hand it the
leaf's shape and a fill instead, and only this rank's shard is allocated:
:func:`normal` draws the whole leaf's row blocks in their order and keeps
the part of each that falls in the shard, so the shard holds the numbers
of the whole draw.

Tensor parallelism: a layer whose params dict is a
``distributed.sharding.SplitParams`` computes its share of the work along
"model" (``.tp``), each closed by one ``reduce_from_model``; its input
enters through ``copy_to_model``.  The MLP computes on its ff columns.
Full-sequence attention computes this rank's run of whole heads
(:func:`head_run`, none on some ranks where the heads are fewer than the
width): the rank's slices of ``wq``, ``wk``, ``wv`` by column and ``wo``
by row where the width divides the heads, else its heads' columns and
rows read from the leaves gathered whole.  The decode step
(``models.model``) projects the new token on the placed columns of
``wq``, ``wk`` and ``wv``, a fraction of a head included, joins the
columns over "model" (one all-gather) before rope, and closes with
``wo``'s placed rows.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.collectives import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
)

Params = dict[str, Any]

DEFAULT_ATTN_CHUNK = 512

# f32 elements drawn at once: a stacked weight is drawn a block of rows at a
# time, so the f32 temporary stays at 256 MiB whatever its leading axes
_DRAW_ELEMS = 1 << 26


# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------

_ON_LEAF: contextvars.ContextVar = contextvars.ContextVar("on_leaf", default=None)


@contextlib.contextmanager
def on_each_leaf(fn: Callable[[torch.Tensor], Any]):
    """Inside the block every initialiser hands each leaf it finishes to
    ``fn`` and returns what ``fn`` returns, one leaf after the other in
    the order they are drawn."""
    token = _ON_LEAF.set(fn)
    try:
        yield
    finally:
        _ON_LEAF.reset(token)


def leaf(t: torch.Tensor):
    """A finished parameter leaf, as :func:`on_each_leaf`'s hook makes it."""
    fn = _ON_LEAF.get()
    return t if fn is None else fn(t)


def _init_device(gen) -> torch.device:
    """The device an initialiser's ``gen`` draws on."""
    return gen.device if isinstance(gen, torch.Generator) else torch.device(gen)


def _make(gen, shape: tuple[int, ...], dtype, fill) -> torch.Tensor:
    """A finished ``shape`` leaf of ``dtype`` on ``gen``'s device, written
    by ``fill(out, box)`` (``out`` holds the part ``box``, a slice a dim, of
    the leaf): the whole leaf, or only this rank's shard where the hook of
    :func:`on_each_leaf` draws by shard."""
    dev = _init_device(gen)
    hook = _ON_LEAF.get()
    if dev.type != "meta" and hasattr(hook, "draw"):
        return hook.draw(shape, dtype, fill)
    out = torch.empty(shape, dtype=dtype, device=dev)
    if dev.type != "meta":
        fill(out, tuple(slice(0, n) for n in shape))
    return leaf(out)


def _row_runs(shape: tuple[int, ...], box: tuple[slice, ...]) -> list[tuple]:
    """The rows of a ``shape`` tensor seen as ``(-1, shape[-1])`` that
    ``box`` meets, as runs of consecutive rows in order: (first row, rows,
    first row of the box's own rows)."""
    lead, cut = shape[:-1], box[:-1]
    cuts = [d for d, c in enumerate(cut) if (c.start, c.stop) != (0, lead[d])]
    if not cuts:
        return [(0, math.prod(lead), 0)]
    k = cuts[-1]  # the innermost cut dim: a run spans its slice and what is inside
    inner = math.prod(lead[k + 1 :])
    rows = (cut[k].stop - cut[k].start) * inner
    runs = []
    for idx in itertools.product(*(range(c.start, c.stop) for c in cut[:k])):
        flat = 0
        for d, i in enumerate(idx):
            flat = flat * lead[d] + i
        runs.append(((flat * lead[k] + cut[k].start) * inner, rows, len(runs) * rows))
    return runs


def normal(gen, shape: tuple[int, ...], scale: float = 1.0, dtype=torch.bfloat16):
    """``shape`` ~ N(0, scale²), drawn in f32 and stored as ``dtype``: a
    block of at most ``_DRAW_ELEMS`` rows' elements at a time (one row
    where a row is longer), each block whole; the part of a block that the
    leaf's allocated box holds is scaled and copied into it."""
    dev = _init_device(gen)
    last, n_rows = shape[-1], math.prod(shape[:-1])
    step = max(1, _DRAW_ELEMS // last)

    def fill(out: torch.Tensor, box: tuple[slice, ...]) -> None:
        dst, cols = out.view(-1, out.shape[-1]), box[-1]
        runs = _row_runs(shape, box)
        i = 0
        for r in range(0, n_rows, step):
            n = min(step, n_rows - r)
            draw = torch.randn(
                (n, last), generator=gen, device=dev, dtype=torch.float32
            )
            while i < len(runs) and runs[i][0] + runs[i][1] <= r:
                i += 1
            for start, rows, at in itertools.takewhile(
                lambda run: run[0] < r + n, itertools.islice(runs, i, None)
            ):
                a, b = max(start, r), min(start + rows, r + n)
                # no name for the view: it would hold this block beside the next
                dst[at + a - start : at + b - start].copy_(
                    draw[a - r : b - r, cols].mul_(scale)
                )
            del draw

    return _make(gen, shape, dtype, fill)


def uniform(gen, shape: tuple[int, ...], low: float, high: float) -> torch.Tensor:
    """``shape`` ~ U[low, high) in f32 (drawn whole, not yet a leaf: see
    ``models.rglru.init_rglru``)."""
    dev = _init_device(gen)
    if dev.type == "meta":
        return torch.empty(shape, device=dev)
    u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
    return u.mul_(high - low).add_(low)


def full(gen, shape: tuple[int, ...], value: float) -> torch.Tensor:
    """An f32 constant of ``shape`` (norm scales, biases)."""
    return _make(gen, shape, torch.float32, lambda out, box: out.fill_(value))


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
# attention (GQA, chunked online softmax, causal / local / bidirectional)
# ---------------------------------------------------------------------------


def remat(fn, *args):
    """``fn(*args)``, rematerialised in the backward pass when autograd is
    recording (``jax.checkpoint``): only the inputs are saved, and ``fn``
    runs again to rebuild what its backward needs."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


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
    chunk: int = DEFAULT_ATTN_CHUNK  # KV-block size for the online softmax
    q_chunks: int = 1  # Q blocks: >1 scans each only over the KV chunks it
    #   can see (causal lower triangle / local window), from static bounds

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


def _project_q(p: Params, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor):
    """The query projection alone: cross attention takes its keys and
    values from elsewhere (in the JAX package XLA drops the unused ones)."""
    B, S, _ = x.shape
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
    return q


def _project_qkv(p: Params, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor):
    B, S, _ = x.shape
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.use_rope:
        k = rope(k, positions, cfg.rope_theta)
    return _project_q(p, cfg, x, positions), k, v


def project_on_columns(
    p: Params, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor, tp, kv=True
) -> list:
    """The decode step's q (and k, v) of every head, rope applied.  Where
    ``p`` is lent split over "model" (``tp``), each projection is computed
    on this rank's placed columns where its weight is split (a fraction of
    a head included), whole where it is not, and the split ones are joined
    over "model" by one all-gather, in rank order, before rope."""
    B, S, _ = x.shape
    names = ("q", "k", "v") if kv else ("q",)
    outs = []
    for n in names:
        t = x @ p[f"w{n}"]
        if cfg.qkv_bias:
            t = t + p[f"b{n}"].to(t.dtype)
        outs.append(t)
    heads = [cfg.n_heads if n == "q" else cfg.n_kv_heads for n in names]
    mine = [t.shape[-1] != h * cfg.head_dim for t, h in zip(outs, heads)]
    if any(mine):
        split = [t for t, m in zip(outs, mine) if m]
        every = gather_from_model(torch.cat(split, dim=-1), -1, tp)
        widths = [t.shape[-1] for t in split]
        every = every.unflatten(-1, (tp.size, -1)).split(widths, -1)
        joined = iter(t.flatten(-2) for t in every)
        outs = [next(joined) if m else t for t, m in zip(outs, mine)]
    outs = [t.reshape(B, S, h, cfg.head_dim) for t, h in zip(outs, heads)]
    if cfg.use_rope:
        outs[:2] = [rope(t, positions, cfg.rope_theta) for t in outs[:2]]
    return outs


def _online_update(carry, s, vb):
    """Fold one KV chunk's f32 scores ``s`` (B, H, Sq, c) and values ``vb``
    (B, c, H, D) into the running max, sum and output."""
    m, lsum, acc = carry
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p_blk = torch.exp(s - m_new[..., None])
    l_new = lsum * alpha + p_blk.sum(dim=-1)
    # the PV product takes bf16 operands and gives bf16, cast to f32 after
    bf16 = torch.bfloat16
    pv = torch.einsum("bhqk,bkhd->bhqd", p_blk.to(bf16), vb.to(bf16))
    return m_new, l_new, acc * alpha[..., None] + pv.float()


def _chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    causal: bool,
    window: int | None,
    chunk: int,
    q_chunks: int = 1,
) -> torch.Tensor:
    """Flash-style attention: a loop over KV chunks with online softmax.

    q: (B, Sq, H, D); k/v: (B, Sk, KV, D); positions (B, S).  Never holds
    (Sq × Sk); the extra memory is (B, H, Sq/q_chunks, chunk).  With
    ``q_chunks > 1`` (causal, Sq == Sk, Sq divisible) each Q block scans only
    the KV chunks it can see, and the chunks wholly below its first position
    skip the mask: the bounds are static, as in the JAX package.
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV if KV else 1  # no heads on this rank: empty tensors
    scale = 1.0 / math.sqrt(D)
    n_chunks = -(-Sk // chunk)
    pad = n_chunks * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
    kc = k.reshape(B, n_chunks, chunk, KV, D)
    vc = v.reshape(B, n_chunks, chunk, KV, D)
    pc = kv_pos.reshape(B, n_chunks, chunk)

    def scores(qf, kb):
        kb = torch.repeat_interleave(kb, rep, dim=2)  # (B, c, H, D)
        return torch.einsum("bqhd,bkhd->bhqk", qf, kb.float())

    def values(vb):
        return torch.repeat_interleave(vb, rep, dim=2)

    def body(qf, qp, m, lsum, acc, kb, vb, pb):
        s = scores(qf, kb)
        mask = (pb >= 0)[:, None, None, :]
        if causal:
            mask = mask & (pb[:, None, None, :] <= qp[:, None, :, None])
        if window is not None:
            mask = mask & (pb[:, None, None, :] > qp[:, None, :, None] - window)
        s = torch.where(mask, s, -1e30)
        return _online_update((m, lsum, acc), s, values(vb))

    def body_nomask(qf, qp, m, lsum, acc, kb, vb, pb):
        # chunks wholly below this Q block's start are fully visible under
        # the causal mask: no mask at all
        return _online_update((m, lsum, acc), scores(qf, kb), values(vb))

    def run_block(qf, qp, q_start, q_end):
        """Online softmax of one Q block over its visible KV chunks."""
        Sq_b = qf.shape[1]
        m = torch.full((B, H, Sq_b), -1e30, dtype=torch.float32, device=q.device)
        lsum = torch.zeros((B, H, Sq_b), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, Sq_b, D), dtype=torch.float32, device=q.device)
        # static visibility: causal -> KV chunks past this block's last
        # position never contribute; window -> chunks before the window's
        # start never do (identity row -> position layout: training/prefill)
        lo_c, hi_c, diag_c = 0, n_chunks, 0
        if causal and Sq == Sk and q_chunks > 1:
            hi_c = min(n_chunks, -(-q_end // chunk))
            if window is None and pad == 0:
                diag_c = max(lo_c, q_start // chunk)  # [lo_c, diag_c) unmasked
            elif window is not None:
                lo_c = max(0, (q_start - window) // chunk)
        for c in range(lo_c, hi_c):
            fn = body_nomask if c < diag_c else body
            blk = (kc[:, c], vc[:, c], pc[:, c])
            m, lsum, acc = remat(fn, qf, qp, m, lsum, acc, *blk)
        out = acc / torch.clamp_min(lsum, 1e-30)[..., None]
        return out.transpose(1, 2).to(q.dtype)  # (B, Sq_b, H, D)

    qf_all = (q * scale).float()
    if q_chunks <= 1 or Sq % q_chunks or Sq != Sk:
        return run_block(qf_all, q_pos, 0, Sk)
    qb = Sq // q_chunks
    outs = []
    for i in range(q_chunks):
        rows = slice(i * qb, (i + 1) * qb)
        outs.append(run_block(qf_all[:, rows], q_pos[:, rows], i * qb, (i + 1) * qb))
    return torch.cat(outs, dim=1)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def head_run(n: int, tp) -> tuple[int, int]:
    """This rank's contiguous run of ``n`` heads along "model": from
    ⌊r·n/w⌋ to ⌊(r+1)·n/w⌋ for rank ``r`` of width ``w`` (the rank's slice
    where ``w`` divides ``n``; empty on some ranks where ``n < w``)."""
    return tp.rank * n // tp.size, (tp.rank + 1) * n // tp.size


def _rank_heads(p: Params, cfg: AttnConfig, tp) -> tuple[Params, AttnConfig]:
    """The params and config of this rank's run of query heads
    (:func:`head_run`) and the kv heads they read.  A leaf split over
    "model" holds them already (the width divides the heads, and the kv
    heads where ``wk`` is split); a leaf lent whole is read in parts: the
    run's columns of ``wq``, ``bq`` and rows of ``wo``, and the columns of
    ``wk``, ``wv``, ``bk``, ``bv`` of the kv heads the run reads — query
    head ``h`` reads kv head ``h // rep`` — each once where the run's heads
    share them evenly, else once for every query head."""
    h0, h1 = head_run(cfg.n_heads, tp)
    D = cfg.head_dim
    part = dict(p)
    if p["wq"].shape[-1] == cfg.q_dim:
        cols = slice(h0 * D, h1 * D)
        part["wq"], part["wo"] = p["wq"][..., cols], p["wo"][..., cols, :]
        if "bq" in p:
            part["bq"] = p["bq"][..., cols]
    n_kv = p["wk"].shape[-1] // D
    if p["wk"].shape[-1] == cfg.kv_dim:
        rep = cfg.n_heads // cfg.n_kv_heads
        reads = [h // rep for h in range(h0, h1)]
        kv = sorted(set(reads))
        even = [k for k in kv for _ in range(len(reads) // max(len(kv), 1))]
        if reads != even:
            kv = reads
        idx = torch.tensor(
            [k * D + d for k in kv for d in range(D)],
            dtype=torch.long,
            device=p["wk"].device,
        )
        for name in ("wk", "wv", "bk", "bv"):
            if name in p:
                part[name] = p[name].index_select(-1, idx)
        n_kv = len(kv)
    return part, dataclasses.replace(cfg, n_heads=h1 - h0, n_kv_heads=n_kv)


def attention(
    p: Params, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor | None = None
) -> torch.Tensor:
    """Self-attention over a full sequence (training / prefill); on this
    rank's run of heads where ``p`` is lent split over "model"."""
    B, S, _ = x.shape
    if positions is None:
        positions = _positions(B, S, x.device)
    tp = getattr(p, "tp", None)
    if tp is not None:
        p, cfg = _rank_heads(p, cfg, tp)
        x = copy_to_model(x, tp)
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _chunked_attention(
        q, k, v, positions, positions, cfg.causal, cfg.window, cfg.chunk, cfg.q_chunks
    )
    out = out.reshape(B, S, cfg.q_dim) @ p["wo"]
    return out if tp is None else reduce_from_model(out, tp)


def cross_attention(
    p: Params, cfg: AttnConfig, x: torch.Tensor, kv: torch.Tensor
) -> torch.Tensor:
    """Encoder-decoder cross attention (no RoPE on the kv side); on this
    rank's run of heads where ``p`` is lent split over "model"."""
    B, S, _ = x.shape
    Sk = kv.shape[1]
    tp = getattr(p, "tp", None)
    if tp is not None:
        p, cfg = _rank_heads(p, cfg, tp)
        x, kv = copy_to_model(x, tp), copy_to_model(kv, tp)
    pos_q = _positions(B, S, x.device)
    pos_k = _positions(B, Sk, x.device)
    cfg_nc = dataclasses.replace(cfg, causal=False, window=None, use_rope=False)
    q = _project_q(p, cfg_nc, x, pos_q)
    kv_shape = (B, Sk, cfg.n_kv_heads, cfg.head_dim)
    k = (kv @ p["wk"]).reshape(kv_shape)
    v = (kv @ p["wv"]).reshape(kv_shape)
    if cfg.qkv_bias:
        k = k + p["bk"].to(k.dtype).reshape(kv_shape[2:])
        v = v + p["bv"].to(v.dtype).reshape(kv_shape[2:])
    out = _chunked_attention(q, k, v, pos_q, pos_k, False, None, cfg.chunk)
    out = out.reshape(B, S, cfg.q_dim) @ p["wo"]
    return out if tp is None else reduce_from_model(out, tp)


def decode_attention(
    p: Params,
    cfg: AttnConfig,
    x: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
):
    """Single-token decode against a (B, S_max, KV, D) cache, through the
    chunked attention.

    Returns (out, new_k_cache, new_v_cache); the caches passed in are not
    written.  ``cache_len``: (B,) ints — the number of valid entries; the
    new token is written at that index.
    """
    B, S1, _ = x.shape
    if S1 != 1:
        raise ValueError("decode_attention expects a single new token")
    pos = cache_len[:, None].to(torch.int32)  # (B, 1)
    q, k, v = _project_qkv(p, cfg, x, pos)
    rows = torch.arange(B, device=x.device)
    idx = cache_len.long()
    k_cache = k_cache.index_put((rows, idx), k[:, 0].to(k_cache.dtype))
    v_cache = v_cache.index_put((rows, idx), v[:, 0].to(v_cache.dtype))
    kv_pos = _positions(B, k_cache.shape[1], x.device)
    # entries beyond cache_len are masked by the causal predicate
    out = _chunked_attention(
        q, k_cache, v_cache, pos, kv_pos, True, cfg.window, cfg.chunk
    )
    return out.reshape(B, 1, cfg.q_dim) @ p["wo"], k_cache, v_cache


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
    """The MLP; on this rank's ff columns where ``p`` is split over
    "model" (``gate`` and ``up`` by column, ``down`` by row)."""
    tp = getattr(p, "tp", None)
    if tp is not None:
        x = copy_to_model(x, tp)
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
    out = h @ p["down"]
    return out if tp is None else reduce_from_model(out, tp)


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
