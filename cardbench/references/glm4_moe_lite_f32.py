"""Plain float32 reference of a GLM-4.7-Flash prefill round, and the check.

The model's equations are a frozen copy of
``src/repro_torch/models/glm4_moe_lite_ref.py`` (held equal to it by the
benchmark's tests), so that no change to the program moves the yardstick:
plain ``torch`` operations in float32 with TF32 off, no kernel of the
program, no cache, no batching trick.  Published equations and departures:
that file's docstring.

The check (:func:`worst_gap`) is teacher-forced: every layer is worked out
again from the program's own input to it, which the checked round kept, its
weights upcast to float32 one layer at a time.  It reads three numbers:

* ``max_rel_err``: the worst, over layers, over what each layer's attention
  and ffn added to the residual stream and over the stream after the layer,
  and over token rows, of ``max |out - ref| / max |ref|`` along the row;
  in MoE layers only over the tokens whose top-k set of experts is the
  reference's.  A row is its own scale, so that a fault that moves late
  tokens' small rows is not hidden under larger ones.  A missing,
  misshapen or non-finite output reads infinite.
* ``route_mismatch``: the share of (token, MoE layer) pairs whose top-k set
  differs from the reference's.
* ``logit_rel_err``: the same row gap of each prompt's last-position logits
  against the reference's from the program's final hidden state.

The control (:func:`control`) stands in the program's place as the GEMM:
every product from operands rounded to float8 e4m3, the precision below the
configuration's bfloat16.

Imports torch only: nothing of the program.
"""

from __future__ import annotations

import contextlib
import math

import torch

NORM_EPS = 1e-6
# query rows a block of the attention core: 20 heads x 512 rows x 16384
# keys of float32 scores is 0.67 GB
BLOCK_ROWS = 512


@contextlib.contextmanager
def full_float32():
    """float32 matmuls in full float32: TF32 off for the block."""
    cuda = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def upcast(p: dict) -> dict:
    """A layer's parameters in float32 (copies)."""
    return {k: v.float() for k, v in p.items()}


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(x, theta):
    """Rotate-half RoPE on ``x`` (S, heads, hd) at positions 0..S-1."""
    S, hd = x.shape[0], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mla_op(p, cfg, x, prompts):
    """Causal multi-head latent attention within each prompt on ``x``
    (T, d), one prompt and ``BLOCK_ROWS`` query rows at a time."""
    T, d = x.shape
    S, H = T // prompts, cfg["num_attention_heads"]
    nope, rd, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    r, eps, theta = cfg["kv_lora_rank"], cfg["rms_norm_eps"], float(cfg["rope_theta"])
    scale = (nope + rd) ** -0.5
    out = torch.empty(prompts, S, H, vd, dtype=x.dtype, device=x.device)
    for b in range(prompts):
        xb = x[b * S : (b + 1) * S]
        q = rms_norm(xb @ p["q_a_proj"], p["q_a_layernorm"], eps) @ p["q_b_proj"]
        q = q.view(S, H, nope + rd)
        kv_a = xb @ p["kv_a_proj_with_mqa"]
        kv = rms_norm(kv_a[:, :r], p["kv_a_layernorm"], eps) @ p["kv_b_proj"]
        kv = kv.view(S, H, nope + vd)
        k_pe = _rope(kv_a[:, None, r:], theta).expand(S, H, rd)
        q = torch.cat([q[..., :nope], _rope(q[..., nope:], theta)], dim=-1)
        k = torch.cat([kv[..., :nope], k_pe], dim=-1)
        q, k, v = (t.transpose(0, 1) for t in (q, k, kv[..., nope:]))  # (H, S, .)
        for a in range(0, S, BLOCK_ROWS):
            e = min(S, a + BLOCK_ROWS)
            s = (q[:, a:e] @ k[:, :e].transpose(1, 2)).mul_(scale)
            rows = torch.arange(a, e, device=x.device)[:, None]
            seen = torch.arange(e, device=x.device)[None, :] <= rows
            s = s.masked_fill_(~seen, float("-inf")).softmax(-1)
            out[b, a:e] = (s @ v[:, :e]).transpose(0, 1)
    return out.view(T, H * vd) @ p["o_proj"]


def silu(x):
    return x * torch.sigmoid(x)


def dense_ffn(p, x):
    return (silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]


def route(p, cfg, x):
    """``(gates, experts)``, each (T, k)."""
    s = torch.sigmoid(x @ p["router"])
    k = cfg["num_experts_per_tok"]
    experts = torch.topk(s + p["expert_bias"], k, dim=-1).indices
    gates = s.gather(-1, experts)
    if cfg.get("norm_topk_prob", True):
        gates = gates / (gates.sum(-1, keepdim=True) + NORM_EPS)
    return gates * cfg.get("routed_scaling_factor", 1.0), experts


def moe_ffn(p, cfg, x):
    """The routed experts and the shared one on ``x`` (T, d); returns
    ``(out, experts)``."""
    gates, experts = route(p, cfg, x)
    f = cfg["moe_intermediate_size"]
    out = torch.zeros_like(x)
    for e in range(p["router"].shape[1]):
        tok, slot = (experts == e).nonzero(as_tuple=True)
        if tok.numel():
            gu = x[tok] @ p["gate_up"][e]
            y = (silu(gu[:, :f]) * gu[:, f:]) @ p["down"][e]
            out.index_add_(0, tok, y * gates[tok, slot, None])
    if "shared_gate_up" in p:
        fs = p["shared_down"].shape[0]
        gu = x @ p["shared_gate_up"]
        out = out + (silu(gu[:, :fs]) * gu[:, fs:]) @ p["shared_down"]
    return out, experts


def op(p, cfg, layer, x, prompts):
    return mla_op(p, cfg, x, prompts)


def ffn(p, cfg, layer, x):
    """``(out, experts)``; ``experts`` is None in a dense layer."""
    if layer < cfg["first_k_dense_replace"]:
        return dense_ffn(p, x), None
    return moe_ffn(p, cfg, x)


def logits(params, cfg, h_last):
    """The output head on each prompt's last hidden state (B, d) f32."""
    z = rms_norm(h_last, params["norm"].float(), cfg["rms_norm_eps"])
    return z @ params["lm_head"].float()


def forward(params, cfg, ids):
    """The whole prefill of ``ids`` (B, S) in float32: the (B, vocab) logits
    of each prompt's last position, and each MoE layer's chosen experts."""
    B, S = ids.shape
    eps = cfg["rms_norm_eps"]
    chosen = {}
    with full_float32():
        h = params["embed"].float()[ids.reshape(-1)]
        for i, lp in enumerate(params["layers"]):
            p = upcast(lp)
            h = h + op(p, cfg, i, rms_norm(h, p["input_layernorm"], eps), B)
            f, experts = ffn(p, cfg, i, rms_norm(h, p["post_attention_layernorm"], eps))
            if experts is not None:
                chosen[i] = experts
            h = h + f
        return logits(params, cfg, h.view(B, S, -1)[:, -1]), chosen


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

# the limits, each set on the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md §2)
# near the geometric mean of the program's largest reading over 22 seeds
# and the float8 control's smallest over 3, so with room on both sides:
# max_rel_err 0.0121 and 0.159 (the bfloat16 roundings between ops against
# float8's 3-bit mantissa; every planted fault read 0.139 or more),
# route_mismatch 0.0072 and 0.166 (top-4 sets that flip on the router
# input's bfloat16 rounding), logit_rel_err 0.0021 and 0.037; LFM2's
# limits, which the same readings set there
LIMITS = {"max_rel_err": 4e-2, "route_mismatch": 3e-2, "logit_rel_err": 1e-2}

# elements of a control block (rows x N, float32)
BLOCK_ELEMS = 1 << 26


def row_gap(out, ref: torch.Tensor) -> float:
    """The worst over rows of ``max |out - ref| / max |ref|`` along the
    row; ``inf`` where ``out`` is not a tensor of ``ref``'s shape or holds a
    value that is not finite."""
    if not isinstance(out, torch.Tensor) or tuple(out.shape) != tuple(ref.shape):
        return math.inf
    if ref.numel() == 0:
        return 0.0
    diff = (out.to(device=ref.device, dtype=torch.float32) - ref).abs().amax(-1)
    if not bool(torch.isfinite(diff).all()):
        return math.inf
    scale = ref.abs().amax(-1)
    zero = torch.where(diff > 0, math.inf, 0.0)
    return torch.where(scale > 0, diff / scale, zero).max().item()


def _layer_gaps(p, cfg, layer, kept, prompts):
    """The three row gaps of one layer and its ``(mismatched, pairs)``."""
    eps = cfg["rms_norm_eps"]
    h_in, a, f, h_out = (
        kept["hidden"][layer], kept["op"][layer], kept["ffn"][layer],
        kept["hidden"][layer + 1],
    )
    if not all(isinstance(t, torch.Tensor) for t in (h_in, a, f, h_out)):
        return [math.inf] * 3, 0, 0
    x = rms_norm(h_in.float(), p["input_layernorm"], eps)
    a_ref = op(p, cfg, layer, x, prompts)
    gaps = [row_gap(a, a_ref)]
    if gaps[0] == math.inf:
        return [math.inf] * 3, 0, 0
    # the ffn's input is the program's own sum, in its own dtype
    h_mid = (h_in + a).float()
    f_ref, experts = ffn(p, cfg, layer, rms_norm(h_mid, p["post_attention_layernorm"], eps))
    rows = torch.ones(h_mid.shape[0], dtype=torch.bool, device=h_mid.device)
    mismatched = pairs = 0
    if experts is not None:
        mine = kept["experts"].get(layer)
        pairs = experts.shape[0]
        if not isinstance(mine, torch.Tensor) or mine.shape != experts.shape:
            return gaps + [math.inf] * 2, pairs, pairs
        mine = mine.to(experts.device).sort(-1).values
        rows = (mine == experts.sort(-1).values).all(-1)
        mismatched = int((~rows).sum())
    if not isinstance(f, torch.Tensor) or f.shape != f_ref.shape:
        return gaps + [math.inf] * 2, mismatched, pairs
    gaps.append(row_gap(f[rows], f_ref[rows]))
    if isinstance(h_out, torch.Tensor) and h_out.shape == h_mid.shape:
        gaps.append(row_gap(h_out[rows], (h_mid + f_ref)[rows]))
    else:
        gaps.append(math.inf)
    return gaps, mismatched, pairs


def worst_gap(params, cfg, kept, logits_out, prompts):
    """The check of one round: ``kept`` is what ``prefill(..., keep=)``
    gave (``hidden``, ``op``, ``ffn``, ``experts``) and ``logits_out`` its
    logits.  Returns ``(checks, compared, over)``: the three numbers, the
    tensors compared and those over their limit."""
    n = cfg["num_hidden_layers"]
    worst, compared, over = 0.0, 0, 0
    mismatched = pairs = 0
    with full_float32():
        for layer in range(n):
            try:
                _ = (kept["hidden"][layer + 1], kept["op"][layer], kept["ffn"][layer])
            except (KeyError, IndexError, TypeError):
                gaps, m, q = [math.inf] * 3, 0, 0
            else:
                p = upcast(params["layers"][layer])
                gaps, m, q = _layer_gaps(p, cfg, layer, kept, prompts)
            compared += len(gaps)
            over += sum(not g <= LIMITS["max_rel_err"] for g in gaps)
            worst = max(worst, *gaps)
            mismatched, pairs = mismatched + m, pairs + q
        try:
            h = kept["hidden"][n].float()
            last = h.view(prompts, -1, h.shape[-1])
            logit = row_gap(logits_out, logits(params, cfg, last[:, -1]))
        except (KeyError, IndexError, TypeError, RuntimeError, AttributeError):
            logit = math.inf
    route = mismatched / pairs if pairs else 0.0
    compared += 1
    over += not logit <= LIMITS["logit_rel_err"]
    over += not route <= LIMITS["route_mismatch"]
    checks = {"max_rel_err": worst, "route_mismatch": route, "logit_rel_err": logit}
    return checks, compared, over


def _fp8(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float8_e4m3fn).float()


def control(xs, ws, **_kw) -> list[torch.Tensor]:
    """The control, in the program's place as its GEMM: every tenant's
    ``x @ w`` from operands rounded to float8 e4m3, float32 products, TF32
    off."""
    outs = []
    with full_float32():
        for x, w in zip(xs, ws):
            t, n = x.shape[0], w.shape[1]
            out = torch.empty((t, n), dtype=torch.float32, device=x.device)
            w8 = _fp8(w)
            step = max(1, min(t, BLOCK_ELEMS // max(n, 1)))
            for a in range(0, t, step):
                out[a : a + step] = _fp8(x[a : a + step]) @ w8
            outs.append(out)
    return outs
