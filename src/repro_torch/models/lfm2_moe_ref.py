"""Plain float32 reference of LFM2-MoE prefill (``model_type: lfm2_moe``).

The published model's equations in plain ``torch`` operations, float32
throughout with TF32 off (:func:`full_float32`): no kernel of the program,
no cache, no batching trick.  ``cfg`` is a published ``config.json`` as a
dict; ``params`` is the tree ``repro_torch.models.lfm2_moe.init_params``
draws, read one layer at a time and upcast to float32.

* RMSNorm: ``w * x * rsqrt(mean(x^2) + eps)``.
* Gated short convolution (``Lfm2ShortConv``): ``B, C, x = chunk3(in_proj
  h)``, ``out_proj(C * conv(B * x))``, the depthwise convolution causal
  over ``conv_L_cache`` positions, no biases.
* Attention (``Lfm2Attention``): q, k, v projections, RMSNorm over each
  query and key head, RoPE (rotate-half, ``rope_theta``), softmax of
  ``q k^T / sqrt(head_dim)`` causal within a prompt, each KV head shared by
  ``num_attention_heads / num_key_value_heads`` query heads, ``out_proj``.
* Dense SwiGLU (``Lfm2MLP``) in the first ``num_dense_layers`` layers:
  ``w2(silu(w1 h) * w3 h)``, ``intermediate_size`` taken as given.
* Routed experts after them: ``s = sigmoid(h W_r)``, the top
  ``num_experts_per_tok`` of ``s + expert_bias``, their ``s`` divided by
  their sum plus 1e-6 (``norm_topk_prob``) and times
  ``routed_scaling_factor``; each chosen expert's SwiGLU of width
  ``moe_intermediate_size``, weighted and summed; dropless.
* ``embedding_norm`` and the embedding as the tied output head.

Departures from the published model, all in what is computed with, not in
what is computed: the router's scores are float32 (the published code reads
them in the model's dtype); the routing above is read from the public
``lfm2_moe`` implementation (the dense ``lfm2`` sibling's code gives the
rest); weights are random (the program's).

Imports torch only.
"""

from __future__ import annotations

import contextlib
import math

import torch

NORM_EPS = 1e-6


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


def rope_theta(cfg: dict) -> float:
    theta = cfg.get("rope_parameters", {}).get("rope_theta", cfg.get("rope_theta"))
    return float(theta)


def upcast(p: dict) -> dict:
    """A layer's parameters in float32 (copies)."""
    return {k: v.float() for k, v in p.items()}


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def conv_op(p, cfg, x, prompts):
    """The gated short convolution on ``x`` (T, d) of ``prompts`` prompts."""
    T, d = x.shape
    S, L = T // prompts, cfg["conv_L_cache"]
    b, c, v = (x @ p["in_proj"]).chunk(3, dim=-1)
    bx = (b * v).view(prompts, S, d)
    conv = torch.zeros_like(bx)
    for j in range(L):
        shift = L - 1 - j  # tap j reads position t - shift
        conv[:, shift:] += p["conv"][j] * bx[:, : S - shift]
    return (c * conv.view(T, d)) @ p["out_proj"]


def _rope(x, theta):
    """Rotate-half RoPE on ``x`` (S, heads, hd) at positions 0..S-1."""
    S, hd = x.shape[0], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention_op(p, cfg, x, prompts):
    """Causal GQA within each prompt on ``x`` (T, d), one prompt and one KV
    head's query heads at a time."""
    T, d = x.shape
    S, H, KV = T // prompts, cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, eps, theta = d // H, cfg["norm_eps"], rope_theta(cfg)
    rep = H // KV
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    out = torch.empty(prompts, S, H, hd, dtype=x.dtype, device=x.device)
    for b in range(prompts):
        xb = x[b * S : (b + 1) * S]
        q = rms_norm((xb @ p["q_proj"]).view(S, H, hd), p["q_layernorm"], eps)
        k = rms_norm((xb @ p["k_proj"]).view(S, KV, hd), p["k_layernorm"], eps)
        q, k = _rope(q, theta), _rope(k, theta)
        v = (xb @ p["v_proj"]).view(S, KV, hd)
        for g in range(KV):
            qg = q[:, g * rep : (g + 1) * rep].transpose(0, 1)  # (rep, S, hd)
            s = qg @ k[:, g].t() / math.sqrt(hd)
            s = s.masked_fill(~causal, float("-inf")).softmax(-1)
            out[b, :, g * rep : (g + 1) * rep] = (s @ v[:, g]).transpose(0, 1)
    return out.view(T, d) @ p["out_proj"]


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
    """The routed experts on ``x`` (T, d); returns ``(out, experts)``."""
    gates, experts = route(p, cfg, x)
    f = cfg["moe_intermediate_size"]
    out = torch.zeros_like(x)
    for e in range(p["router"].shape[1]):
        tok, slot = (experts == e).nonzero(as_tuple=True)
        if tok.numel():
            gu = x[tok] @ p["gate_up"][e]
            y = (silu(gu[:, :f]) * gu[:, f:]) @ p["down"][e]
            out.index_add_(0, tok, y * gates[tok, slot, None])
    return out, experts


def op(p, cfg, layer, x, prompts):
    kind = cfg["layer_types"][layer]
    return (conv_op if kind == "conv" else attention_op)(p, cfg, x, prompts)


def ffn(p, cfg, layer, x):
    """``(out, experts)``; ``experts`` is None in a dense layer."""
    if layer < cfg["num_dense_layers"]:
        return dense_ffn(p, x), None
    return moe_ffn(p, cfg, x)


def logits(params, cfg, h_last):
    """The output head on each prompt's last hidden state (B, d) f32."""
    z = rms_norm(h_last, params["embedding_norm"].float(), cfg["norm_eps"])
    return z @ params["embed"].float().t()


def forward(params, cfg, ids):
    """The whole prefill of ``ids`` (B, S) in float32: the (B, vocab) logits
    of each prompt's last position, and each MoE layer's chosen experts."""
    B, S = ids.shape
    eps = cfg["norm_eps"]
    chosen = {}
    with full_float32():
        h = params["embed"].float()[ids.reshape(-1)]
        for i, lp in enumerate(params["layers"]):
            p = upcast(lp)
            h = h + op(p, cfg, i, rms_norm(h, p["operator_norm"], eps), B)
            f, experts = ffn(p, cfg, i, rms_norm(h, p["ffn_norm"], eps))
            if experts is not None:
                chosen[i] = experts
            h = h + f
        return logits(params, cfg, h.view(B, S, -1)[:, -1]), chosen
