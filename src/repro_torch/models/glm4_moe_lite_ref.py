"""Plain float32 reference of GLM-4.7-Flash prefill (``model_type: glm4_moe_lite``).

The published model's equations in plain ``torch`` operations, float32
throughout with TF32 off (:func:`full_float32`): no kernel of the program,
no cache, no batching trick.  ``cfg`` is a published ``config.json`` as a
dict; ``params`` is the tree ``repro_torch.models.glm4_moe_lite.init_params``
draws, read one layer at a time and upcast to float32.  The equations are
those of ``DeepseekV3Attention``, ``DeepseekV3MoE`` and ``DeepseekV3MLP``
(the published ``glm4_moe_lite`` is their layer):

* RMSNorm: ``w * x * rsqrt(mean(x^2) + eps)``.
* Multi-head latent attention: ``q = q_b(RMSNorm(q_a h))``, each head
  ``qk_nope_head_dim`` columns then ``qk_rope_head_dim``;
  ``kv_a_proj_with_mqa h`` gives a ``kv_lora_rank`` latent and one
  ``k_pe``; ``kv_b(RMSNorm(latent))`` gives each head's ``k_nope`` and
  ``v``; RoPE (rotate-half, ``rope_theta``) on q's rope columns and on
  ``k_pe``, which every head shares; softmax of ``q k^T`` over
  ``qk_nope_head_dim + qk_rope_head_dim`` columns times that width^-0.5,
  causal within a prompt; ``o_proj``.
* Dense SwiGLU ``w2(silu(w1 h) * w3 h)`` in the first
  ``first_k_dense_replace`` layers.
* Routed experts after them: ``s = sigmoid(h W_r)``, the top
  ``num_experts_per_tok`` of ``s + expert_bias`` (``noaux_tc`` with one
  group is the plain top-k), their ``s`` divided by their sum (plus 1e-6,
  ``norm_topk_prob``) and times ``routed_scaling_factor``; each chosen
  expert's SwiGLU of width ``moe_intermediate_size``, weighted and summed;
  dropless.  Plus the shared expert's SwiGLU (width ``moe_intermediate_size
  x n_shared_experts``) on every token, unweighted.
* The final ``norm`` and the untied ``lm_head`` on each prompt's last
  position.

Departures from the published model, all in what is computed with, not in
what is computed: the router's scores are float32 (as published); the
normalising sum adds 1e-6 where ``DeepseekV3TopkRouter`` adds 1e-20 (the
program's ``routed_experts.NORM_EPS``; on a sum of four sigmoids, at least
a few tenths, the gates move by under 1e-5 of themselves); the RoPE columns are taken as lying
de-interleaved (checkpoints store them interleaved and ``transformers``
reorders them: a fixed permutation of random projection columns); the core
is worked out in blocks of ``BLOCK_ROWS`` query rows, so that a long
prompt's scores fit; weights are random (the program's).  The
multi-token-prediction layer is not held or run: a prefill never reads it.

Imports torch only.
"""

from __future__ import annotations

import contextlib

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
