"""The yardstick's arithmetic for an LFM2-MoE prefill round.

Useful FLOPs of one forward of ``prompts`` prompts of ``tokens`` tokens
(T = prompts x tokens rows), as ``2 T K N`` a projection:

* a conv layer: in_proj (d -> 3 d) and out_proj (d -> d);
* an attention layer: q, k, v, o, and the core: ``q k^T`` and ``p v`` over
  the causal half, ``2 x 2 x prompts x heads x head_dim x tokens (tokens +
  1) / 2``;
* a dense FFN: w1, w3 (d -> intermediate) and w2;
* a MoE layer: the router (d -> experts), and for the T x k token-slots
  gate‖up (d -> 2 f) and down (f -> d);
* the output head on each prompt's last position (d -> vocab).

Norms, the convolution, RoPE, softmax and routing are left out (they are
not FLOP-bound and add under 0.1 %).  An expert call's bound is
``roofline.call_bound_s`` over its tenants' routed shapes, experts with no
rows left out (their weights are never read).
"""

from __future__ import annotations

from cardbench import roofline


def round_flops(cfg: dict, prompts: int, tokens: int) -> dict:
    """FLOPs of one round, by part: ``conv``, ``attention`` (projections
    and core), ``attention_core``, ``dense_ffn``, ``moe``, ``head`` and
    ``total``."""
    T, d = prompts * tokens, cfg["hidden_size"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // H
    E, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    f, ff = cfg["moe_intermediate_size"], cfg["intermediate_size"]
    g = roofline.gemm_flops
    conv = g(T, d, 3 * d) + g(T, d, d)
    core = 2 * 2 * prompts * H * hd * tokens * (tokens + 1) // 2
    attn = 2 * g(T, d, d) + 2 * g(T, d, KV * hd) + core
    dense = 2 * g(T, d, ff) + g(T, ff, d)
    moe = g(T, d, E) + g(T * k, d, 2 * f) + g(T * k, f, d)
    kinds = cfg["layer_types"]
    n_conv = kinds.count("conv")
    n_attn = len(kinds) - n_conv
    n_dense = cfg["num_dense_layers"]
    parts = {
        "conv": n_conv * conv,
        "attention": n_attn * attn,
        "attention_core": n_attn * core,
        "dense_ffn": n_dense * dense,
        "moe": (len(kinds) - n_dense) * moe,
        "head": g(prompts, d, cfg["vocab_size"]),
    }
    parts["total"] = sum(v for key, v in parts.items() if key != "attention_core")
    return parts


def expert_calls(counts, d: int, f: int) -> tuple[list, list]:
    """A MoE layer's two expert calls as ``(T, K, N)`` tenant shapes, from
    its rows per expert: gate‖up and down, empty experts left out."""
    rows = [n for n in counts if n > 0]
    return [(n, d, 2 * f) for n in rows], [(n, f, d) for n in rows]


def experts_bound_s(routed, d: int, f: int, dtype: str = "bfloat16") -> float:
    """The least seconds the card needs for the expert calls of the layers
    whose rows per expert ``routed`` lists."""
    total = 0.0
    for counts in routed:
        for shapes in expert_calls(counts, d, f):
            total += roofline.call_bound_s(shapes, dtype)
    return total
