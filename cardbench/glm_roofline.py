"""The yardstick's arithmetic for a GLM-4.7-Flash prefill round.

Useful FLOPs of one forward of ``prompts`` prompts of ``tokens`` tokens
(T = prompts x tokens rows), as ``2 T K N`` a projection:

* every layer's multi-head latent attention: its five projections
  (:func:`mla_projections`: q_a, kv_a, q_b, kv_b, o) and the core, ``q k^T``
  over ``qk_nope_head_dim + qk_rope_head_dim`` columns and ``p v`` over
  ``v_head_dim``, on the causal half: ``2 x prompts x heads x (qk + v) x
  tokens (tokens + 1) / 2`` (``2 x 2 x heads x 256 x ...`` at GLM-4.7-Flash's
  widths, where qk = v = 256);
* a dense FFN: w1, w3 (d -> intermediate) and w2;
* a MoE layer: the router (d -> experts), for the T x k token-slots the
  routed experts' gate‖up (d -> 2 f) and down (f -> d), and for the T rows
  the shared expert's gate‖up and down;
* the output head on each prompt's last position (d -> vocab).

Norms, RoPE, softmax and routing are left out (they are not FLOP-bound).
An MLA block's bound is its five projections' ``roofline.call_bound_s``, one
projection a call, plus the core's FLOPs at the card's peak; the routed
expert calls' bound is ``lfm2_roofline.experts_bound_s`` over their routed
shapes, as in the LFM2 cell.
"""

from __future__ import annotations

from cardbench import roofline


def mla_projections(cfg: dict, T: int) -> dict:
    """A layer's five MLA projections as ``(T, K, N)``, by name."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    qr, r = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    nope, rd, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return {
        "q_a": (T, d, qr),
        "kv_a": (T, d, r + rd),
        "q_b": (T, qr, H * (nope + rd)),
        "kv_b": (T, r, H * (nope + vd)),
        "o": (T, H * vd, d),
    }


def mla_core_flops(cfg: dict, prompts: int, tokens: int) -> int:
    """FLOPs of one layer's causal core: ``q k^T`` and ``p v`` over the
    causal half of each prompt's scores."""
    H = cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return 2 * prompts * H * (qk + cfg["v_head_dim"]) * tokens * (tokens + 1) // 2


def round_flops(cfg: dict, prompts: int, tokens: int) -> dict:
    """FLOPs of one round, by part: ``mla_proj``, ``mla_core``,
    ``dense_ffn``, ``moe`` (router and routed experts), ``shared``, ``head``
    and ``total``."""
    T, d = prompts * tokens, cfg["hidden_size"]
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    f, ff = cfg["moe_intermediate_size"], cfg["intermediate_size"]
    fs = f * cfg.get("n_shared_experts", 0)
    g = roofline.gemm_flops
    layers, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    proj = sum(g(*s) for s in mla_projections(cfg, T).values())
    parts = {
        "mla_proj": layers * proj,
        "mla_core": layers * mla_core_flops(cfg, prompts, tokens),
        "dense_ffn": dense * (2 * g(T, d, ff) + g(T, ff, d)),
        "moe": (layers - dense) * (g(T, d, E) + g(T * k, d, 2 * f) + g(T * k, f, d)),
        "shared": (layers - dense) * (g(T, d, 2 * fs) + g(T, fs, d)),
        "head": g(prompts, d, cfg["vocab_size"]),
    }
    parts["total"] = sum(parts.values())
    return parts


def mla_bound_s(cfg: dict, prompts: int, tokens: int) -> float:
    """The least seconds the card needs for one MLA block: each projection's
    call bound and the core's FLOPs at the peak, in the configuration's
    dtype."""
    dtype = cfg["dtype"]
    T = prompts * tokens
    proj = sum(
        roofline.call_bound_s([s], dtype) for s in mla_projections(cfg, T).values()
    )
    return proj + mla_core_flops(cfg, prompts, tokens) / roofline.PEAK_FLOPS[dtype]
