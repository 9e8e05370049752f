"""GLM-4.7-Flash (``model_type: glm4_moe_lite``): prefill through the fused GEMM.

A port-only model, configured from its published ``config.json`` keys
(:meth:`Glm4MoeLiteConfig.from_config`); it is not one of
``repro_torch.configs``' architectures.  A layer is
``h = h + mla(input_layernorm(h))`` then
``h = h + ffn(post_attention_layernorm(h))``, where ``mla`` is multi-head
latent attention as DeepSeek-V2/V3 compute it (:func:`mla_block`):

* the query path: ``q = q_b_proj(RMSNorm(q_a_proj x))`` through a
  ``q_lora_rank``-wide latent, each head ``qk_nope_head_dim`` columns that
  take no position and ``qk_rope_head_dim`` that RoPE rotates;
* the key-value path: ``kv_a_proj_with_mqa x`` gives a ``kv_lora_rank``-wide
  latent and one ``qk_rope_head_dim``-wide ``k_pe`` that every head shares;
  ``kv_b_proj(RMSNorm(latent))`` gives each head's ``k_nope`` and its
  ``v_head_dim``-wide ``v``;
* the core: causal softmax of ``[q_nope, rope(q_pe)] . [k_nope, rope(k_pe)]``
  over ``qk_nope_head_dim + qk_rope_head_dim`` columns at scale
  ``(qk_nope_head_dim + qk_rope_head_dim)^-0.5`` (no ``rope_scaling``, so no
  mscale), within each prompt, then ``o_proj``;

and ``ffn`` is a dense SwiGLU in the first ``first_k_dense_replace`` layers
and after them the routed experts with one shared expert
(``models.routed_experts``): sigmoid scores, the top-k chosen by score plus
a selection-only bias (``noaux_tc`` in one group), their scores normalised
and times ``routed_scaling_factor``.  Then the final norm and the untied
head on each prompt's last position.  RMSNorm is
``w * x * rsqrt(mean(x^2) + eps)`` in f32.

RoPE is the half rotation of ``models.layers.rope`` on the rope columns as
they lie.  DeepSeek-style checkpoints store those 64 columns interleaved and
``transformers`` de-interleaves them before the half rotation; with random
weights that is a fixed permutation of 64 projection columns, so the weights
are taken as already de-interleaved.

Every projection is a ``gemm`` call (``kernels.fused_tenant_gemm`` by
default): ``q_a_proj`` and ``kv_a_proj_with_mqa`` (one call, two tenants),
``q_b_proj`` and ``kv_b_proj`` (one call, two tenants), ``o_proj``, the
dense FFN's w1/w3 (one call) and w2, the router, the routed and the shared
experts and the head.  The attention core is
``F.scaled_dot_product_attention``; norms, RoPE and routing are plain
PyTorch.  Weights and activations are bfloat16; the GEMMs' float32 outputs
are rounded to bfloat16, except the expert calls', whose epilogue writes
bfloat16 itself.  With tracing armed and a profiler recording, the
projections with their norms and RoPE are spans ``repro_torch.mla.proj``
and the key's assembly with the core ``repro_torch.mla.core``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.kernels import tracing
from repro_torch.kernels.ops import fused_tenant_gemm
from repro_torch.models import routed_experts as moe
from repro_torch.models.layers import rope
from repro_torch.models.lfm2_moe import dense_ffn, rms_norm

Params = dict[str, Any]

SPAN_PREFIX = "repro_torch.mla."
_PROJ, _CORE = SPAN_PREFIX + "proj", SPAN_PREFIX + "core"


@dataclasses.dataclass(frozen=True)
class Glm4MoeLiteConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    moe_intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    n_routed_experts: int
    num_experts_per_tok: int
    first_k_dense_replace: int
    n_shared_experts: int = 0
    rms_norm_eps: float = 1e-5
    rope_theta: float = 1e6
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    # the drawn expert bias's standard deviation (not a published key: the
    # published weights are not used)
    expert_bias_std: float = 0.0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        return self.qk_head_dim**-0.5

    @property
    def shared_width(self) -> int:
        return self.moe_intermediate_size * self.n_shared_experts

    @classmethod
    def from_config(cls, d: dict) -> "Glm4MoeLiteConfig":
        """From the keys of a published ``config.json`` (and
        ``expert_bias_std``).  Raises where it asks for what this model does
        not compute: tied embeddings, attention biases, RoPE scaling, a
        query without its low-rank latent, partial rotation, group-limited
        routing, another activation, or key-value heads other than the
        query heads (MLA gives every head its own)."""
        if d.get("model_type", "glm4_moe_lite") != "glm4_moe_lite":
            raise ValueError(f"not a glm4_moe_lite config: {d.get('model_type')!r}")
        refused = {
            "tie_word_embeddings": d.get("tie_word_embeddings", False),
            "attention_bias": d.get("attention_bias", False),
            "rope_scaling": d.get("rope_scaling") is not None,
            "q_lora_rank": d.get("q_lora_rank") is None,
            "partial_rotary_factor": d.get("partial_rotary_factor", 1) != 1,
            "n_group": (d.get("n_group", 1), d.get("topk_group", 1)) != (1, 1),
            "topk_method": d.get("topk_method", "noaux_tc") != "noaux_tc",
            "hidden_act": d.get("hidden_act", "silu") != "silu",
            "num_key_value_heads": d.get(
                "num_key_value_heads", d["num_attention_heads"]
            ) != d["num_attention_heads"],
        }
        bad = sorted(k for k, v in refused.items() if v)
        if bad:
            raise ValueError(f"not computed: {', '.join(bad)}")
        keys = [f.name for f in dataclasses.fields(cls)]
        kw = {k: d[k] for k in keys if k in d}
        kw["rope_theta"] = float(d.get("rope_theta", cls.rope_theta))
        return cls(**kw)

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace


def param_shapes(cfg: Glm4MoeLiteConfig) -> Params:
    """Every parameter's shape, in the tree :func:`init_params` draws; each
    projection as a GEMM's w, (in, out)."""
    D, H = cfg.hidden_size, cfg.num_attention_heads
    r = cfg.kv_lora_rank
    layers = []
    for i in range(cfg.num_hidden_layers):
        lp: dict = {
            "input_layernorm": (D,),
            "post_attention_layernorm": (D,),
            "q_a_proj": (D, cfg.q_lora_rank),
            "q_a_layernorm": (cfg.q_lora_rank,),
            "q_b_proj": (cfg.q_lora_rank, H * cfg.qk_head_dim),
            "kv_a_proj_with_mqa": (D, r + cfg.qk_rope_head_dim),
            "kv_a_layernorm": (r,),
            "kv_b_proj": (r, H * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
            "o_proj": (H * cfg.v_head_dim, D),
        }
        if cfg.is_moe(i):
            E, f = cfg.n_routed_experts, cfg.moe_intermediate_size
            lp |= {"router": (D, E), "expert_bias": (E,), "gate_up": (E, D, 2 * f),
                   "down": (E, f, D)}
            if cfg.shared_width:
                fs = cfg.shared_width
                lp |= {"shared_gate_up": (D, 2 * fs), "shared_down": (fs, D)}
        else:
            f = cfg.intermediate_size
            lp |= {"w1": (D, f), "w3": (D, f), "w2": (f, D)}
        layers.append(lp)
    return {"embed": (cfg.vocab_size, D), "norm": (D,), "lm_head": (D, cfg.vocab_size),
            "layers": layers}


def init_params(cfg: Glm4MoeLiteConfig, *, seed: int, device="cuda") -> Params:
    """Random bfloat16 weights drawn from ``seed`` on ``device``: each matrix
    normal with standard deviation 1/sqrt(fan-in) (its rows as a GEMM's w;
    an expert's input width; the embedding's hidden size), norm weights one,
    the expert bias f32 normal with standard deviation
    ``cfg.expert_bias_std`` (zero where that is 0)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def leaf(name, shape):
        if name.endswith("norm"):
            return torch.ones(shape, dtype=torch.bfloat16, device=device)
        if name == "expert_bias":
            t = torch.zeros(shape, dtype=torch.float32, device=device)
            if cfg.expert_bias_std:
                t.normal_(0.0, cfg.expert_bias_std, generator=gen)
            return t
        fan_in = shape[-1] if name == "embed" else shape[-2]
        t = torch.empty(shape, dtype=torch.bfloat16, device=device)
        return t.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)

    shapes = param_shapes(cfg)
    tree = {k: leaf(k, s) for k, s in shapes.items() if k != "layers"}
    tree["layers"] = [{k: leaf(k, s) for k, s in lp.items()} for lp in shapes["layers"]]
    return tree


def kv_latent(
    kv_a: torch.Tensor, p: Params, cfg: Glm4MoeLiteConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """The key-value path's ``kv_a_proj_with_mqa`` output (T, r + rope) split
    into the RMS-normed latent (T, r) and the shared key part ``k_pe``
    (T, rope), not yet rotated."""
    r = cfg.kv_lora_rank
    return rms_norm(kv_a[:, :r], p["kv_a_layernorm"], cfg.rms_norm_eps), kv_a[:, r:]


def mla_block(
    p: Params, cfg: Glm4MoeLiteConfig, x: torch.Tensor, prompts: int, gemm
) -> torch.Tensor:
    """Causal multi-head latent attention within each prompt on ``x`` (T, d),
    T = prompts x S."""
    T, d = x.shape
    S, H = T // prompts, cfg.num_attention_heads
    nope, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    with tracing.span(_PROJ):
        q_lat, kv_a = (
            o.to(x.dtype)
            for o in gemm([x, x], [p["q_a_proj"], p["kv_a_proj_with_mqa"]])
        )
        q_lat = rms_norm(q_lat, p["q_a_layernorm"], cfg.rms_norm_eps)
        kv_lat, k_pe = kv_latent(kv_a, p, cfg)
        q, kv = (
            o.to(x.dtype)
            for o in gemm([q_lat, kv_lat], [p["q_b_proj"], p["kv_b_proj"]])
        )
        positions = torch.arange(S, device=x.device).expand(prompts, S)
        q = q.view(prompts, S, H, nope + rd)
        q[..., nope:] = rope(q[..., nope:], positions, cfg.rope_theta)
        k_pe = rope(k_pe.view(prompts, S, 1, rd), positions, cfg.rope_theta)
    with tracing.span(_CORE):
        kv = kv.view(prompts, S, H, nope + vd)
        k = torch.cat([kv[..., :nope], k_pe.expand(prompts, S, H, rd)], dim=-1)
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2),
            k.transpose(1, 2),
            kv[..., nope:].transpose(1, 2),
            is_causal=True,
            scale=cfg.softmax_scale,
        )
    with tracing.span(_PROJ):
        (out,) = gemm([o.transpose(1, 2).reshape(T, H * vd)], [p["o_proj"]])
    return out.to(x.dtype)


def prefill(
    params: Params,
    cfg: Glm4MoeLiteConfig,
    ids: torch.Tensor,
    *,
    gemm=fused_tenant_gemm,
    keep: Optional[dict] = None,
) -> torch.Tensor:
    """The forward of ``ids`` (B, S); see :func:`prefill_steps`."""
    return moe.run_steps(prefill_steps(params, cfg, ids, gemm=gemm, keep=keep))


def prefill_steps(
    params: Params,
    cfg: Glm4MoeLiteConfig,
    ids: torch.Tensor,
    *,
    gemm=fused_tenant_gemm,
    keep: Optional[dict] = None,
):
    """The forward of ``ids`` (B, S), B prompts of S tokens, as a generator
    that yields at each MoE layer's count read
    (``routed_experts.routed_experts_steps``) and returns the (B, vocab)
    float32 logits of each prompt's last position.

    ``keep``, where given, gets what each layer produced (no copies): lists
    ``hidden`` (the residual stream, (B S, d): the embedding, then each
    layer's output), ``op`` and ``ffn`` (what each layer's attention and ffn
    added to it), and a dict ``experts`` of each MoE layer's (B S, k)
    chosen experts, by layer index."""
    B, S = ids.shape
    eps = cfg.rms_norm_eps
    h = params["embed"].index_select(0, ids.reshape(-1))
    if keep is not None:
        keep.update(hidden=[h], op=[], ffn=[], experts={})
    for i, p in enumerate(params["layers"]):
        a = mla_block(p, cfg, rms_norm(h, p["input_layernorm"], eps), B, gemm)
        h = h + a
        x = rms_norm(h, p["post_attention_layernorm"], eps)
        if cfg.is_moe(i):
            f, experts = yield from moe.routed_experts_steps(
                p,
                x,
                cfg.num_experts_per_tok,
                norm=cfg.norm_topk_prob,
                scale=cfg.routed_scaling_factor,
                gemm=gemm,
            )
            if keep is not None:
                keep["experts"][i] = experts
        else:
            f = dense_ffn(p, x, gemm)
        h = h + f
        if keep is not None:
            keep["op"].append(a)
            keep["ffn"].append(f)
            keep["hidden"].append(h)
    last = rms_norm(h.view(B, S, -1)[:, -1], params["norm"], eps)
    (logits,) = gemm([last], [params["lm_head"]])
    return logits
