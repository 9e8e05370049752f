"""LFM2-MoE (``model_type: lfm2_moe``): prefill through the fused GEMM.

A port-only model, configured from its published ``config.json`` keys
(:meth:`Lfm2MoeConfig.from_config`); it is not one of
``repro_torch.configs``' architectures.  A layer is
``h = h + op(operator_norm(h))`` then ``h = h + ffn(ffn_norm(h))``, where
``op`` is per ``layer_types``:

* ``conv``, the gated short convolution: ``B, C, x = chunk3(in_proj(h))``,
  ``out_proj(C * causal_depthwise_conv(B * x))`` (width ``conv_L_cache``,
  no biases);
* ``full_attention``: GQA with RMSNorm over each query and key head
  (``q_layernorm``, ``k_layernorm``) before RoPE, causal within a prompt;

and ``ffn`` is a dense SwiGLU ``w2(silu(w1 h) * w3 h)`` in the first
``num_dense_layers`` layers and the routed experts
(``models.routed_experts``) after them.  Then ``embedding_norm`` and the
embedding as the (tied) output head.  RMSNorm is
``w * x * rsqrt(mean(x^2) + eps)`` in f32.

Every projection is a ``gemm`` call (``kernels.fused_tenant_gemm`` by
default): in_proj, out_proj, q/k/v (one call, three tenants), the dense
FFN's w1/w3 (one call, two tenants) and w2, the router, the experts and the
output head.  The attention core, the convolution, the norms, RoPE and
routing are plain PyTorch.  Weights and activations are bfloat16; the
GEMMs' float32 outputs are rounded to bfloat16, except the expert
calls', whose epilogue writes bfloat16 itself.
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

Params = dict[str, Any]

LAYER_KINDS = ("conv", "full_attention")
SPAN_PREFIX = "repro_torch.lfm2."
_CONV, _ATTENTION, _FFN = (SPAN_PREFIX + s for s in ("conv", "attention", "ffn"))


@dataclasses.dataclass(frozen=True)
class Lfm2MoeConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    moe_intermediate_size: int
    num_attention_heads: int
    num_key_value_heads: int
    num_dense_layers: int
    num_experts: int
    num_experts_per_tok: int
    layer_types: tuple[str, ...]
    conv_L_cache: int = 3
    norm_eps: float = 1e-5
    rope_theta: float = 1e6
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    # the drawn expert bias's standard deviation (not a published key: the
    # published weights are not used)
    expert_bias_std: float = 0.0

    def __post_init__(self) -> None:
        bad = set(self.layer_types) - set(LAYER_KINDS)
        if bad:
            raise ValueError(f"unknown layer types {sorted(bad)}")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must divide into the attention heads")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("the query heads must divide into the KV heads")

    @property
    def num_hidden_layers(self) -> int:
        return len(self.layer_types)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_config(cls, d: dict) -> "Lfm2MoeConfig":
        """From the keys of a published ``config.json`` (and
        ``expert_bias_std``).  Raises where it asks for what this model
        does not compute: untied embeddings or a convolution bias.  The
        expert bias is always a parameter (zero where ``use_expert_bias``
        is false, which routes alike)."""
        if d.get("model_type", "lfm2_moe") != "lfm2_moe":
            raise ValueError(f"not an lfm2_moe config: {d.get('model_type')!r}")
        if not d.get("tie_word_embeddings", True) or d.get("conv_bias", False):
            raise ValueError("untied embeddings and conv biases are not computed")
        if len(d["layer_types"]) != d["num_hidden_layers"]:
            raise ValueError("layer_types must give every layer")
        theta = d.get("rope_parameters", {}).get("rope_theta", d.get("rope_theta"))
        keys = [f.name for f in dataclasses.fields(cls)]
        kw = {k: d[k] for k in keys if k in d}
        kw["layer_types"] = tuple(d["layer_types"])
        if theta is not None:
            kw["rope_theta"] = float(theta)
        if not d.get("use_expert_bias", True):
            kw["expert_bias_std"] = 0.0
        return cls(**kw)

    def is_moe(self, layer: int) -> bool:
        return layer >= self.num_dense_layers


def param_shapes(cfg: Lfm2MoeConfig) -> Params:
    """Every parameter's shape, in the tree :func:`init_params` draws."""
    D, hd = cfg.hidden_size, cfg.head_dim
    kv = cfg.num_key_value_heads * hd
    layers = []
    for i, kind in enumerate(cfg.layer_types):
        lp: dict = {"operator_norm": (D,), "ffn_norm": (D,)}
        if kind == "conv":
            lp |= {"in_proj": (D, 3 * D), "conv": (cfg.conv_L_cache, D),
                   "out_proj": (D, D)}
        else:
            lp |= {"q_proj": (D, D), "k_proj": (D, kv), "v_proj": (D, kv),
                   "out_proj": (D, D), "q_layernorm": (hd,), "k_layernorm": (hd,)}
        if cfg.is_moe(i):
            E, f = cfg.num_experts, cfg.moe_intermediate_size
            lp |= {"router": (D, E), "expert_bias": (E,), "gate_up": (E, D, 2 * f),
                   "down": (E, f, D)}
        else:
            f = cfg.intermediate_size
            lp |= {"w1": (D, f), "w3": (D, f), "w2": (f, D)}
        layers.append(lp)
    return {"embed": (cfg.vocab_size, D), "embedding_norm": (D,), "layers": layers}


# parameters that are not drawn: norm weights are ones
_ONES = ("operator_norm", "ffn_norm", "q_layernorm", "k_layernorm", "embedding_norm")


def init_params(cfg: Lfm2MoeConfig, *, seed: int, device="cuda") -> Params:
    """Random bfloat16 weights drawn from ``seed`` on ``device``: each matrix normal
    with standard deviation 1/sqrt(fan-in) (its rows as a GEMM's w: the
    convolution's ``conv_L_cache`` taps, the embedding's hidden size, as
    the tied output head reads it; an expert's input width), norm weights
    one, the expert bias f32 normal with standard deviation
    ``cfg.expert_bias_std`` (zero where that is 0)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def leaf(name, shape):
        if name in _ONES:
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
    return {
        "embed": leaf("embed", shapes["embed"]),
        "embedding_norm": leaf("embedding_norm", shapes["embedding_norm"]),
        "layers": [{k: leaf(k, s) for k, s in lp.items()} for lp in shapes["layers"]],
    }


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * w.float()
    return out.to(x.dtype)


def causal_conv(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution along each prompt: ``x`` (B, S, d),
    ``w`` (L, d); ``out[t] = sum_j w[j] * x[t - (L - 1) + j]`` (f32 sums,
    zeros before a prompt's first position)."""
    L, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, L - 1, 0)).float()
    out = sum(pad[:, j : j + S] * w[j].float() for j in range(L))
    return out.to(x.dtype)


def conv_block(p: Params, x: torch.Tensor, prompts: int, gemm) -> torch.Tensor:
    """The gated short convolution on ``x`` (T, d), T = prompts x S."""
    T, d = x.shape
    (bcx,) = gemm([x], [p["in_proj"]])
    b, c, v = bcx.to(x.dtype).chunk(3, dim=-1)
    y = c * causal_conv(p["conv"], (b * v).view(prompts, T // prompts, d)).view(T, d)
    (out,) = gemm([y], [p["out_proj"]])
    return out.to(x.dtype)


def qk_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over each head: ``x`` (..., heads, head_dim)."""
    return rms_norm(x, w, eps)


def attention_block(
    p: Params, cfg: Lfm2MoeConfig, x: torch.Tensor, prompts: int, gemm
) -> torch.Tensor:
    """Causal GQA within each prompt on ``x`` (T, d)."""
    T, d = x.shape
    S, hd = T // prompts, cfg.head_dim
    H, KV = cfg.num_attention_heads, cfg.num_key_value_heads
    q, k, v = (
        o.to(x.dtype).view(prompts, S, -1, hd)
        for o in gemm([x, x, x], [p["q_proj"], p["k_proj"], p["v_proj"]])
    )
    positions = torch.arange(S, device=x.device).expand(prompts, S)
    q = rope(qk_norm(q, p["q_layernorm"], cfg.norm_eps), positions, cfg.rope_theta)
    k = rope(qk_norm(k, p["k_layernorm"], cfg.norm_eps), positions, cfg.rope_theta)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, heads, S, hd)
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    (out,) = gemm([o.transpose(1, 2).reshape(T, d)], [p["out_proj"]])
    return out.to(x.dtype)


def dense_ffn(p: Params, x: torch.Tensor, gemm) -> torch.Tensor:
    g, u = (o.to(x.dtype) for o in gemm([x, x], [p["w1"], p["w3"]]))
    (out,) = gemm([F.silu(g) * u], [p["w2"]])
    return out.to(x.dtype)


def prefill(
    params: Params,
    cfg: Lfm2MoeConfig,
    ids: torch.Tensor,
    *,
    gemm=fused_tenant_gemm,
    keep: Optional[dict] = None,
) -> torch.Tensor:
    """The forward of ``ids`` (B, S); see :func:`prefill_steps`."""
    return moe.run_steps(prefill_steps(params, cfg, ids, gemm=gemm, keep=keep))


def prefill_steps(
    params: Params,
    cfg: Lfm2MoeConfig,
    ids: torch.Tensor,
    *,
    gemm=fused_tenant_gemm,
    keep: Optional[dict] = None,
):
    """The forward of ``ids`` (B, S), B prompts of S tokens, as a generator
    that yields at each MoE layer's count read
    (``routed_experts.routed_experts_steps``) and returns the (B, vocab)
    float32 logits of each prompt's last position: a server with several
    batches in flight runs the others' steps there.

    ``keep``, where given, gets what each layer produced (no copies): lists
    ``hidden`` (the residual stream, (B S, d): the embedding, then each
    layer's output), ``op`` and ``ffn`` (what each layer's op and ffn added
    to it), and a dict ``experts`` of each MoE layer's (B S, k) chosen
    experts, by layer index."""
    B, S = ids.shape
    eps = cfg.norm_eps
    h = params["embed"].index_select(0, ids.reshape(-1))
    if keep is not None:
        keep.update(hidden=[h], op=[], ffn=[], experts={})
    for i, (kind, p) in enumerate(zip(cfg.layer_types, params["layers"])):
        x = rms_norm(h, p["operator_norm"], eps)
        if kind == "conv":
            with tracing.span(_CONV):
                a = conv_block(p, x, B, gemm)
        else:
            with tracing.span(_ATTENTION):
                a = attention_block(p, cfg, x, B, gemm)
        h = h + a
        x = rms_norm(h, p["ffn_norm"], eps)
        with tracing.span(_FFN):
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
    last = rms_norm(h.view(B, S, -1)[:, -1], params["embedding_norm"], eps)
    (logits,) = gemm([params["embed"]], [last.t().contiguous()])
    return logits.t()
