"""Faults planted in a GLM-4.7-Flash prefill, to show that its check catches
them.

Each takes the program's call (the GEMM, ``fused_tenant_gemm(xs, ws,
**kw)``) and returns ``(call, plant)``: the call to run in the program's
place and a context manager that, while entered, breaks the model's own
code (``repro_torch.models.glm4_moe_lite`` and ``.routed_experts``) in one
way a prefill can go wrong.  The tests drive a whole run on the CPU with
each, and ``glm_readings.py`` reads them on the card at the cell's own size.
Nothing here runs in a benchmark run.
"""

from __future__ import annotations

import torch

from cardbench.lfm2_faults import _patched


def k_pe_unrotated(program):
    """The shared key part ``k_pe`` not rotated: RoPE left off the one
    rope tensor of a single head (the queries' have every head)."""
    from repro_torch.models import glm4_moe_lite

    rope = glm4_moe_lite.rope

    def rotate(x, positions, theta):
        return x if x.shape[-2] == 1 else rope(x, positions, theta)

    return program, _patched(glm4_moe_lite, "rope", rotate)


def kv_norm_skipped(program):
    """The key-value latent's RMSNorm skipped."""
    from repro_torch.models import glm4_moe_lite

    def split(kv_a, p, cfg):
        r = cfg.kv_lora_rank
        return kv_a[:, :r].contiguous(), kv_a[:, r:]

    return program, _patched(glm4_moe_lite, "kv_latent", split)


def nope_scale(program):
    """The softmax scale from the no-position columns alone,
    ``qk_nope_head_dim^-0.5`` (192^-0.5) in place of the whole query
    width's (256^-0.5)."""
    from repro_torch.models import glm4_moe_lite

    cls = glm4_moe_lite.Glm4MoeLiteConfig
    scale = property(lambda cfg: cfg.qk_nope_head_dim**-0.5)
    return program, _patched(cls, "softmax_scale", scale)


def shared_dropped(program):
    """The shared expert's output left out of the layer's sum (its calls
    still run)."""
    from repro_torch.models import routed_experts as moe

    shared = moe.shared_expert

    def dropped(p, x, gemm):
        return torch.zeros_like(shared(p, x, gemm))

    return program, _patched(moe, "shared_expert", dropped)


def unscaled_routing(program):
    """The routed experts' weights not times ``routed_scaling_factor``."""
    from repro_torch.models import routed_experts as moe

    route = moe.route_top_k

    def top_k(scores, bias, k, norm, scale):
        return route(scores, bias, k, norm, 1.0)

    return program, _patched(moe, "route_top_k", top_k)


FAULTS = {
    "k_pe_unrotated": k_pe_unrotated,
    "kv_norm_skipped": kv_norm_skipped,
    "nope_scale": nope_scale,
    "shared_dropped": shared_dropped,
    "unscaled_routing": unscaled_routing,
}
