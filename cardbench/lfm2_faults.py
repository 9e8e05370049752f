"""Faults planted in an LFM2-MoE prefill, to show that its check catches them.

Each takes the program's call (the GEMM, ``fused_tenant_gemm(xs, ws,
**kw)``) and returns ``(call, plant)``: the call to run in the program's
place and a context manager that, while entered, breaks the model's own
code (``repro_torch.models.lfm2_moe`` and ``.routed_experts``) in one way a
prefill can go wrong.  The tests drive a whole run on the CPU with each,
and ``lfm2_readings.py`` reads them on the card at the cell's own size.
Nothing here runs in a benchmark run.
"""

from __future__ import annotations

import contextlib

import torch


def _patched(module, name, value):
    @contextlib.contextmanager
    def plant():
        was = getattr(module, name)
        setattr(module, name, value)
        try:
            yield
        finally:
            setattr(module, name, was)

    return plant()


def dropped_expert(program):
    """One expert's output left out: in every call of more than one tenant
    whose tenants all share one w shape (the expert calls), the first tenant
    with rows returns zeros."""

    def call(xs, ws, **kw):
        outs = program(xs, ws, **kw)
        if len(ws) > 3 and len({tuple(w.shape) for w in ws}) == 1:
            e = next((i for i, x in enumerate(xs) if x.shape[0]), None)
            if e is not None:
                outs[e] = torch.zeros_like(outs[e])
        return outs

    return call, contextlib.nullcontext()


def unnormalised_gates(program):
    """The chosen experts' weights not divided by their sum."""
    from repro_torch.models import routed_experts as moe

    route = moe.route_top_k

    def top_k(scores, bias, k, norm, scale):
        return route(scores, bias, k, False, scale)

    return program, _patched(moe, "route_top_k", top_k)


def next_choices(program):
    """Each token routed to its 2nd to (k+1)-th choices."""
    from repro_torch.models import routed_experts as moe

    def top_k(scores, bias, k, norm, scale):
        experts = torch.topk(scores + bias, k + 1, dim=-1).indices[:, 1:]
        gates = scores.gather(-1, experts)
        if norm:
            gates = gates / (gates.sum(-1, keepdim=True) + moe.NORM_EPS)
        return gates * scale, experts

    return program, _patched(moe, "route_top_k", top_k)


def bias_in_gates(program):
    """The expert bias added to the chosen experts' weights as well as to
    their choice."""
    from repro_torch.models import routed_experts as moe

    route = moe.route_top_k

    def top_k(scores, bias, k, norm, scale):
        return route(scores + bias, bias.new_zeros(bias.shape), k, norm, scale)

    return program, _patched(moe, "route_top_k", top_k)


def conv_shift(program):
    """The convolution's causal shift off by one: each tap reads one
    position later, so a position sees the next."""
    from repro_torch.models import lfm2_moe

    conv = lfm2_moe.causal_conv

    def shifted(w, x):
        ahead = torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)
        return conv(w, ahead)

    return program, _patched(lfm2_moe, "causal_conv", shifted)


def qk_norm_skipped(program):
    """The first attention layer's query and key RMSNorm skipped."""
    from repro_torch.models import lfm2_moe

    block, norm = lfm2_moe.attention_block, lfm2_moe.qk_norm
    first: list = []

    def attention(p, *args, **kw):
        if not first:
            first.append(p)
        if p is not first[0]:
            return block(p, *args, **kw)
        lfm2_moe.qk_norm = lambda x, w, eps: x
        try:
            return block(p, *args, **kw)
        finally:
            lfm2_moe.qk_norm = norm

    return program, _patched(lfm2_moe, "attention_block", attention)


FAULTS = {
    "dropped_expert": dropped_expert,
    "unnormalised_gates": unnormalised_gates,
    "next_choices": next_choices,
    "bias_in_gates": bias_in_gates,
    "conv_shift": conv_shift,
    "qk_norm_skipped": qk_norm_skipped,
}
