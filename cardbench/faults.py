"""Faults planted under the timed path, to show that the check catches them.

Each takes the program's call (``fused_tenant_gemm(xs, ws, grid_mode=...)``)
and returns one that breaks it in one way a GEMM round can go wrong.  The
tests drive a whole run on the CPU with each, and ``readings.py`` reads
them on the card at a cell's own size.  Nothing here runs in a benchmark
run.
"""

from __future__ import annotations

import torch


def altered_answer(program):
    """One element of the last tenant's output moved where it is produced."""

    def call(xs, ws, **kw):
        outs = program(xs, ws, **kw)
        last = outs[-1]
        last[last.shape[0] // 2, last.shape[1] // 2] += 1.0 + last.abs().max()
        return outs

    return call


def half_batch(program):
    """The second half of every tenant's rows (half its requests) left out."""

    def call(xs, ws, **kw):
        half = [x[: x.shape[0] // 2] for x in xs]
        outs = program(half, ws, **kw)
        return [
            torch.cat([o, o.new_zeros((x.shape[0] - o.shape[0], o.shape[1]))])
            for o, x in zip(outs, xs)
        ]

    return call


def unchanged(program):
    """Each wave returns the outputs it made in the first round, unchanged."""
    seen: dict = {}

    def call(xs, ws, **kw):
        key = tuple((x.shape[0], x.shape[1], w.shape[1]) for x, w in zip(xs, ws))
        key = (key, tuple(x.data_ptr() for x in xs))
        if key not in seen:
            seen[key] = program(xs, ws, **kw)
        return seen[key]

    return call


def dropped_tenant(program):
    """The last tenant of every wave left out of the launch, its output 0."""

    def call(xs, ws, **kw):
        shape = (xs[-1].shape[0], ws[-1].shape[1])
        zero = torch.zeros(shape, dtype=torch.float32, device=xs[-1].device)
        if len(xs) == 1:
            return [zero]
        return [*program(xs[:-1], ws[:-1], **kw), zero]

    return call


FAULTS = {
    "altered_answer": altered_answer,
    "half_batch": half_batch,
    "unchanged": unchanged,
    "dropped_tenant": dropped_tenant,
}
