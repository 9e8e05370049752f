"""Dropless routed experts, run as the ragged tenants of fused-GEMM launches.

A mixture-of-experts layer as LFM2-MoE routes it: sigmoid scores of an f32
router, the top-k experts chosen by score plus a per-expert bias (the bias
decides the choice only), the chosen scores normalised to sum to one and
scaled.  Every token-slot is computed: there is no capacity and nothing is
dropped.  The layer runs in four phases:

* ``route``: the router GEMM, the top-k choice and weights, and the count
  of slots each expert took, read to the host (one device-to-host read a
  layer: the launch table is built on the host from those counts);
* ``dispatch``: the slots sorted by expert into one contiguous buffer, so
  each expert's rows are one view of it;
* ``experts``: ONE ``gemm`` call over all experts for gate‖up (each expert a
  tenant with its routed rows, none for an expert no token chose) whose
  epilogue writes SiLU·up in bfloat16 into one buffer, then one call for
  down whose epilogue writes each slot's row times its gate in bfloat16
  into another;
* ``combine``: each token's slots gathered back in token order and summed
  in float32.

A layer may also have a shared expert (``shared_gate_up`` (d, 2 f_s),
``shared_down`` (f_s, d) in ``p``, as DeepSeek-V3 and GLM-4.7-Flash have
one), a SwiGLU that every token takes, its output added unweighted to the
routed sum in float32 before the layer's one rounding to bfloat16.  Its two
calls (:func:`shared_expert`, one tenant each, through the same epilogue)
do not wait on the routing, so the layer enqueues them after its count read
has begun and before it yields: the card runs them while the counts travel
to the host.  A layer without those parameters makes exactly the calls it
made before shared experts were added.

``gemm`` is ``repro_torch.kernels.fused_tenant_gemm`` or anything with its
call.  The layer passes it the epilogue's keywords (``epilogue``,
``row_scale``, ``out``) and uses the buffer as it is only where the
outputs that come back are its rows, in order.  Otherwise it concatenates
them, and where they are float32 (a call that took no notice of the
epilogue) it rounds them to bfloat16 and applies SiLU·up, or the gates in
float32, itself, as a layer without the epilogue does.

Counters (:func:`moe_stats`): layers run, tokens and token-slots routed,
the sum over layers of the most rows one expert took, the experts left
empty, the count reads, the expert calls used from the epilogue's buffer
and those the layer had to concatenate or finish, the shared expert's calls
and rows are always counted.
With tracing armed
(``kernels.tracing.set_tracing``) each phase also adds its host
nanoseconds, each layer its host nanoseconds from the router's launch to
the last expert call's return and its per-expert row counts, and under a
profiler each phase is a ``record_function`` span ``repro_torch.moe.<phase>``
and the shared expert's two calls the span ``repro_torch.moe.shared``
(inside ``route``).
"""

from __future__ import annotations

import time
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import tracing
from repro_torch.kernels.ops import fused_tenant_gemm

Params = dict[str, Any]

PHASES = ("route", "dispatch", "experts", "combine")
SPAN_PREFIX = "repro_torch.moe."
_SPANS = tuple(SPAN_PREFIX + p for p in PHASES)
SHARED_SPAN = SPAN_PREFIX + "shared"
# added to the sum of a token's chosen scores before it divides them
NORM_EPS = 1e-6


class _Store:
    __slots__ = ("layers", "tokens", "slots", "max_rows", "empty_experts",
                 "count_reads", "epilogue_calls", "copied_calls", "shared_calls",
                 "shared_rows", "phase_ns", "armed_layers", "layer_ns", "routed")

    def __init__(self) -> None:
        self.layers = self.tokens = self.slots = 0
        self.max_rows = self.empty_experts = self.count_reads = 0
        self.epilogue_calls = self.copied_calls = 0
        self.shared_calls = self.shared_rows = 0
        self.phase_ns = [0] * len(PHASES)
        self.armed_layers = self.layer_ns = 0
        self.routed: list[tuple[int, ...]] = []


_store = _Store()


def moe_stats() -> dict:
    """The counters since the process started or the last reset:
    ``layers``, ``tokens``, ``slots`` (token-slots routed), ``max_rows``
    (the sum over layers of the most rows one expert took),
    ``empty_experts`` (summed over layers), ``count_reads`` (host syncs),
    ``epilogue_calls`` (expert calls whose outputs came back as the rows of
    the layer's buffer, used with no copy), ``copied_calls`` (those the
    layer concatenated or finished itself; both count the shared expert's
    calls too), ``shared_calls`` and ``shared_rows`` (the shared expert's
    calls and rows, summed over layers); armed only: ``phase_ns`` per
    phase, ``armed_layers``, ``layer_ns`` (router launch to the last expert
    call's return, summed) and ``routed``
    (each armed layer's rows per expert, in order).  A layer run as steps
    (:func:`routed_experts_steps`) leaves out the host time its caller
    spends elsewhere at its yield: its ``route`` phase holds the wait for
    the counts that is left after it resumes."""
    s = _store
    return {
        "layers": s.layers,
        "tokens": s.tokens,
        "slots": s.slots,
        "max_rows": s.max_rows,
        "empty_experts": s.empty_experts,
        "count_reads": s.count_reads,
        "epilogue_calls": s.epilogue_calls,
        "copied_calls": s.copied_calls,
        "shared_calls": s.shared_calls,
        "shared_rows": s.shared_rows,
        "phase_ns": dict(zip(PHASES, s.phase_ns)),
        "armed_layers": s.armed_layers,
        "layer_ns": s.layer_ns,
        "routed": list(s.routed),
    }


def reset_moe_stats() -> None:
    global _store
    _store = _Store()


class _Clock:
    """One armed layer's phases: :meth:`mark` ends the current phase (its
    host ns into the store) and begins the next, each a span under a
    profiler."""

    __slots__ = ("phase", "t0", "t", "span", "away")

    def __init__(self) -> None:
        self.phase = 0
        self.span = _open(0) if tracing._profiling() else None
        self.t0 = self.t = self.away = time.perf_counter_ns()

    def pause(self) -> None:
        """The layer yields: what the host does until :meth:`resume` is not
        the layer's."""
        self.away = time.perf_counter_ns()

    def resume(self) -> None:
        gone = time.perf_counter_ns() - self.away
        self.t0 += gone
        self.t += gone

    def mark(self) -> None:
        t = time.perf_counter_ns()
        _store.phase_ns[self.phase] += t - self.t
        if self.phase == PHASES.index("experts"):
            _store.layer_ns += t - self.t0
        self.phase += 1
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = _open(self.phase) if self.phase < len(PHASES) else None
            t = time.perf_counter_ns()
        self.t = t


def _open(phase: int):
    span = torch.profiler.record_function(_SPANS[phase])
    span.__enter__()
    return span


class _CountRead:
    """The layer's one device-to-host read, begun at once: on the card a
    copy into pinned memory and an event recorded after it; :meth:`get`
    waits on the event (other host threads run meanwhile) and gives the
    counts as a list."""

    __slots__ = ("host", "event")

    def __init__(self, counts: torch.Tensor) -> None:
        self.host, self.event = counts, None
        if counts.device.type == "cuda":
            self.host = torch.empty(counts.shape, dtype=counts.dtype, pin_memory=True)
            self.host.copy_(counts, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()

    def get(self) -> list[int]:
        if self.event is not None:
            self.event.synchronize()
        return self.host.tolist()


def run_steps(steps):
    """Run a generator of steps (``routed_experts_steps``,
    ``lfm2_moe.prefill_steps``) to its end; returns what it returns."""
    while True:
        try:
            next(steps)
        except StopIteration as done:
            return done.value


def route_top_k(
    scores: torch.Tensor, bias: torch.Tensor, k: int, norm: bool, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(gates, experts)``, each (T, k): the k experts of largest
    ``scores + bias`` and their ``scores`` (f32), normalised to sum to one
    where ``norm``, times ``scale``."""
    experts = torch.topk(scores + bias, k, dim=-1).indices
    gates = scores.gather(-1, experts)
    if norm:
        gates = gates / (gates.sum(-1, keepdim=True) + NORM_EPS)
    return gates * scale, experts


def _rows_of(outs, buf: torch.Tensor, counts: list[int]) -> bool:
    """Whether ``outs`` are ``buf``'s rows, tenant after tenant, as views
    (an output with no rows only by its shape)."""
    if len(outs) != len(counts):
        return False
    storage, row = buf.untyped_storage().data_ptr(), buf.storage_offset()
    for o, t in zip(outs, counts):
        if o.dtype != buf.dtype or o.shape != (t, buf.shape[1]):
            return False
        if t and (
            o.untyped_storage().data_ptr() != storage
            or o.storage_offset() != row
            or o.stride() != buf.stride()
        ):
            return False
        row += t * buf.stride(0)
    return True


def _finished(outs, buf: torch.Tensor, counts: list[int], finish) -> torch.Tensor:
    """An expert call's output as one tensor: ``buf`` where ``outs`` are its
    rows (the epilogue ran); else the outputs concatenated, each float32
    one (a call that took no notice of the epilogue) as ``finish(o, row)``
    makes it, ``row`` its first row in the buffer."""
    s = _store
    if _rows_of(outs, buf, counts):
        s.epilogue_calls += 1
        return buf
    s.copied_calls += 1
    parts, row = [], 0
    for o, t in zip(outs, counts):
        parts.append(finish(o, row) if o.dtype == torch.float32 else o)
        row += t
    return torch.cat(parts)


def shared_expert(p: Params, x: torch.Tensor, gemm=fused_tenant_gemm) -> torch.Tensor:
    """The shared expert's SwiGLU on every row of ``x`` (T, d) bfloat16:
    gate‖up as one single-tenant call whose epilogue writes SiLU·up in
    bfloat16, then down into a (T, d) bfloat16 buffer.  ``p``:
    ``shared_gate_up`` (d, 2 f_s) with gate in the first f_s columns,
    ``shared_down`` (f_s, d)."""
    T, d = x.shape
    f = p["shared_down"].shape[0]
    act = x.new_empty((T, f))
    act = _finished(
        gemm([x], [p["shared_gate_up"]], epilogue="swiglu", out=act), act, [T],
        lambda o, row: F.silu(o[:, :f].to(x.dtype)) * o[:, f:].to(x.dtype),
    )
    y = x.new_empty((T, d))
    y = _finished(
        gemm([act], [p["shared_down"]], out=y), y, [T],
        lambda o, row: o.to(x.dtype),
    )
    s = _store
    s.shared_calls += 2
    s.shared_rows += T
    return y


def routed_experts(
    p: Params,
    x: torch.Tensor,
    top_k: int,
    *,
    norm: bool = True,
    scale: float = 1.0,
    gemm=fused_tenant_gemm,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The layer on ``x`` (T, d) bfloat16; returns ``(out, experts)``: the
    (T, d) bfloat16 output and each token's (T, top_k) chosen experts.

    ``p``: ``router`` (d, E), ``expert_bias`` (E,) f32, ``gate_up``
    (E, d, 2 f) with gate in the first f columns, ``down`` (E, f, d); and
    where the layer has a shared expert, ``shared_gate_up`` and
    ``shared_down`` (:func:`shared_expert`)."""
    return run_steps(
        routed_experts_steps(p, x, top_k, norm=norm, scale=scale, gemm=gemm)
    )


def routed_experts_steps(
    p: Params,
    x: torch.Tensor,
    top_k: int,
    *,
    norm: bool = True,
    scale: float = 1.0,
    gemm=fused_tenant_gemm,
):
    """:func:`routed_experts` as a generator that yields once, when the
    expert counts are on their way to the host and the card has the
    layer's routing queued: a caller with other work to enqueue (another
    batch's layers) does it there, and the card runs it while this layer's
    counts arrive and its launch tables are built.  A shared expert's
    calls are enqueued before the yield, behind the count read."""
    clock = _Clock() if tracing.armed else None
    T, d = x.shape
    n_experts = p["router"].shape[1]
    # route: f32 scores from the router GEMM's f32 output
    (logits,) = gemm([x], [p["router"]])
    gates, experts = route_top_k(
        torch.sigmoid(logits.float()), p["expert_bias"], top_k, norm, scale
    )
    flat = experts.reshape(-1)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=x.device)
    read = _CountRead(counts.index_add_(0, flat, torch.ones_like(flat)))
    shared = None
    if "shared_gate_up" in p:
        with tracing.span(SHARED_SPAN):
            shared = shared_expert(p, x, gemm)
    if clock is not None:
        clock.pause()
    yield
    if clock is not None:
        clock.resume()
    counts = read.get()
    s = _store
    s.layers += 1
    s.tokens += T
    s.slots += flat.numel()
    s.max_rows += max(counts)
    s.empty_experts += counts.count(0)
    s.count_reads += 1
    if clock is not None:
        s.routed.append(tuple(counts))
        clock.mark()

    # dispatch: slot j of token t is row t * top_k + j of ``flat``
    order = torch.argsort(flat, stable=True)
    rows = x.index_select(0, order // top_k)
    if clock is not None:
        clock.mark()

    # experts: every expert a tenant, with its own run of the sorted rows.
    # The epilogue (a compact launch) writes SiLU·up into ``act`` and each
    # slot's row times its gate into ``y``, both bfloat16
    n_slots, f = flat.numel(), p["gate_up"].shape[2] // 2
    act = x.new_empty((n_slots, f))
    act = _finished(
        gemm(list(rows.split(counts)), list(p["gate_up"].unbind(0)),
             epilogue="swiglu", out=act),
        act, counts,
        lambda o, row: F.silu(o[:, :f].to(x.dtype)) * o[:, f:].to(x.dtype),
    )
    slot_gates = gates.reshape(-1)[order]
    y = x.new_empty((n_slots, d))
    y = _finished(
        gemm(list(act.split(counts)), list(p["down"].unbind(0)),
             row_scale=slot_gates, out=y),
        y, counts,
        lambda o, row: o.to(x.dtype).float() * slot_gates[row : row + len(o), None],
    )
    if clock is not None:
        clock.mark()

    # combine: back in (token, slot) order by a gather, summed in f32
    by_token = torch.empty_like(order)
    by_token[order] = torch.arange(n_slots, device=order.device)
    out = y.index_select(0, by_token).view(T, top_k, d).sum(1, dtype=torch.float32)
    if shared is not None:
        out += shared
    if clock is not None:
        clock.mark()
        s.armed_layers += 1
    return out.to(x.dtype), experts
