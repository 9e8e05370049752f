"""Prefill rounds: a model's prefill of a batch of prompts, round after
round, closed loop.

A round is one forward (``repro_torch.models.lfm2_moe.prefill``) of the
mix's ``prompts`` prompts of ``prompt_tokens`` tokens through every layer,
ending in each prompt's last-position logits; every projection is a call of
the program (``fused_tenant_gemm`` by default).  Weights are drawn once at
set-up from the seed, on the device.  Each round's token ids are drawn
afresh on the device from ``(seed, round)``, uniform over the vocabulary,
so the routing, and with it every expert call's geometry, changes from
round to round.  The host reads each MoE layer's expert counts, so a round
alone leaves the card idle while the host builds the next launch; the
closed loop keeps ``rounds_in_flight`` rounds in flight and interleaves
their host work (:class:`_Interleaved`), as a server with several prefill
batches does.

The window runs ``seconds`` between two completions of one lane, and
never closes before the checked round has completed; ``workload_ms`` is its
length over every lane's rounds completed in it.  One of the loop's first
``CHECK_ROUNDS`` rounds, drawn from the seed, keeps every layer's input and
output and every MoE layer's chosen experts; after the window the reference
works every layer out again from the program's own input to it
(teacher-forced).  A traced run goes on in the same loop after the window,
the rounds still in flight: it arms the program's tracing and profiles a
warm-up until every lane runs a round begun armed, then ``TRACE_ROUNDS``
completions, each program call logged with its shapes, so the per-layer
metrics read the loop as the window runs it.
"""

from __future__ import annotations

import itertools
import json
import random
import time
from collections import deque
from contextlib import nullcontext

import torch

from cardbench import lfm2_roofline, roofline
from cardbench import trace as tracing

KERNELS = ("dense_kernel", "compact_kernel")
CHECK_ROUNDS = 16
TRACE_ROUNDS = 4
EXPERTS_SPAN = "repro_torch.moe.experts"
# chrome-trace categories of the host's launch calls
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def round_seed(seed: int, r: int) -> int:
    """The seed of round ``r``'s token ids (rounds below 2**20 distinct)."""
    return ((seed << 20) + r) % (1 << 64)


def call_plan(model) -> list[tuple[int, str, bool]]:
    """The program's calls a round in launch order: ``(layer, part,
    expert)``; layer -1 is the output head."""
    plan = []
    for i, kind in enumerate(model.layer_types):
        if kind == "conv":
            plan += [(i, "in_proj", False), (i, "out_proj", False)]
        else:
            plan += [(i, "qkv", False), (i, "o_proj", False)]
        if model.is_moe(i):
            plan += [(i, "router", False), (i, "gate_up", True), (i, "down", True)]
        else:
            plan += [(i, "w1_w3", False), (i, "w2", False)]
    return plan + [(-1, "head", False)]


def _span(name: str, on: bool):
    return torch.profiler.record_function("cardbench." + name) if on else nullcontext()


class _CallLog:
    """The program's calls in the host's order while :attr:`on`: each as
    its round's call index and its tenants' ``(T, K, N)`` shapes, tenants
    with no rows left out (their weights are never read)."""

    def __init__(self):
        self.on = False
        self.calls: list = []

    def wrap(self, program):
        """``program`` with each call a round makes logged while on."""
        index = itertools.count()

        def call(xs, ws, **kw):
            c = next(index)
            if self.on:
                shapes = [
                    (x.shape[0], x.shape[1], w.shape[1])
                    for x, w in zip(xs, ws)
                    if x.shape[0]
                ]
                self.calls.append((c, shapes))
            return program(xs, ws, **kw)

        return call


class _Interleaved:
    """The closed loop, on one host thread: ``depth`` rounds in flight, each
    a generator of steps (``lfm2_moe.prefill_steps``) that pauses at every
    MoE layer's count read.  The host runs the rounds' steps in turn, so the
    card runs one round's kernels while the host waits for another's
    counts and builds its launch tables.  A round whose steps are done is
    waited for, its completion timed on the host clock, and the next round
    takes its place: round ``r`` runs in lane ``r % depth``."""

    def __init__(self, steps, depth: int, device, keep_round: int, kept, held):
        self.steps, self.depth, self.device = steps, depth, device
        self.keep_round, self.kept, self.held = keep_round, kept, held
        self.next = 0
        self.lanes: deque = deque()
        self.finished: set = set()

    def _start(self) -> None:
        r, self.next = self.next, self.next + 1
        keep = None
        if r == self.keep_round:
            # the warm round's kept tensors go as this round's are made, so
            # it finds their blocks free in the allocator's cache
            self.held.clear()
            keep = self.kept
        self.lanes.append((r, self.steps(r, keep), time.perf_counter()))

    def _step(self):
        """One step of the next lane in turn; at a round's end, ``(round,
        host clock, host seconds from the round's start)`` and the next
        round started in its lane, else ``None``."""
        if not self.lanes:
            for _ in range(self.depth):
                self._start()
        r, steps, began = self.lanes.popleft()
        try:
            next(steps)
        except StopIteration:
            _sync(self.device)
            now = time.perf_counter()
            self.finished.add(r)
            self._start()
            return r, now, now - began
        self.lanes.append((r, steps, began))
        return None

    def run(self, seconds: float, last: int):
        """The timed window: it opens at lane 0's first completion after
        every lane has completed a round (the rounds before it are set-up),
        and closes at lane 0's first completion ``seconds`` after it opened
        once round ``last`` has completed; its rounds are every lane's
        completions in it, so the lanes' phase does not bias it.  Returns
        ``(t0, t1, completions)``: the window and the completions in ``(t0,
        t1]`` as ``(host clock, host seconds from the round's start)``.
        The lanes stay in flight."""
        done, t0 = [], None
        while True:
            end = self._step()
            if end is None:
                continue
            r, now, took = end
            done.append((now, r % self.depth, took))
            if r % self.depth:
                continue
            if t0 is None:
                if {lane for _, lane, _ in done} == set(range(self.depth)):
                    t0 = now
            elif now - t0 >= seconds and last in self.finished:
                return t0, now, [(t, d) for t, _, d in done if t0 < t <= now]

    def more(self, rounds: int) -> None:
        """Step on until ``rounds`` more rounds have completed."""
        while rounds:
            rounds -= self._step() is not None

    def from_round(self, first: int) -> None:
        """Step on until every lane runs round ``first`` or a later one."""
        while min(r for r, _, _ in self.lanes) < first:
            self._step()

    def drain(self) -> None:
        """Run every lane's round to its end; start no other."""
        while self.lanes:
            r, steps, _ = self.lanes.popleft()
            for _ in steps:
                pass
            self.finished.add(r)
        _sync(self.device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(
    cfg, mix, reference, *, seed, seconds, trace, device, t_start, program, out_dir
):
    """One run of a cell: set-up, the window, the check.  Returns the run's
    record, which the metric readers read."""
    from repro_torch.kernels import _build, launch_counts, set_tracing
    from repro_torch.models import lfm2_moe
    from repro_torch.models.routed_experts import moe_stats, reset_moe_stats

    model = lfm2_moe.Lfm2MoeConfig.from_config(cfg)
    B, S = mix["prompts"], mix["prompt_tokens"]
    params = lfm2_moe.init_params(model, seed=seed, device=device)
    log = _CallLog()
    calls = [0]

    def counted(xs, ws, **kw):
        calls[0] += 1
        return program(xs, ws, **kw)

    def steps(r, keep, gemm=program):
        gen = torch.Generator(device=device)
        gen.manual_seed(round_seed(seed, r))
        ids = torch.randint(0, model.vocab_size, (B, S), generator=gen, device=device)
        logits = yield from lfm2_moe.prefill_steps(
            params, model, ids, gemm=log.wrap(gemm), keep=keep
        )
        if keep is not None:
            keep["logits"] = logits

    # a warm round fills the autotune and launch-table caches, keeps what
    # the checked round will (held until that round starts: no cudaMalloc
    # is left for the window) and counts the program's calls; then the
    # loop's first rounds, before the window opens
    held: dict = {}
    for _ in steps(-1, held, gemm=counted):
        pass
    _sync(device)
    build_s = _build.last_build_seconds

    check_at = random.Random(seed).randrange(CHECK_ROUNDS)
    kept: dict = {}
    launches0 = launch_counts()
    depth = mix["rounds_in_flight"]
    loop = _Interleaved(steps, depth, device, check_at, kept, held)
    t0, t1, window = loop.run(seconds, check_at)
    setup_s = t0 - t_start
    launches = {k: v - launches0[k] for k, v in launch_counts().items()}

    # a traced run goes on in the same loop, the program's tracing armed,
    # under the profiler: warm-up until every lane runs a round begun
    # armed, then TRACE_ROUNDS completions in one span, each call logged
    traced = armed = None
    if trace:
        was = set_tracing(True)
        try:
            with tracing.profiler() as prof:
                with _span("warmup", True):
                    loop.from_round(loop.next)
                reset_moe_stats()
                log.on = True
                with _span("round", True):
                    loop.more(TRACE_ROUNDS)
                log.on = False
                _sync(device)
            armed = moe_stats()
        finally:
            set_tracing(was)
        traced = tracing.read(prof, out_dir / "trace.json")
    loop.drain()
    cuda = device.type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    done = [t for t, _ in window]
    record = {
        "setup_s": setup_s,
        "build_s": build_s,
        "window_s": t1 - t0,
        "rounds": len(window),
        "gemms_per_round": calls[0],
        "peak_flops": roofline.PEAK_FLOPS[cfg["dtype"]],
        "round_s": [b - a for a, b in zip([t0, *done], done)],
        "round_enqueue_s": [d for _, d in window],
        "launches": launches,
        "memory_peak_bytes": memory_peak,
        "check_round": check_at,
        "moe": armed,
        "trace": None,
    }
    del loop

    t = time.perf_counter()
    checks, compared, over = reference.worst_gap(
        params, cfg, kept, kept.get("logits"), B
    )
    record.update(
        check=checks,
        limits=dict(reference.LIMITS),
        compared=compared,
        failed=over,
        check_s=time.perf_counter() - t,
    )
    if traced is not None:
        record["trace"] = _traced(
            traced, model, cfg, B, S, armed, log.calls, out_dir / "trace.json", out_dir
        )
    return record


def _launched(path):
    """The program's kernels in the chrome trace at ``path`` whose launch
    the host made inside the ``cardbench.round`` span, matched to their
    launch by correlation id, in launch order: ``(durations in seconds,
    those of them launched inside a repro_torch.moe.experts span)``;
    ``None`` where the trace holds no launch event for them."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, launches, kernels, rounds = [], {}, [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        corr = (e.get("args") or {}).get("correlation")
        ts, dur = float(e["ts"]), float(e["dur"])
        if e.get("cat") == "kernel" and any(k in e.get("name", "") for k in KERNELS):
            kernels.append((corr, dur))
        elif e.get("cat") in LAUNCH_CATS and corr is not None:
            launches[corr] = ts
        elif e.get("cat") == "user_annotation" and e.get("name") == EXPERTS_SPAN:
            spans.append((ts, ts + dur))
        elif e.get("cat") == "user_annotation" and e.get("name") == "cardbench.round":
            rounds.append((ts, ts + dur))
    if not rounds or not any(c in launches for c, _ in kernels):
        return None
    a, b = rounds[0]
    inside = sorted(
        (launches[c], d) for c, d in kernels if c in launches and a <= launches[c] <= b
    )
    experts = [d for t, d in inside if any(s <= t <= e for s, e in spans)]
    return [1e-6 * d for _, d in inside], 1e-6 * sum(experts), len(experts)


def _traced(traced, model, cfg, B, S, armed, calls, path, out_dir):
    """The profiled rounds: their FLOPs, the expert calls' bound and
    kernels, and the per-call table written beside the chrome trace: each
    of a round's calls (``call_plan``) with its mean bound over the logged
    calls and the mean device time of the kernels they launched (one a
    call, matched in launch order)."""
    d, f = model.hidden_size, model.moe_intermediate_size
    plan = call_plan(model)
    routed = (armed or {}).get("routed", [])
    kernels = [e for e in traced["device"] if any(k in e[0] for k in KERNELS)]
    launched = _launched(path)
    matched = launched is not None and len(launched[0]) == len(calls)
    bounds: list = [[] for _ in plan]
    times: list = [[] for _ in plan]
    for i, (c, shapes) in enumerate(calls):
        bounds[c].append(roofline.call_bound_s(shapes, cfg["dtype"]))
        if matched:
            times[c].append(launched[0][i])
    lines = ["call\tlayer\tpart\tcalls\tbound_ms\tkernel_ms"]
    for c, (layer, part, _) in enumerate(plan):
        bound = f"{1e3 * sum(bounds[c]) / len(bounds[c]):.6f}" if bounds[c] else "-"
        kernel = "not measured"
        if times[c]:
            kernel = f"{1e3 * sum(times[c]) / len(times[c]):.6f}"
        lines.append(f"{c}\t{layer}\t{part}\t{len(bounds[c])}\t{bound}\t{kernel}")
    table = out_dir / "calls.tsv"
    table.write_text("\n".join(lines) + "\n")
    return {
        "window_s": traced["window_s"],
        "busy_s": traced["busy_s"],
        "rounds": TRACE_ROUNDS,
        "flops": TRACE_ROUNDS * lfm2_roofline.round_flops(cfg, B, S)["total"],
        "expert_bound_s": lfm2_roofline.experts_bound_s(routed, d, f, cfg["dtype"]),
        "expert_kernels": launched[2] if launched else 0,
        "expert_kernel_s": launched[1] if launched else None,
        "calls": len(calls),
        "kernels": len(kernels),
        "device_ops": traced["device_ops"],
        "idle_gaps": traced["idle_gaps"],
        "table": str(table),
    }
