"""GEMM rounds: the paper's workload replayed round after round, closed loop.

Every tenant starts its layer 0 together.  Wave ``w`` of a round is ONE
call of the program, ``fused_tenant_gemm(xs, ws, grid_mode="auto")``, over
layer ``w`` of every tenant that still has one; a tenant past its last layer
drops out of the later waves (the paper's release and merge), and the round
ends with the longest DNN's last layer.  A layer's T is the configuration's
batch-1 rows times the mix's batch.

Every layer's input and weights are drawn once at set-up from the seed, on
the device, in a few large calls; layers are not chained.  The host enqueues
a round's waves without synchronising and keeps at most
``rounds_in_flight`` rounds queued: it waits for the oldest only when that
many are.  A round is complete when its last wave's outputs are ready.

The window runs ``seconds`` and ends with the first round that completes
after them; ``workload_ms`` is its length over the rounds completed.  One
round, drawn from the seed among the first ``CHECK_ROUNDS`` of the window,
runs with a weight set of its own (so no output of another round can pass
for its own) and keeps its outputs; after the window every tenant's output
of that round is held against the plain reference.  A traced run profiles
enough whole rounds inside the window for ``TRACE_LAUNCHES`` launches,
from round ``TRACE_AFTER_ROUNDS`` on.
"""

from __future__ import annotations

import math
import random
import time
from collections import deque
from contextlib import nullcontext
import torch

from cardbench import roofline
from cardbench import trace as tracing

# the program's kernels, by the names the profiler gives them
KERNELS = ("dense_kernel", "compact_kernel")
# elements drawn a call, and the element boundary every operand starts on
# (512 bytes in bfloat16, as the caching allocator aligns a tensor)
CHUNK = 1 << 30
ALIGN = 256
# the checked round is one of the window's first CHECK_ROUNDS; a traced run
# profiles whole rounds from round TRACE_AFTER_ROUNDS on, enough for
# TRACE_LAUNCHES launches
CHECK_ROUNDS = 16
TRACE_AFTER_ROUNDS = 8
TRACE_LAUNCHES = 300


def waves(cfg: dict, batch: int) -> list[list[tuple[int, tuple[int, int, int]]]]:
    """Wave ``w``: ``(tenant, (T * batch, K, N))`` for each tenant with a
    layer ``w``."""
    tabs = [t["layers"] for t in cfg["tenants"]]
    return [
        [
            (i, (tab[w][1] * batch, tab[w][2], tab[w][3]))
            for i, tab in enumerate(tabs)
            if w < len(tab)
        ]
        for w in range(max(len(t) for t in tabs))
    ]


def draw(plan, weight_sets: int, dtype, device, seed: int):
    """Every wave's x once and ``weight_sets`` sets of its w, as views of one
    flat buffer filled with standard normals from ``seed`` in ``CHUNK``-sized
    calls.  Returns ``(xs, ws)``: ``xs[w][j]``, ``ws[s][w][j]``."""
    shapes = [[(t, k) for _, (t, k, _) in m] for m in plan]
    for _ in range(weight_sets):
        shapes += [[(k, n) for _, (_, k, n) in m] for m in plan]
    offsets, total = [], 0
    for row in shapes:
        offsets.append([])
        for a, b in row:
            offsets[-1].append(total)
            total += -(-(a * b) // ALIGN) * ALIGN
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for a in range(0, total, CHUNK):
        flat[a : a + CHUNK].normal_(generator=gen)
    views = [
        [flat[o : o + a * b].view(a, b) for o, (a, b) in zip(offs, row)]
        for offs, row in zip(offsets, shapes)
    ]
    n = len(plan)
    return views[:n], [views[n + s * n : n + (s + 1) * n] for s in range(weight_sets)]


class _Done:
    """Marks the end of a round's work on the device's stream."""

    def __init__(self, device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()


def _span(name: str, on: bool):
    return torch.profiler.record_function("cardbench." + name) if on else nullcontext()


class _Loop:
    """The closed loop: rounds enqueued, at most ``depth`` in flight."""

    def __init__(self, program, xs, device, depth: int):
        self.program, self.xs, self.device, self.depth = program, xs, device, depth
        self.inflight: deque = deque()
        self.done = 0
        self.last = 0.0
        self.enqueue_s = 0.0
        self.calls = 0
        # host seconds each untraced round took to enqueue, and the host
        # clock at each round's completion
        self.round_enqueue: list = []
        self.completions: list = []

    def round(self, ws, keep=None, traced=False, span="round"):
        """Enqueue one round; then, with ``depth`` rounds queued, wait for
        the oldest."""
        enqueue = 0.0
        with _span(span, traced):
            for w, xw in enumerate(self.xs):
                with _span(f"wave{w}", traced):
                    t = time.perf_counter()
                    outs = self.program(xw, ws[w], grid_mode="auto")
                    enqueue += time.perf_counter() - t
                if keep is not None:
                    keep.append(outs)
            self.inflight.append(_Done(self.device))
        if not traced:
            self.enqueue_s += enqueue
            self.calls += len(self.xs)
            self.round_enqueue.append(enqueue)
        if len(self.inflight) >= self.depth:
            self.retire(traced)

    def retire(self, traced=False):
        with _span("wait", traced):
            self.inflight.popleft().wait()
        self.done += 1
        self.last = time.perf_counter()
        self.completions.append(self.last)

    def drain(self, traced=False):
        while self.inflight:
            self.retire(traced)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(
    cfg, mix, reference, *, seed, seconds, trace, device, t_start, program, out_dir
):
    """One run of a cell: set-up, the window, the check.  Returns the run's
    record, which the metric readers read."""
    from repro_torch.kernels import _build, launch_counts

    dtype = cfg["dtype"]
    plan = waves(cfg, mix["batch"])
    names = [t["name"] for t in cfg["tenants"]]
    xs, (ws, ws_check) = draw(plan, 2, getattr(torch, dtype), device, seed)
    depth = mix["rounds_in_flight"]

    # two warm rounds fill the autotune and launch-table caches.  The first
    # holds its outputs, as the checked round will, so the second allocates
    # the blocks a round needs beside them: no cudaMalloc is left for the
    # window (with one warm round, one round early in the window stalled
    # 0.07-1.2 s on fresh allocations)
    held: list = []
    for keep in (held, None):
        warm = _Loop(program, xs, device, depth)
        warm.round(ws, keep=keep)
        warm.drain()
    del held
    _sync(device)
    build_s = _build.last_build_seconds

    check_at = random.Random(seed).randrange(CHECK_ROUNDS)
    trace_at = TRACE_AFTER_ROUNDS if trace else -1
    trace_rounds = math.ceil(TRACE_LAUNCHES / len(plan))
    kept: list = []
    traced = None
    launches0 = launch_counts()
    loop = _Loop(program, xs, device, depth)
    r = 0

    def step(traced_round=False, span="round"):
        nonlocal r
        check = r == check_at
        weights, keep = (ws_check, kept) if check else (ws, None)
        loop.round(weights, keep, traced_round, span)
        r += 1

    t0 = loop.last = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        if r == trace_at:
            # the profiler's first round is its own warm-up: traced, drained,
            # then left out of the traced window
            loop.drain()
            with tracing.profiler() as prof:
                step(True, "warmup")
                loop.drain(traced=True)
                for _ in range(trace_rounds):
                    step(True)
                loop.drain(traced=True)
            traced = tracing.read(prof, out_dir / "trace.json")
        else:
            step()
        if loop.last - t0 >= seconds and loop.done and (traced or not trace):
            break
    window_s, rounds = loop.last - t0, loop.done
    while r <= check_at:  # a window too short for the checked round: run on
        step()
    loop.drain()
    _sync(device)
    launches = {k: v - launches0[k] for k, v in launch_counts().items()}
    cuda = device.type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    done = loop.completions[:rounds]
    intervals = [b - a for a, b in zip([t0, *done], done)]
    record = {
        "setup_s": setup_s,
        "build_s": build_s,
        "window_s": window_s,
        "rounds": rounds,
        "gemms_per_round": sum(len(m) for m in plan),
        "peak_flops": roofline.PEAK_FLOPS[dtype],
        "enqueue_s": loop.enqueue_s,
        "calls": loop.calls,
        "round_s": intervals,
        "round_enqueue_s": loop.round_enqueue,
        "launches": launches,
        "memory_peak_bytes": memory_peak,
        "check_round": check_at,
        "trace": None,
    }
    del loop

    # an output the program never returned compares as None: infinite
    outs = [kept[w] if w < len(kept) else [] for w in range(len(plan))]
    gemms = [
        (xs[w][j], ws_check[w][j], outs[w][j] if j < len(outs[w]) else None)
        for w in range(len(plan))
        for j in range(len(plan[w]))
    ]
    t = time.perf_counter()
    worst, compared, over = reference.worst_gap(gemms)
    record.update(
        check={"max_rel_err": worst},
        limits=dict(reference.LIMITS),
        compared=compared,
        failed=over,
        check_s=time.perf_counter() - t,
    )
    if traced is not None:
        shapes = [[s for _, s in m] for m in plan]
        bounds = [roofline.call_bound_s(s, dtype) for s in shapes]
        flops = [roofline.call_flops(s) for s in shapes]
        record["trace"] = _traced(
            traced, plan, names, bounds, flops, trace_rounds, out_dir
        )
    return record


def _traced(traced, plan, names, bounds, flops, rounds, out_dir):
    """The profiled rounds: their FLOPs and bounds, the program's kernels
    matched to the calls in launch order (one launch a call), and the
    per-wave table written beside the chrome trace."""
    kernels = [e for e in traced["device"] if any(k in e[0] for k in KERNELS)]
    n = len(plan)
    matched = bool(kernels) and len(kernels) == rounds * n
    times: list = [[] for _ in plan]
    modes: list = [set() for _ in plan]
    if matched:
        for i, (name, _, dur) in enumerate(kernels):
            times[i % n].append(dur * 1e-6)
            modes[i % n].add("dense" if "dense_kernel" in name else "compact")
    path = out_dir / "waves.tsv"
    lines = ["wave\ttenants\tmode\tbound_ms\tkernel_ms"]
    for w, m in enumerate(plan):
        tenants = ",".join(names[i] for i, _ in m)
        mode = "/".join(sorted(modes[w])) or "not measured"
        kernel = "not measured"
        if times[w]:
            kernel = f"{1e3 * sum(times[w]) / len(times[w]):.6f}"
        lines.append(f"{w}\t{tenants}\t{mode}\t{1e3 * bounds[w]:.6f}\t{kernel}")
    path.write_text("\n".join(lines) + "\n")
    return {
        "window_s": traced["window_s"],
        "busy_s": traced["busy_s"],
        "rounds": rounds,
        "flops": rounds * sum(flops),
        "bound_s": rounds * sum(bounds),
        "kernels": len(kernels),
        "kernel_s": sum(d for _, _, d in kernels) * 1e-6 if matched else None,
        "device_ops": traced["device_ops"],
        "idle_gaps": traced["idle_gaps"],
        "table": str(path),
    }
