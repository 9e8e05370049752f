"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on a failed
check:

1. Environment: the card (``nvidia-smi`` name and power limit), torch, CUDA,
   ``nvcc``; TF32 is switched off; the CUDA kernels are built from the
   checkout's sources, and ``ptxas -v`` (registers, spills) and the count of
   tensor-core (``HMMA``) instructions in each kernel's SASS are logged.
2. Kernels: ``fused_tenant_gemm`` — the port's main kernel path — runs the
   three ``benchmarks/kernel_bench.py`` mixes (block 128), a mix of odd
   depths and widths (every operand row off 16-byte alignment) and two
   full-width rounds of the paper's heavy workload (layer 0 of each of the 8
   tenants, and each tenant's largest GEMM, partition blocks autotuned), in
   float32 and bfloat16, in dense and in compact mode.  The launch counters
   are zeroed just before that run and read just after it.  Then each kernel
   is held against its plain version on the card: max relative error < 1e-4
   on random operands, and bit-exact dense == compact == plain on
   integer-valued operands through the stacked API, whose output is
   allocated over garbage so that an unwritten byte shows.  The full-width
   rounds are timed with CUDA events, in turns: ``partitioned_matmul`` on
   the padded operands beside its plain version, ``fused_tenant_gemm`` on
   the tenants' own tensors (the main path), and ``sequential_tenant_gemm``
   (one ``torch.matmul`` per tenant) as the library yardstick; each kernel's
   device time comes from ``torch.profiler`` and each entry point's host
   enqueue time from the host clock.  The ``FusedGemmStats`` of every
   full-width main-path call are folded (``record_gemm_stats``) into one
   ``repro_torch.obs.MetricsRegistry`` with the host caches
   (``snapshot_host_caches``), outside the timed loops; the call count is
   checked and the registry printed.
3. Serving: a ``MultiTenantEngine`` over the card as one column serves two
   full-width, full-depth llama3.2-3b tenants (random bf16 weights from a
   seeded generator on the card), 3 requests each, to completion; the
   decode step is also checked against the CPU on the smoke config.
   Families: the smoke configs of phi3.5-moe, dbrx, mamba2, recurrentgemma
   and whisper decode ragged steps (a random live set, the hybrid's ring
   wrapping) on the card and on the CPU within 3e-2; then one
   ``MultiTenantEngine`` on the card serves four tenants at their published
   widths, random bf16 weights: mamba2-780m, recurrentgemma-2b and
   whisper-small at full depth, phi3.5-moe-42b-a6.6b at 16 of its 32
   layers (the whole model does not fit beside the others), 3 requests
   each, to completion.  Per tenant: tokens/s, rounds, decode-step host,
   profiled and device ms, busy share, the bytes one step must move over
   3.35 TB/s, resident and peak memory, init s.  No partitioned-GEMM
   kernel is launched (checked), and the phase fits in 120 s.
4. Paper: the port's front door, ``Session(policy, "sim").run(workload)``,
   for each of the nine registered policies on the paper's heavy and light
   workloads (Fig. 9).  This path is host arithmetic (Python and NumPy) and
   launches no kernel: the launch counters are zeroed before it and must
   read zero after it.  ``equal`` must reproduce the golden seed traces
   ``tests/data/seed_trace_{heavy,light}.json`` hex for hex, and every
   policy must beat the sequential baseline on makespan or on turnaround.
   One line per run: policy, workload, savings, makespan and host wall ms
   (cost-model caches cleared before each run, so each is a cold run).
5. Serve: open-loop serving, ``repro_torch.traffic`` (``Session.serve``,
   ``TrafficSimulator``, ``ShardedTrafficSimulator``), in a fresh child
   interpreter with the card hidden from it: the sharded cell forks its
   pods, and a fork of this process, which holds CUDA state and threads,
   is unsafe.  The child runs ``benchmarks/traffic_bench.py``'s
   matrix and its jsq/p2c cluster block, one run per armed feature
   (preemption, memory contention, migration, fairness accounting),
   ``benchmarks/scale_bench.py``'s 10,000-job, 64-array cell and the
   100,000-job, 256-array, 8-pod forked cell of ``BENCH_fairness.json``.
   Every seeded field of every run must equal ``tests/data/serve_golden.json``
   (made from the JAX package, ``tests/test_torch_traffic.py``), and the
   path must launch no kernel.  Wall time, events/s and jobs/s are printed.
   The child, and every pipe read of the pods, has a time limit.  Then, in
   the same child, fault injection, overload control and observability:
   every cell of ``benchmarks/chaos_bench.py`` (a seeded plan, crash under
   ``retry_restart`` and ``none``, degrade, straggler, a sharded
   ``pod_kill`` that must raise ``PodFailureError``),
   ``benchmarks/overload_bench.py`` (``static``, ``codel`` and ``brownout``
   arms, the pod respawn cell serial and forked) and
   ``benchmarks/obs_bench.py``'s trace cell (Perfetto JSON exported twice,
   identical bytes, into ``build/traces``); the 10,000-job cell with faults,
   brownout and obs armed; the 100,000-job, 8-pod cell with obs, a
   ``pod_kill`` and respawn.  Every seeded field must equal
   ``tests/data/resilience_golden.json`` (``tests/test_torch_chaos.py``), with
   no kernel launched.  Last, the obs overhead pair of ``obs_bench.py``
   (CPU time, alternated, minimum per side, at most 720 s of rounds):
   armed and off serialize the same bytes, and the armed ratio must stay
   within 1.05.
6. Mesh: the ``mesh`` backend's constants measured on the card beside
   ``MeshLatencyModel()``'s defaults (each must lie within 2x of its
   default): the bf16 rate of ``fused_tenant_gemm`` on the heavy_max round
   in device time, the calls queued behind a spin kernel so that the host
   is out of the timing (``torch.matmul``'s beside it), a pinned 256 MiB
   host-to-device copy, and the host enqueue of a one-tenant
   ``fused_tenant_gemm`` call (a one-element ``add_`` beside it); then
   ``Session(policy, "mesh").run(workload)`` for every policy and workload.

The last lines are the kernels' JSON record, the card line, and
``{"ok": true, "device": {...}}``.  Without CUDA the script exits non-zero
and prints no result.

    python3 chip_smoke.py --obs-split

needs no card and is not part of the run above: it prints where the armed
side of the obs overhead pair spends its time, part by part and module by
module (:func:`obs_split`).
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import hashlib
import importlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
MAX_REL_ERR = 1e-4  # benchmarks/kernel_bench.py's bound
BF16_TOL = 3e-2  # bf16 decode logits, CPU vs card (tests/test_torch_models.py)
TIMING_TURNS = 5  # turns of (dense, compact, fused, library) and back
CALLS_PER_SAMPLE = 3
FULL_WIDTH = ("heavy_l0", "heavy_max")
DTYPES = ("float32", "bfloat16")
MODES = ("dense", "compact")
ENQUEUE_CALLS = 50  # calls timed on the host clock without a synchronise
KERNEL_FILE = "src/repro_torch/kernels/csrc/partitioned_matmul.cu"
PAPER_WORKLOADS = ("heavy", "light")
PAPER_POLICIES = [
    "best_fit",
    "deadline_preempt",
    "drf",
    "equal",
    "min_cost_flow",
    "moca",
    "priority",
    "proportional",
    "width_aware",
]
GOLDEN = "tests/data/seed_trace_{}.json"
SERVE_GOLDEN = "tests/data/serve_golden.json"
SERVE_FLAG = "--serve-phase"  # the child process of the serve phase
OBS_SPLIT_FLAG = "--obs-split"  # the armed side's time by part (not run by default)
OBS_SPLIT_PASSES = 16
# the whole serve phase, child included: its cells take under a minute on the
# card's host, and the obs overhead pair starts no round past OBS_WALL_S
SERVE_TIMEOUT_S = 960
POD_TIMEOUT_S = 300.0  # any one pipe read of a sharded pod
SEED = 0
# benchmarks/traffic_bench.py's matrix
TRAFFIC_PROCESSES = ("poisson", "mmpp", "diurnal")
TRAFFIC_POLICIES = ("equal", "proportional", "best_fit", "width_aware")
TRAFFIC_LOADS = (0.4, 0.9, 1.5)
TRAFFIC_JOBS = 40
SCALE_CELL = (10_000, 64)  # scale_bench.py's largest cell: jobs, arrays
SHARDED_CELL = (100_000, 256, 8)  # BENCH_fairness.json: jobs, arrays, pods
MESH_TOLERANCE = 2.0  # a measured constant this far off its default fails
MESH_REPEATS = 7
SPIN_CYCLES = 20_000_000  # a spin kernel that holds the stream for ~10 ms
H2D_BYTES = 256 << 20
# the families phase: one tenant per family at its published width, beside
# the smoke configs checked card against CPU; phi3.5-moe keeps 16 of its 32
# layers (the whole model, 83.7 GB in bf16, does not fit beside the others)
FAMILY_TENANTS = (
    ("mamba2-780m", None),
    ("recurrentgemma-2b", None),
    ("whisper-small", None),
    ("phi3.5-moe-42b-a6.6b", 16),
)
FAMILY_SMOKES = (
    "phi3.5-moe-42b-a6.6b",
    "dbrx-132b",
    "mamba2-780m",
    "recurrentgemma-2b",
    "whisper-small",
)
SMOKE_STEPS = 8  # card-vs-CPU decode steps of each smoke config
FAMILY_SLOTS, FAMILY_MAX_SEQ = 4, 128
FAMILY_REQUESTS, FAMILY_PROMPT, FAMILY_NEW = 3, 8, 16
FAMILY_PHASE_S = 120.0
TPU_KERNEL = {
    "dense": "src/repro/kernels/partitioned_matmul.py:261",
    "compact": "src/repro/kernels/partitioned_matmul.py:335",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# 1. environment
# ---------------------------------------------------------------------------


def environment(torch, build) -> str:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    nvcc = subprocess.run(
        [build._nvcc(), "--version"], capture_output=True, text=True, check=True
    )
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(
        f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}"
    )
    t0 = time.perf_counter()
    build.load()
    log(
        f"kernels built in {build.last_build_seconds:.2f} s "
        f"(loaded in {time.perf_counter() - t0:.2f} s) -> {build.library_path()}"
    )
    return card


def kernel_name(symbol: str) -> str | None:
    """``dense/bfloat16`` etc. for a mangled kernel symbol."""
    for mode in MODES:
        if f"{mode}_kernel" in symbol:
            dt = "bfloat16" if "bfloat16" in symbol else "float32"
            return f"{mode}/{dt}"
    return None


def build_details(build) -> dict:
    """Per kernel instantiation: registers, spills and static shared memory
    from ``ptxas -v``, dynamic shared memory from the library, and the
    tensor-core instructions in its SASS (``cuobjdump``, where the toolkit
    has it)."""
    details, name = {}, None
    for line in build.ptxas_log().splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
        if m:
            name = kernel_name(m.group(1))
            if name:
                details.setdefault(name, {})
            continue
        if not name:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            details[name]["spill_stores"] = int(m.group(1))
            details[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            details[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            details[name]["static_smem"] = int(sm.group(1)) if sm else 0
    lay = build.layout()
    for name, d in details.items():
        d["dynamic_smem"] = lay["smem_" + name.split("/")[1]]
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    if cuobjdump.exists():
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(build.library_path())],
            capture_output=True,
            text=True,
            check=True,
        ).stdout
        name = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = kernel_name(m.group(1))
                if name:
                    details.setdefault(name, {}).setdefault("hmma", 0)
            elif name and re.search(r"\b[HG]MMA", line):
                details[name]["hmma"] += 1
    log(f"build details: {json.dumps(details, sort_keys=True)}")
    for mode in MODES:
        d = details.get(f"{mode}/bfloat16", {})
        check(d.get("hmma", 1) > 0, f"{mode}/bfloat16 has no tensor-core instruction")
        check("registers" in d, f"ptxas reported nothing for {mode}/bfloat16")
    return details


# ---------------------------------------------------------------------------
# 2. kernels
# ---------------------------------------------------------------------------


def gemm(layer) -> tuple[int, int, int]:
    """A layer's GEMM as (T, K, N): streamed rows, reduction depth, columns."""
    return layer.gemm_m, layer.gemm_k, layer.gemm_n


def kernel_mixes(workloads) -> dict:
    """mix -> (per-tenant (T, K, N) shapes, partition block or None=autotune)."""
    heavy = workloads.heavy_workload()
    first = [gemm(g.layers[0]) for g in heavy]
    largest = [max((gemm(x) for x in g.layers), key=np.prod) for g in heavy]
    capped = [tuple(min(v, 512) for v in s) for s in first]
    # odd depths and widths: no operand row is 16-byte aligned, and in
    # bfloat16 every x row of an odd depth starts on a 2-byte boundary
    unaligned = [(37, 363, 101), (129, 147, 65), (1, 33, 7), (300, 153, 99)]
    return {
        "uniform": ([(256, 256, 256)] * 4, 128),
        "ragged": (capped[:4], 128),
        "ragged_heavy": (capped, 128),
        "unaligned": (unaligned, 32),
        "heavy_l0": (first, None),
        "heavy_max": (largest, None),
    }


def operands(torch, shapes, dtype: str, seed: int, integer: bool = False):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(shape):
        if integer:
            v = torch.randint(-4, 5, shape, generator=gen, device="cuda")
        else:
            v = torch.randn(shape, generator=gen, device="cuda")
        return v.to(getattr(torch, dtype))

    return [draw((t, k)) for t, k, _ in shapes], [draw((k, n)) for _, k, n in shapes]


def bound(shapes, dtype: str, T: int = 0, N: int = 0) -> tuple[float, str]:
    """Least time (ms) the card needs for a fused call: the live operand
    bytes read once and the output written once over the memory rate, or the
    live FLOPs over the dtype's peak, whichever is larger.  The output is the
    stacked API's (T, N) f32 when ``T`` and ``N`` are given, else each
    tenant's own (T_i, N_i) f32 (``fused_tenant_gemm`` on the card)."""
    item = 4 if dtype == "float32" else 2
    nbytes = sum((t * k + k * n) * item for t, k, n in shapes)
    nbytes += T * N * 4 if T else sum(t * n * 4 for t, _, n in shapes)
    flops = sum(2 * t * k * n for t, k, n in shapes)
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    if by_bytes >= by_ops:
        return by_bytes * 1e3, "bytes"
    return by_ops * 1e3, "operations"


def time_in_turns(torch, fns: dict) -> dict:
    """Median ms per call of each function, timed with CUDA events in turns
    (forward order, then reversed), ``CALLS_PER_SAMPLE`` calls a sample."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    samples = {name: [] for name in fns}
    names = list(fns)
    for turn in range(2 * TIMING_TURNS):
        for name in names if turn % 2 == 0 else names[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS_PER_SAMPLE):
                fns[name]()
            end.record()
            end.synchronize()
            samples[name].append(start.elapsed_time(end) / CALLS_PER_SAMPLE)
    return {name: statistics.median(v) for name, v in samples.items()}


def enqueue_us(torch, fn) -> float:
    """Host microseconds per call to enqueue ``fn``: ``ENQUEUE_CALLS``
    calls on the host clock with no synchronise between them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ENQUEUE_CALLS):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / ENQUEUE_CALLS
    torch.cuda.synchronize()
    return us


def device_profile(torch, fn, calls: int) -> tuple[float, float, list]:
    """``calls`` runs of ``fn`` under ``torch.profiler``: host wall ms per
    call, device ms per call (kernels, copies and fills, summed from the
    trace; 0.0 if the trace holds no device time) and the top device
    entries as (name, ms per call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    rows = [
        (e.key, e.self_device_time_total / 1e3 / calls)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    rows.sort(key=lambda r: -r[1])
    return wall_ms, sum(ms for _, ms in rows), rows[:6]


def kernel_registry(K, results: dict) -> None:
    """Fold the ``FusedGemmStats`` of every full-width main-path call into
    one ``repro_torch.obs.MetricsRegistry`` (``record_gemm_stats``), then
    the host caches (``snapshot_host_caches``, the autotuner's included);
    check the call count and that the autotuner was consulted; print the
    registry and its summary.  Runs after the main path, outside every
    timed loop."""
    from repro_torch.obs import MetricsRegistry
    from repro_torch.obs.render import render_summary, snapshot_host_caches

    registry = MetricsRegistry()
    calls = 0
    for (mix, _dt, _mode), (_, stats) in results.items():
        if mix in FULL_WIDTH:
            K.record_gemm_stats(registry, stats)
            calls += 1
    snapshot_host_caches(registry)
    counters = {k: c.value for k, c in registry.counters.items()}
    want = len(FULL_WIDTH) * len(DTYPES) * len(MODES)
    check(
        counters["kernel.gemm.calls"] == calls == want,
        f"kernel.gemm.calls {counters['kernel.gemm.calls']}, {calls} calls",
    )
    tuned = counters["kernel.autotune.hits"] + counters["kernel.autotune.misses"]
    check(tuned >= 1, "the block autotuner was never consulted")
    log(f"kernel registry: {json.dumps(registry.as_dict())}")
    log(render_summary(registry, title="kernel path, full-width rounds"))


def kernel_phase(torch, K, details: dict) -> list[dict]:
    from repro_torch.sim import workloads

    mixes = kernel_mixes(workloads)
    blocks, inputs = {}, {}
    for mix, (shapes, block) in mixes.items():
        for dt in DTYPES:
            tuned = K.autotune_blocks(tuple(shapes), dt, dt) if block is None else None
            blocks[mix, dt] = tuned or (block, block, block)
            inputs[mix, dt] = operands(torch, shapes, dt, seed=len(inputs))

    # -- the main path: fused_tenant_gemm, counters zeroed just before ------
    K.reset_launch_counts()
    results = {}
    for (mix, dt), (xs, ws) in inputs.items():
        bt, bk, bn = blocks[mix, dt]
        for mode in MODES:
            before = sum(K.launch_counts().values())
            results[mix, dt, mode] = K.fused_tenant_gemm(
                xs,
                ws,
                block_t=bt,
                block_k=bk,
                block_n=bn,
                grid_mode=mode,
                return_stats=True,
            )
            check(sum(K.launch_counts().values()) == before + 1, mode)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    log(f"main path launches: {launches}")
    check(all(n > 0 for n in launches.values()), f"a kernel never ran: {launches}")
    kernel_registry(K, results)

    # -- each kernel against its plain version ------------------------------
    errs = {m: {"abs": 0.0, "rel": 0.0} for m in MODES}
    rounds = {m: [] for m in MODES}
    fused = {m: [] for m in MODES}
    for (mix, dt), (xs, ws) in inputs.items():
        shapes, _ = mixes[mix]
        bt, bk, bn = blocks[mix, dt]
        kw = dict(block_t=bt, block_k=bk, block_n=bn)
        padded = K.pad_operands(xs, ws, **kw)
        xs_pad, w_pad, owner, vt, vk = padded
        T, N = xs_pad.shape[1], w_pad.shape[1]
        owner_d = torch.from_numpy(owner).cuda()
        vt_d = torch.from_numpy(vt).cuda()
        plain = K.partitioned_matmul_ref(xs_pad, w_pad, owner_d, vt_d, bn)
        for mode in MODES:
            outs, _ = results[mix, dt, mode]
            col = 0
            for (t, _, n), out in zip(shapes, outs):
                check(out.is_contiguous() and out.shape == (t, n), "output layout")
                ref = plain[:t, col : col + n]
                abs_err = (out - ref).abs().max().item()
                rel_err = abs_err / (ref.abs().max().item() + 1e-9)
                check(rel_err < MAX_REL_ERR, f"{mix} {dt} {mode}: rel err {rel_err}")
                errs[mode]["abs"] = max(errs[mode]["abs"], abs_err)
                errs[mode]["rel"] = max(errs[mode]["rel"], rel_err)
                col += -(-n // bn) * bn
        del plain

        # integer operands: exact whatever the summation order.  The stacked
        # outputs are allocated where garbage was, so a byte that no CTA
        # writes cannot read as the right value
        ixs, iws = operands(torch, shapes, dt, seed=1000, integer=True)
        ipad = K.pad_operands(ixs, iws, **kw)
        iplain = K.partitioned_matmul_ref(ipad[0], ipad[1], owner_d, vt_d, bn)
        got = {}
        for mode in MODES:
            junk = torch.full((T, N), float("nan"), device="cuda")
            del junk
            got[mode] = K.partitioned_matmul(*ipad, grid_mode=mode, **kw)
        same = torch.equal(got["dense"], got["compact"])
        check(same, f"{mix} {dt}: dense != compact")
        check(torch.equal(got["dense"], iplain), f"{mix} {dt}: kernel != plain")
        for mode in MODES:
            outs = K.fused_tenant_gemm(ixs, iws, grid_mode=mode, **kw)
            for x, w, out in zip(ixs, iws, outs):
                exact = torch.equal(out, x.float() @ w.float())
                check(exact, f"{mix} {dt} {mode}: fused")
        del got, iplain, ipad

        if mix in FULL_WIDTH:
            # the plain version (11-55 ms a call, at full power) is timed
            # on its own, so that the card's clocks after it do not weigh
            # on whichever call follows it in the turns
            ms = time_in_turns(
                torch,
                {
                    "plain": lambda: K.partitioned_matmul_ref(
                        xs_pad, w_pad, owner_d, vt_d, bn
                    )
                },
            )
            ms |= time_in_turns(
                torch,
                {
                    "dense": lambda: K.partitioned_matmul(*padded, **kw),
                    "compact": lambda: K.partitioned_matmul(
                        *padded, grid_mode="compact", **kw
                    ),
                    "fused_dense": lambda: K.fused_tenant_gemm(
                        xs, ws, grid_mode="dense"
                    ),
                    "fused_compact": lambda: K.fused_tenant_gemm(
                        xs, ws, grid_mode="compact"
                    ),
                    "library": lambda: K.sequential_tenant_gemm(xs, ws),
                },
            )
            bound_ms, bound_by = bound(shapes, dt, T, N)
            fused_bound_ms, fused_bound_by = bound(shapes, dt)
            for mode in MODES:
                calls = {
                    "partitioned_matmul": lambda: K.partitioned_matmul(
                        *padded, grid_mode=mode, **kw
                    ),
                    "fused_tenant_gemm": lambda: K.fused_tenant_gemm(
                        xs, ws, grid_mode=mode
                    ),
                }
                host = {name: enqueue_us(torch, fn) for name, fn in calls.items()}
                prof = {
                    name: device_profile(torch, fn, CALLS_PER_SAMPLE)
                    for name, fn in calls.items()
                }
                kernel_ms = {
                    name: sum(t for n, t in top if f"{mode}_kernel" in n)
                    for name, (_, _, top) in prof.items()
                }
                rounds[mode].append(
                    {
                        "round": f"{mix}/{dt}",
                        "blocks": [bt, bk, bn],
                        "ms": ms[mode],
                        "kernel_ms": kernel_ms["partitioned_matmul"],
                        "device_ms": prof["partitioned_matmul"][1],
                        "host_us": host["partitioned_matmul"],
                        "plain_ms": ms["plain"],
                        "bound_ms": bound_ms,
                        "bound_by": bound_by,
                        "library_ms": ms["library"],
                    }
                )
                fused[mode].append(
                    {
                        "round": f"{mix}/{dt}",
                        "ms": ms[f"fused_{mode}"],
                        "kernel_ms": kernel_ms["fused_tenant_gemm"],
                        "device_ms": prof["fused_tenant_gemm"][1],
                        "host_us": host["fused_tenant_gemm"],
                        "fused_bound_ms": fused_bound_ms,
                        "fused_bound_by": fused_bound_by,
                        "library_ms": ms["library"],
                    }
                )
                log(f"{mix} {dt} {mode}: {rounds[mode][-1]} | fused {fused[mode][-1]}")
            log(f"{mix} {dt} blocks {(bt, bk, bn)}: {ms}")
        log(f"{mix} {dt}: checked")

    record = []
    for mode in MODES:
        head = rounds[mode][0]  # heavy_l0/float32
        record.append(
            {
                "name": f"partitioned_matmul_{mode}",
                "route": "cuda",
                "source": KERNEL_FILE,
                "replaces": TPU_KERNEL[mode],
                "launches": launches[mode],
                "max_abs_err": errs[mode]["abs"],
                "max_rel_err": errs[mode]["rel"],
                "ms": head["ms"],
                "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"],
                "library_ms": head["library_ms"],
                "headline": head["round"],
                "rounds": rounds[mode],
                "fused": fused[mode],
                "build": {dt: details.get(f"{mode}/{dt}", {}) for dt in DTYPES},
            }
        )
    return record


# ---------------------------------------------------------------------------
# 3. serving
# ---------------------------------------------------------------------------


def serving_phase(torch) -> dict:
    from repro_torch.configs import get
    from repro_torch.distributed.tenancy import TenantMeshManager, device_grid
    from repro_torch.models.model import decode_step, init_params
    from repro_torch.serving.engine import MultiTenantEngine
    from repro_torch.serving.kv_cache import DecodeSession

    spec = get("llama3.2-3b")
    smoke_decode_check(torch, [spec.arch_id])

    cfg = spec.model
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = MultiTenantEngine(TenantMeshManager(device_grid("cuda", 1)), policy="equal")
    sessions = {}
    for i, name in enumerate(("llama3.2-3b/a", "llama3.2-3b/b")):
        params = init_params(cfg, seed=i, device="cuda")
        sessions[name] = DecodeSession(cfg, params, batch_slots=4, max_seq=128)
        eng.add_tenant(name, sessions[name], flops_per_token=2.0 * cfg.param_count())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"serving: 2 tenants of {cfg.param_count()} parameters ready in {init_s:.2f} s")

    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (6, 8)).tolist()
    reqs = [eng.submit(n, prompts.pop(), 16) for n in sessions for _ in range(3)]
    t0 = time.perf_counter()
    rounds = eng.run_until_drained(max_rounds=200)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    check(not eng.tenants, "engine did not drain")
    for r in reqs:
        check(r.done and len(r.out) == 16, f"request {r.rid} unfinished")
        check(all(0 <= t < cfg.vocab for t in r.out), f"request {r.rid}: bad token")
    for name, s in sessions.items():
        check(tuple(s.last_logits.shape) == (4, 1, cfg.vocab), f"{name}: logits shape")
        check(bool(torch.isfinite(s.last_logits).all()), f"{name}: logits not finite")
    # where a decode step's time goes: host wall per step (unprofiled, then
    # under the profiler) against the device time the trace holds
    s = sessions["llama3.2-3b/a"]
    tok = torch.zeros((4, 1), dtype=torch.long, device=s.device)
    lens = torch.zeros(4, dtype=torch.int32, device=s.device)

    def step():
        decode_step(cfg, s.params, s.cache, tok, lens)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 5
    prof_ms, dev_ms, top = device_profile(torch, step, 3)
    emitted = sum(len(r.out) for r in reqs)
    stats = {
        "rounds": rounds,
        "tokens_emitted": emitted,
        "prompt_tokens": sum(len(r.prompt) for r in reqs),
        "wall_s": wall,
        "tokens_per_s": emitted / wall,
        "init_s": init_s,
        "width_history": eng.width_history,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "decode_step_ms": step_ms,
        "decode_step_ms_profiled": prof_ms,
        "decode_step_device_ms": dev_ms,
        "device_busy_share": dev_ms / prof_ms,
        "top_device_ms": top,
    }
    log(f"serving: {json.dumps(stats)}")
    return stats


# ---------------------------------------------------------------------------
# 3b. families: moe, ssm, hybrid and encdec decode at full width
# ---------------------------------------------------------------------------


def _leaf_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_items(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def decode_step_bytes(params, cache, batch: int, vocab: int) -> dict:
    """The bytes one decode step must move, each once: the parameters it
    reads (the embedding table and the decoder position table give one row
    a batch row; the encoder's parameters are not read), the whole cache
    read, the recurrent state and conv windows written back, the logits."""
    weights = 0
    for name, t in _leaf_items(params):
        top = name.split("/")[0]
        if top in ("embed", "dec_pos"):
            weights += batch * t.shape[-1] * t.element_size()
        elif not top.startswith("enc_"):
            weights += t.numel() * t.element_size()
    cache_read = cache_written = 0
    for name, t in _leaf_items(cache):
        cache_read += t.numel() * t.element_size()
        if name.split("/")[-1] in ("state", "conv"):
            cache_written += t.numel() * t.element_size()
    logits = batch * vocab * 2
    return {
        "weights": weights,
        "cache": cache_read + cache_written,
        "total": weights + cache_read + cache_written + logits,
    }


def _timed(fn, seconds: dict, key: str):
    """``fn`` with its host wall time (it synchronises by reading tokens
    back) added to ``seconds[key]``."""

    def timed(*args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[key] += time.perf_counter() - t0

    return timed


def smoke_decode_check(torch, archs) -> None:
    """Each arch's smoke config: ragged decode steps with a random live set
    on the card and on the CPU from the same parameters agree within
    ``BF16_TOL``.  Rows start at 0, 9, 14 and 3 tokens, so the hybrid's
    rows run past its window of 16 and its ring cache wraps on the card."""
    from repro_torch.configs import get
    from repro_torch.models.model import decode_step, init_cache, init_params

    for arch in archs:
        smoke = get(arch).smoke
        cpu_params = init_params(smoke, 0, device="cpu")
        gpu_params = _tree_to(cpu_params, "cuda")
        cpu_cache = init_cache(smoke, 4, 32, device="cpu")
        gpu_cache = init_cache(smoke, 4, 32)
        rng = np.random.default_rng(2)
        lens = np.array([0, 9, 14, 3])
        for step in range(SMOKE_STEPS):
            live = rng.random(4) < 0.75
            live[step % 4] = True
            tok = torch.from_numpy(rng.integers(0, smoke.vocab, (4, 1)))
            args = (tok, torch.from_numpy(lens), torch.from_numpy(live))
            ref, _ = decode_step(smoke, cpu_params, cpu_cache, *args)
            on_card = (a.cuda() for a in args)
            out, _ = decode_step(smoke, gpu_params, gpu_cache, *on_card)
            err = (out.float().cpu() - ref.float()).abs().max().item()
            close = torch.allclose(
                out.float().cpu(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL
            )
            check(close, f"{arch} smoke decode step {step}: card vs CPU max err {err}")
            lens = lens + live
        if smoke.family == "hybrid":
            check(lens.max() > smoke.window, f"{arch}: the ring never wrapped")
        log(f"{arch} smoke decode_step on the card matches the CPU, lens {lens}")


def families_phase(torch, K) -> dict:
    """Four tenants of the moe, ssm, hybrid and encdec families at their
    published widths, random bf16 weights, through one ``MultiTenantEngine``
    on the card; no partitioned-GEMM kernel is launched (decode is plain
    PyTorch, as the JAX package's is plain ``jnp``)."""
    from repro_torch.configs import get
    from repro_torch.distributed.tenancy import TenantMeshManager, device_grid
    from repro_torch.models.model import decode_step, init_params
    from repro_torch.serving.engine import MultiTenantEngine
    from repro_torch.serving.kv_cache import DecodeSession

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated() < 1 << 30, "the llama tenants were not freed")
    K.reset_launch_counts()
    smoke_decode_check(torch, FAMILY_SMOKES)

    eng = MultiTenantEngine(TenantMeshManager(device_grid("cuda", 1)), policy="equal")
    sessions, stats, seconds = {}, {}, {}
    for i, (arch, depth) in enumerate(FAMILY_TENANTS):
        cfg = get(arch).model
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = init_params(cfg, seed=10 + i)
        s = DecodeSession(cfg, params, batch_slots=FAMILY_SLOTS, max_seq=FAMILY_MAX_SEQ)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = cfg.param_count()
        stats[arch] = {
            "family": cfg.family,
            "layers": cfg.n_layers,
            "published_layers": get(arch).model.n_layers,
            "parameters": n_params,
            "resident_bytes": torch.cuda.memory_allocated() - before,
            "init_s": init_s,
        }
        seconds[arch] = 0.0
        s.admit = _timed(s.admit, seconds, arch)
        s.step = _timed(s.step, seconds, arch)
        sessions[arch] = s
        eng.add_tenant(arch, s, flops_per_token=2.0 * n_params)
        full = get(arch).model.n_layers
        cut = f", cut to {cfg.n_layers} of {full} layers" if depth else ""
        log(
            f"families: {arch} ({cfg.family}), {n_params} parameters{cut}, "
            f"ready in {init_s:.2f} s"
        )

    rng = np.random.default_rng(3)
    reqs = {}
    for arch, s in sessions.items():
        shape = (FAMILY_REQUESTS, FAMILY_PROMPT)
        prompts = rng.integers(0, s.cfg.vocab, shape).tolist()
        reqs[arch] = [eng.submit(arch, p, FAMILY_NEW) for p in prompts]
    rounds = dict.fromkeys(sessions, 0)
    t0 = time.perf_counter()
    n_rounds = 0
    while eng.tenants:
        check(n_rounds < 500, "families: the engine did not drain")
        for arch in eng.step():
            rounds[arch] += 1
        n_rounds += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    for arch, s in sessions.items():
        cfg = s.cfg
        for r in reqs[arch]:
            what = f"{arch}: request {r.rid}"
            check(r.done and len(r.out) == FAMILY_NEW, f"{what} unfinished")
            check(all(0 <= t < cfg.vocab for t in r.out), f"{what}: bad token")
        shape = tuple(s.last_logits.shape)
        check(shape == (FAMILY_SLOTS, 1, cfg.vocab), f"{arch}: logits shape {shape}")
        check(bool(torch.isfinite(s.last_logits).all()), f"{arch}: logits not finite")

        # where one decode step's time goes, all slots live
        tok = torch.zeros((FAMILY_SLOTS, 1), dtype=torch.long, device="cuda")
        lens = torch.full((FAMILY_SLOTS,), FAMILY_PROMPT, device="cuda")

        def step(cfg=cfg, s=s, tok=tok, lens=lens):
            decode_step(cfg, s.params, s.cache, tok, lens)

        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t1) * 1e3 / 5
        prof_ms, dev_ms, top = device_profile(torch, step, 3)
        moved = decode_step_bytes(s.params, s.cache, FAMILY_SLOTS, cfg.vocab)
        emitted = sum(len(r.out) for r in reqs[arch])
        stats[arch].update(
            {
                "rounds": rounds[arch],
                "tokens_emitted": emitted,
                "prompt_tokens": sum(len(r.prompt) for r in reqs[arch]),
                "session_s": seconds[arch],
                "tokens_per_s": emitted / seconds[arch],
                "decode_step_ms": step_ms,
                "decode_step_ms_profiled": prof_ms,
                "decode_step_device_ms": dev_ms,
                "device_busy_share": dev_ms / prof_ms,
                "weight_bytes_per_step": moved["weights"],
                "cache_bytes_per_step": moved["cache"],
                "bound_ms": moved["total"] / PEAK_BYTES_PER_S * 1e3,
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "top_device_ms": top,
            }
        )
        log(f"families {arch}: {json.dumps(stats[arch])}")
    launches = K.launch_counts()
    check(sum(launches.values()) == 0, f"the families phase launched: {launches}")
    phase_s = time.perf_counter() - t_phase
    emitted = sum(st["tokens_emitted"] for st in stats.values())
    log(
        f"families: {len(sessions)} tenants drained in {n_rounds} rounds, "
        f"{wall:.2f} s, {emitted / wall:.1f} tokens/s; {launches}; "
        f"phase {phase_s:.1f} s"
    )
    check(phase_s <= FAMILY_PHASE_S, f"families phase took {phase_s:.1f} s")
    return {"tenants": stats, "rounds": n_rounds, "wall_s": wall, "phase_s": phase_s}


# ---------------------------------------------------------------------------
# 4. the paper's front door
# ---------------------------------------------------------------------------


def check_golden(res, path: Path) -> None:
    """``equal``'s dynamic schedule against a golden trace, hex for hex."""
    golden = json.loads(path.read_text())
    dyn = res.partitioned
    check(dyn.makespan.hex() == golden["makespan"], f"{path.name}: makespan")
    completion = {k: v.hex() for k, v in dyn.completion.items()}
    check(completion == golden["completion"], f"{path.name}: completion")
    check(len(dyn.trace) == len(golden["trace"]), f"{path.name}: trace length")
    for e, g in zip(dyn.trace, golden["trace"]):
        got = (e.tenant, e.layer_index, e.partition.col_start, e.partition.cols)
        want = (g["tenant"], g["layer_index"], g["col_start"], g["cols"])
        times = (e.start, e.end, e.compute_start, e.compute_end)
        keys = ("start", "end", "compute_start", "compute_end")
        check(got == want, f"{path.name}: {got} != {want}")
        check([t.hex() for t in times] == [g[k] for k in keys], f"{path.name}: {got}")


def paper_phase(K) -> list[dict]:
    from repro_torch.api import Session, list_backends, list_policies
    from repro_torch.core.dataflow import ws_cost_cache_clear
    from repro_torch.sim.systolic import _BatchTimeOracle, layer_cost

    check(list_policies() == PAPER_POLICIES, f"policies: {list_policies()}")
    check(list_backends() == ["mesh", "sim"], f"backends: {list_backends()}")
    root = Path(__file__).resolve().parent
    K.reset_launch_counts()
    rows = []
    for workload in PAPER_WORKLOADS:
        for policy in PAPER_POLICIES:
            ws_cost_cache_clear()
            layer_cost.cache_clear()
            _BatchTimeOracle.clear_all()
            t0 = time.perf_counter()
            res = Session(policy, "sim").run(workload)
            wall_ms = (time.perf_counter() - t0) * 1e3
            what = f"paper {policy}/{workload}"
            check(res.policy == policy and res.backend == "sim", what)
            done = res.partitioned.completion
            check(set(done) == set(res.baseline.completion), f"{what}: tenants")
            check(all(0.0 < t < float("inf") for t in done.values()), f"{what}: times")
            check(
                res.turnaround_saving > 0 or res.time_saving > 0,
                f"{what}: does not beat sequential",
            )
            if policy == "equal":
                check_golden(res, root / GOLDEN.format(workload))
            row = {
                "policy": policy,
                "workload": workload,
                "time_saving": res.time_saving,
                "turnaround_saving": res.turnaround_saving,
                "energy_saving": res.energy_saving,
                "makespan_s": res.partitioned.makespan,
                "baseline_makespan_s": res.baseline.makespan,
                "wall_ms": wall_ms,
            }
            log(f"paper: {json.dumps(row)}")
            rows.append(row)
    launches = K.launch_counts()
    check(sum(launches.values()) == 0, f"the paper path launched kernels: {launches}")
    log(f"paper: {len(rows)} runs, equal matches both golden traces, {launches}")
    return rows


# ---------------------------------------------------------------------------
# 5. serve: open-loop serving, host only
# ---------------------------------------------------------------------------
# The cells take the package's name, so the golden file can be made from the
# JAX package by tests/test_torch_traffic.py with the same code; this script
# only ever passes "repro_torch".


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def mean_service_s(pkg: str, pool: str) -> float:
    """Mean full-array sequential time of one job of ``pool``: the load
    normaliser of the benchmarks (rate = load / mean_service_s)."""
    backend = _mod(pkg, "api").resolve_backend("sim")
    w = _mod(pkg, "sim.workloads")
    time_fn, stage = backend.time_fn(), backend.stage_model()
    full = _mod(pkg, "core.partition").Partition(
        rows=backend.array.rows, col_start=0, cols=backend.array.cols
    )
    times = []
    for name in w.MODEL_POOLS[pool]:
        g = w.MODELS[name]()
        times.append(
            sum(
                stage.stage_in_s(ls) + time_fn(ls, full) + stage.stage_out_s(ls)
                for ls in g.layers
            )
        )
    return sum(times) / len(times)


def _sha256(obj) -> str:
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()


def _row(res, **extra) -> dict:
    """A run's seeded fields: ``as_dict()``, a digest of its records and,
    where it kept them, of its schedules' trace events."""
    row = {**extra, **res.as_dict()}
    row["records_sha256"] = _sha256([dataclasses.astuple(r) for r in res.records])
    if res.schedules is not None:
        row["trace_sha256"] = _sha256(
            [
                [
                    (e.tenant, e.layer_index, e.partition.col_start)
                    + (e.partition.cols, e.start, e.end, e.compute_start)
                    + (e.compute_end, e.fraction, e.resumed, e.preempted)
                    for e in s.trace
                ]
                for s in res.schedules
            ]
        )
    return row


def traffic_parts(pkg: str, obs=None, keep_trace: bool = False) -> list:
    """``benchmarks/traffic_bench.py`` in four parts: process x policy x
    load on one array, one part per arrival process, then jsq vs p2c on
    four arrays.  A part is a zero-argument callable that runs its cells
    and returns ``(result, extra fields)`` per run; ``obs`` (an
    ``Observability`` factory's product, or None) and ``keep_trace`` arm
    every run, as the obs overhead pair does."""
    T = _mod(pkg, "traffic")
    svc = mean_service_s(pkg, "light")
    slo = 4.0 * svc
    kw = dict(max_concurrent=4, queue_cap=8, seed=SEED, obs=obs, keep_trace=keep_trace)

    def one_array(proc: str) -> list:
        runs = []
        for load in TRAFFIC_LOADS:
            rate = load / svc
            arr = T.get_arrival_process(
                proc,
                rate=rate,
                horizon=TRAFFIC_JOBS / rate,
                seed=SEED,
                pool="light",
                slo_s=slo,
            )
            for pol in TRAFFIC_POLICIES:
                res = T.TrafficSimulator(arr, policy=pol, **kw).run()
                runs.append((res, dict(load=load, rate_jobs_per_s=rate, slo_s=slo)))
        return runs

    def fleet() -> list:
        n_arrays = 4
        rate = n_arrays * 0.9 / svc
        arr = T.get_arrival_process(
            "poisson",
            rate=rate,
            horizon=n_arrays * TRAFFIC_JOBS / rate,
            seed=SEED,
            pool="light",
            slo_s=slo,
        )
        runs = []
        for dispatch in ("jsq", "p2c"):
            res = T.TrafficSimulator(arr, n_arrays=n_arrays, dispatch=dispatch, **kw).run()
            runs.append((res, dict(load=0.9, rate_jobs_per_s=rate, slo_s=slo)))
        return runs

    return [functools.partial(one_array, proc) for proc in TRAFFIC_PROCESSES] + [fleet]


def traffic_runs(pkg: str, obs=None, keep_trace: bool = False) -> list:
    """Every run of :func:`traffic_parts`, in order."""
    return [run for part in traffic_parts(pkg, obs, keep_trace) for run in part()]


def traffic_cells(pkg: str) -> dict:
    """The traffic matrix's rows, then the cluster block's."""
    rows = [_row(res, **extra) for res, extra in traffic_runs(pkg)]
    n = len(TRAFFIC_PROCESSES) * len(TRAFFIC_LOADS) * len(TRAFFIC_POLICIES)
    return {"traffic": rows[:n], "cluster": rows[n:]}


def armed_cells(pkg: str) -> dict:
    """One run per armed feature, each on its benchmark's heavy-pool cell:
    preemption (``preempt_bench`` single array, with its trace), memory
    contention (``moca_bench``, through a ``ServeConfig``), migration
    (``preempt_bench`` fleet) and fairness (``fairness_bench``'s drf row)."""
    T = _mod(pkg, "traffic")
    api = _mod(pkg, "api")
    svc = mean_service_s(pkg, "heavy")
    out = {}
    rate = 1.3 / svc
    arr = T.get_arrival_process(
        "mmpp",
        rate=rate,
        horizon=60 / rate,
        seed=SEED,
        pool="heavy",
        slo_s=3.0 * svc,
        burst_factor=6.0,
    )
    res = api.Session("deadline_preempt").serve(
        arr,
        max_concurrent=8,
        queue_cap=8,
        seed=SEED,
        keep_trace=True,
        preemption=True,
    )
    out["preempt"] = _row(res)
    rate = 4 * 1.2 / svc
    contention = _mod(pkg, "core.scheduler").ContentionModel(
        window_s=1e-4, capacity=0.5
    )
    cfg = api.ServeConfig(
        scheduling=api.SchedulingConfig(
            n_arrays=4, dispatch="jsq", max_concurrent=4, queue_cap=8, seed=SEED
        ),
        memory=api.MemoryConfig(contention=contention),
    )
    res = api.Session("moca").serve(
        "mmpp",
        config=cfg,
        rate=rate,
        horizon=600 / rate,
        pool="heavy",
        slo_s=4.0 * svc,
        tiers=(0, 1, 1),
    )
    out["moca"] = _row(res)
    rate = 4 * 1.1 / svc
    arr = T.get_arrival_process(
        "mmpp",
        rate=rate,
        horizon=4 * 60 / rate,
        seed=SEED,
        pool="heavy",
        slo_s=3.0 * svc,
        burst_factor=6.0,
    )
    res = T.TrafficSimulator(
        arr,
        n_arrays=4,
        max_concurrent=4,
        queue_cap=8,
        seed=SEED,
        rebalance_interval=1e-3,
    ).run()
    out["migrate"] = _row(res)
    rate = 4 * 0.9 / svc
    res = T.serve(
        "mmpp",
        policy="drf",
        n_arrays=4,
        dispatch="jsq",
        max_concurrent=4,
        queue_cap=16,
        seed=SEED,
        fairness=True,
        rate=rate,
        horizon=400 / rate,
        pool="heavy",
        slo_s=6.0 * svc,
        tiers=(0, 1),
    )
    out["fairness"] = _row(res)
    return out


def clear_cost_caches(pkg: str) -> None:
    df = _mod(pkg, "core.dataflow")
    systolic = _mod(pkg, "sim.systolic")
    df.ws_cost_cache_clear()
    df.ws_cost_batch_stats_clear()
    systolic.layer_cost.cache_clear()
    systolic._BatchTimeOracle.clear_all()


def oracle_calls(pkg: str) -> int:
    """Scalar ``layer_cost`` calls (hits included) + vectorized batch pairs,
    as ``benchmarks/scale_bench.py`` counts them."""
    info = _mod(pkg, "sim.systolic").layer_cost.cache_info()
    pairs = _mod(pkg, "core.dataflow").ws_cost_batch_stats()["pairs"]
    return info.hits + info.misses + pairs


def scale_cell(pkg: str, jobs: int, n_arrays: int) -> tuple[dict, dict]:
    """``benchmarks/scale_bench.py``'s cell: poisson light-pool arrivals at
    0.85 of each array, jsq, cold cost caches.  Returns (seeded fields,
    timing)."""
    T = _mod(pkg, "traffic")
    svc = mean_service_s(pkg, "light")
    rate = n_arrays * 0.85 / svc
    arr = T.get_arrival_process(
        "poisson",
        rate=rate,
        horizon=jobs / rate,
        seed=SEED,
        pool="light",
        slo_s=4.0 * svc,
    )
    sim = T.TrafficSimulator(
        arr,
        n_arrays=n_arrays,
        dispatch="jsq",
        max_concurrent=4,
        queue_cap=8,
        seed=SEED,
    )
    clear_cost_caches(pkg)
    calls0 = oracle_calls(pkg)
    t0 = time.perf_counter()
    list(arr)  # the stream, so the engine's own wall can be split off
    t1 = time.perf_counter()
    res = sim.run()
    t2 = time.perf_counter()
    events = sum(n.scheduler.n_events for n in sim.nodes)
    calls = oracle_calls(pkg) - calls0
    row = _row(res, jobs_target=jobs, events=events, oracle_calls=calls)
    timing = {
        "wall_s": t2 - t0,
        "wall_engine_s": t2 - t1,
        "events_per_s": events / (t2 - t0),
        "events_per_s_engine": events / (t2 - t1),
    }
    return row, timing


def sharded_cell(
    pkg: str, jobs: int, n_arrays: int, n_shards: int, parallel: bool
) -> tuple[dict, dict]:
    """``BENCH_fairness.json``'s ``sharded_scale`` cell: poisson light-pool
    arrivals at 0.85 of each array, drf, round robin over ``n_shards``
    pods, fairness armed.  ``parallel`` forks the pods (the results are the
    same either way).  Returns (seeded fields, timing)."""
    T = _mod(pkg, "traffic")
    svc = mean_service_s(pkg, "light")
    rate = n_arrays * 0.85 / svc
    t0 = time.perf_counter()
    res = T.ShardedTrafficSimulator(
        "poisson",
        policy="drf",
        n_arrays=n_arrays,
        n_shards=n_shards,
        dispatch="rr",
        max_concurrent=4,
        queue_cap=8,
        seed=SEED,
        sync_every=256,
        fairness=True,
        parallel=parallel,
        pod_timeout_s=POD_TIMEOUT_S,
        rate=rate,
        horizon=jobs / rate,
        pool="light",
        slo_s=4.0 * svc,
    ).run()
    wall = time.perf_counter() - t0
    row = _row(res, jobs_target=jobs, n_shards=n_shards)
    return row, {"wall_s": wall, "jobs_per_s": res.metrics.jobs_arrived / wall}


def serve_record(pkg: str, big: bool = True, parallel: bool = True) -> tuple:
    """Every cell of the serve phase: (seeded fields, timing).  ``big=False``
    leaves out the scale and sharded cells."""
    record = {**traffic_cells(pkg), "armed": armed_cells(pkg)}
    timing = {}
    if big:
        record["scale"], timing["scale"] = scale_cell(pkg, *SCALE_CELL)
        record["sharded_scale"], timing["sharded_scale"] = sharded_cell(
            pkg, *SHARDED_CELL, parallel=parallel
        )
    return record, timing


# ---------------------------------------------------------------------------
# 5b. fault injection, overload control and observability (serve child)
# ---------------------------------------------------------------------------
# benchmarks/chaos_bench.py, overload_bench.py and obs_bench.py, cell for
# cell, and the two big serve cells with every resilience knob armed.  Like
# serve_record, the cells take the package's name: tests/test_torch_chaos.py
# makes tests/data/resilience_golden.json from the JAX package with this code.

RESILIENCE_GOLDEN = "tests/data/resilience_golden.json"
CHAOS_CELL = (4, 0.65, 800, 10.0, (0, 1, 2))  # arrays, load, jobs, slo x, tiers
OVERLOAD_CELL = (4, 1.5, 600, 4.0, (0, 1, 1))
OVERLOAD_DELAY_S = 2e-3  # overload_bench.py's queue-delay setpoint
CODEL_INTERVAL_S = 5e-3
TRACE_CELL = (4, 1.1, 60)  # obs_bench.py: arrays, load, jobs per array
TRACE_DIR = "build/traces"  # gitignored
OBS_BUDGET = 1.05  # obs_bench.py's armed-overhead budget
OBS_REPEATS = 7
OBS_MAX_TRIES = 4
# passes of the traffic cells per CPU-time sample: one pass is 0.15-0.3 s of
# CPU on the card's host, whose process clock ticks in 10 ms steps and
# whose speed moves by more than the 1.05 budget from pass to pass
OBS_PASSES = 16
OBS_WALL_S = 720  # no round of the overhead pair starts that would end later


def _jsonable(obj):
    """Tuples to lists and int keys to strings, as ``json`` would."""
    return json.loads(json.dumps(obj))


def _fault_row(res, **extra) -> dict:
    """A fault-armed run's seeded fields: its row, the ``ChaosReport`` and
    the monitor's belief transitions."""
    row = _row(res, **extra)
    row["chaos_report"] = res.chaos.as_dict()
    row["transitions"] = _jsonable(res.chaos.transitions)
    return row


def _brownout_row(report) -> dict:
    return _jsonable(dataclasses.asdict(report))


def _pod_failure(err) -> dict:
    """The ``PodFailureError`` payload, as the reference reports it."""
    records = [dataclasses.astuple(r) for r in err.partial_records]
    return {
        "pod": err.pod,
        "epoch": err.epoch,
        "jobs_completed": err.jobs_completed,
        "pod_status": _jsonable(err.pod_status),
        "partial_records": len(records),
        "partial_records_sha256": _sha256(records),
    }


def chaos_cells(pkg: str, jobs: int = CHAOS_CELL[2], parallel: bool = True) -> dict:
    """``benchmarks/chaos_bench.py``: the seeded plan, a crash under
    ``retry_restart`` and under ``none``, degrade and straggler on 4 arrays
    at rho 0.65 (light pool, jsq), then the sharded ``pod_kill`` cell, which
    must raise ``PodFailureError``."""
    T = _mod(pkg, "traffic")
    chaos = _mod(pkg, "chaos")
    n_arrays, load, _, slo, tiers = CHAOS_CELL
    svc = mean_service_s(pkg, "light")
    rate = n_arrays * load / svc
    horizon = jobs / rate
    kw = dict(
        policy="equal",
        n_arrays=n_arrays,
        dispatch="jsq",
        max_concurrent=4,
        queue_cap=16,
        seed=SEED,
        rate=rate,
        horizon=horizon,
        pool="light",
        slo_s=slo * svc,
        tiers=tiers,
    )
    at = horizon * 0.3
    single = chaos.FaultPlan.single
    seeded = chaos.FaultPlan.seeded(
        SEED, horizon=horizon, n_nodes=n_arrays, crashes=1, blackouts=1, stragglers=1
    )
    plans = {
        "seeded": (seeded, None),
        "crash": (single("crash", t=at, node=1), None),
        "crash_none": (single("crash", t=at, node=1), "none"),
        "degrade": (single("degrade", t=at, node=1, dead_cols=64), None),
        "straggler": (
            single("straggler", t=at, node=2, factor=4.0, duration_s=at),
            None,
        ),
    }
    out = {}
    for name, (plan, recovery) in plans.items():
        extra = {"recovery": recovery} if recovery is not None else {}
        res = T.TrafficSimulator("poisson", faults=plan, **extra, **kw).run()
        out[name] = _fault_row(res)
    sim = T.ShardedTrafficSimulator(
        "poisson",
        policy="equal",
        n_arrays=4,
        n_shards=2,
        seed=SEED,
        sync_every=16,
        parallel=parallel,
        pod_timeout_s=POD_TIMEOUT_S,
        faults=chaos.FaultEvent(t=0.0, kind="pod_kill", node=1, epoch=1),
        rate=3000.0,
        horizon=0.05,
        pool="light",
        slo_s=0.05,
    )
    try:
        sim.run()
    except T.PodFailureError as err:
        check("pod 1" in str(err), f"pod_kill: {err}")
        out["pod_kill"] = _pod_failure(err)
    check("pod_kill" in out, "the killed pod did not raise PodFailureError")
    return out


def _overload_arm(pkg: str, arm: str, kw: dict):
    api = _mod(pkg, "api")
    overload = _mod(pkg, "overload")
    admission = brownout = None
    if arm == "static":
        admission = "static"
    elif arm == "codel":
        admission = overload.CoDelAdmission(
            target_delay_s=OVERLOAD_DELAY_S, interval_s=CODEL_INTERVAL_S
        )
    else:
        stage = overload.BrownoutStage
        ladder = (
            stage("shrink_floors", batch_demand_scale=0.5),
            stage("stretch_deadlines", batch_demand_scale=0.35, deadline_stretch=2.0),
            stage(
                "shed", batch_demand_scale=0.25, deadline_stretch=2.0, shed_batch=True
            ),
        )
        brownout = overload.BrownoutController(
            delay_target_s=OVERLOAD_DELAY_S, stages=ladder
        )
    n_arrays, *_ = OVERLOAD_CELL
    cfg = api.ServeConfig(
        scheduling=api.SchedulingConfig(
            n_arrays=n_arrays, dispatch="jsq", max_concurrent=4, queue_cap=8, seed=SEED
        ),
        overload=api.OverloadConfig(admission=admission, brownout=brownout),
    )
    return _mod(pkg, "traffic").TrafficSimulator(
        "mmpp", policy="width_aware", config=cfg, **kw
    ).run()


def overload_cells(
    pkg: str, jobs: int = OVERLOAD_CELL[2], parallel: bool = True
) -> dict:
    """``benchmarks/overload_bench.py``: ``static``, ``codel`` and
    ``brownout`` on the overdriven cell (4 arrays, rho 1.5, mmpp,
    ``width_aware``, tiers (0, 1, 1)); then the sharded respawn cell: abort
    without respawn, and with it serial == forked."""
    T = _mod(pkg, "traffic")
    chaos = _mod(pkg, "chaos")
    n_arrays, load, _, slo, tiers = OVERLOAD_CELL
    svc = mean_service_s(pkg, "light")
    rate = n_arrays * load / svc
    kw = dict(
        rate=rate, horizon=jobs / rate, pool="light", slo_s=slo * svc, tiers=tiers
    )
    out = {}
    for arm in ("static", "codel", "brownout"):
        res = _overload_arm(pkg, arm, kw)
        row = _row(res, tier0_p99_latency_s=res.per("tier")[0].p99_latency_s)
        if res.brownout is not None:
            row["brownout_report"] = _brownout_row(res.brownout)
        out[arm] = row
    shed = [out[a].get("shed_by_tier") or {} for a in out]
    check(all("0" not in s and 0 not in s for s in shed), f"tier 0 was shed: {shed}")

    def sharded(**extra):
        return T.ShardedTrafficSimulator(
            "poisson",
            n_arrays=n_arrays,
            n_shards=2,
            dispatch="rr",
            max_concurrent=4,
            queue_cap=8,
            seed=SEED,
            sync_every=64,
            pod_timeout_s=POD_TIMEOUT_S,
            rate=rate,
            horizon=jobs / (2 * rate),
            pool="light",
            slo_s=slo * svc,
            tiers=tiers,
            **extra,
        )

    kill = chaos.FaultEvent(t=0.0, kind="pod_kill", node=1, epoch=1)
    try:
        sharded(parallel=False, faults=kill).run()
    except T.PodFailureError as err:
        out["abort"] = _pod_failure(err)
    check("abort" in out, "pod_kill without respawn did not abort")
    serial = sharded(parallel=False, faults=kill, respawn=True).run()
    out["respawn"] = _row(serial)
    if parallel:
        forked = sharded(parallel=True, faults=kill, respawn=True).run()
        check(_row(forked) == out["respawn"], "respawn: serial != forked")
    check(serial.recovery == "pod_respawn", f"respawn: {serial.recovery}")
    return out


def trace_cell(pkg: str, jobs_per_array: int = TRACE_CELL[2], trace_dir=None):
    """``benchmarks/obs_bench.py``'s trace cell: bursty heavy mix on 4
    arrays, ``deadline_preempt`` with preemption and migration armed,
    per-layer schedules kept, obs armed.  Exports the Perfetto JSON twice
    (two runs) into ``trace_dir`` and requires identical bytes.  Returns
    (seeded fields, timing)."""
    T = _mod(pkg, "traffic")
    n_arrays, load, _ = TRACE_CELL
    svc = mean_service_s(pkg, "heavy")
    rate = n_arrays * load / svc
    trace_dir = Path(trace_dir or Path(__file__).resolve().parent / TRACE_DIR)
    trace_dir.mkdir(parents=True, exist_ok=True)
    blobs, timing = [], {}
    for i in range(2):
        arr = T.get_arrival_process(
            "mmpp",
            rate=rate,
            horizon=n_arrays * jobs_per_array / rate,
            seed=SEED,
            pool="heavy",
            slo_s=3.0 * svc,
            burst_factor=6.0,
        )
        clear_cost_caches(pkg)
        t0 = time.perf_counter()
        res = T.TrafficSimulator(
            arr,
            policy="deadline_preempt",
            n_arrays=n_arrays,
            dispatch="jsq",
            max_concurrent=4,
            queue_cap=8,
            seed=SEED,
            preemption=True,
            rebalance_interval=1e-3,
            keep_trace=True,
            obs=True,
        ).run()
        t1 = time.perf_counter()
        path = trace_dir / f"{pkg}.{i}.perfetto-trace.json"
        trace = res.timeline.write_chrome_trace(str(path))
        t2 = time.perf_counter()
        blobs.append(path.read_bytes())
        timing = {"wall_s": t1 - t0, "export_s": t2 - t1, "bytes": len(blobs[-1])}
    check(blobs[0] == blobs[1], "trace export: two runs differ")
    events = trace["traceEvents"]
    kinds: dict = {}
    for e in events:
        if e["ph"] in ("X", "i"):
            kinds[e["cat"]] = kinds.get(e["cat"], 0) + 1
    row = _row(res)
    row["trace"] = {
        "sha256": hashlib.sha256(blobs[0]).hexdigest(),
        "bytes": len(blobs[0]),
        "events": len(events),
        "spans": sum(e["ph"] == "X" for e in events),
        "preempt_markers": kinds.get("preempt", 0),
        "migrate_markers": kinds.get("migrate", 0),
        "node_tracks": sorted({e["pid"] for e in events if e["ph"] != "M"}),
    }
    row["csv_sha256"] = hashlib.sha256(res.timeline.timeline_csv().encode()).hexdigest()
    row["render_sha256"] = hashlib.sha256(res.timeline.render().encode()).hexdigest()
    return row, timing


def armed_scale_cell(pkg: str, jobs: int, n_arrays: int) -> tuple[dict, dict]:
    """The scale cell with faults (``chaos_bench``'s seeded plan spread
    over the fleet), ``brownout=True`` and ``obs=True`` armed."""
    T = _mod(pkg, "traffic")
    chaos = _mod(pkg, "chaos")
    svc = mean_service_s(pkg, "light")
    rate = n_arrays * 0.85 / svc
    horizon = jobs / rate
    arr = T.get_arrival_process(
        "poisson", rate=rate, horizon=horizon, seed=SEED, pool="light", slo_s=4.0 * svc
    )
    plan = chaos.FaultPlan.seeded(
        SEED, horizon=horizon, n_nodes=n_arrays, crashes=1, blackouts=1, stragglers=1
    )
    sim = T.TrafficSimulator(
        arr,
        n_arrays=n_arrays,
        dispatch="jsq",
        max_concurrent=4,
        queue_cap=8,
        seed=SEED,
        faults=plan,
        brownout=True,
        obs=True,
    )
    clear_cost_caches(pkg)
    list(arr)
    t0 = time.perf_counter()
    res = sim.run()
    wall = time.perf_counter() - t0
    events = sum(n.scheduler.n_events for n in sim.nodes)
    row = _fault_row(res, jobs_target=jobs, events=events)
    row["brownout_report"] = _brownout_row(res.brownout)
    return row, {"wall_engine_s": wall, "events_per_s_engine": events / wall}


def respawn_scale_cell(
    pkg: str, jobs: int, n_arrays: int, n_shards: int, parallel: bool
) -> tuple[dict, dict]:
    """The sharded scale cell (``rr``, drf, fairness armed) with ``obs=True``,
    a ``pod_kill`` of pod 3 at epoch 2 and ``respawn=True``."""
    T = _mod(pkg, "traffic")
    chaos = _mod(pkg, "chaos")
    svc = mean_service_s(pkg, "light")
    rate = n_arrays * 0.85 / svc
    t0 = time.perf_counter()
    res = T.ShardedTrafficSimulator(
        "poisson",
        policy="drf",
        n_arrays=n_arrays,
        n_shards=n_shards,
        dispatch="rr",
        max_concurrent=4,
        queue_cap=8,
        seed=SEED,
        sync_every=256,
        fairness=True,
        parallel=parallel,
        pod_timeout_s=POD_TIMEOUT_S,
        obs=True,
        faults=chaos.FaultEvent(t=0.0, kind="pod_kill", node=3, epoch=2),
        respawn=True,
        rate=rate,
        horizon=jobs / rate,
        pool="light",
        slo_s=4.0 * svc,
    ).run()
    wall = time.perf_counter() - t0
    check(res.recovery == "pod_respawn", f"respawn: {res.recovery}")
    row = _row(res, jobs_target=jobs, n_shards=n_shards)
    return row, {"wall_s": wall, "jobs_per_s": res.metrics.jobs_arrived / wall}


def resilience_record(pkg: str, parallel: bool = True) -> tuple:
    """Every resilience cell, the two scale cells included: (seeded fields,
    timing)."""
    timing = {}
    record = {}
    for name, fn in (("chaos", chaos_cells), ("overload", overload_cells)):
        t0 = time.perf_counter()
        record[name] = fn(pkg, parallel=parallel)
        timing[name] = {"wall_s": time.perf_counter() - t0}
    record["obs"], timing["obs"] = trace_cell(pkg)
    record["scale"], timing["scale"] = armed_scale_cell(pkg, *SCALE_CELL)
    record["sharded_scale"], timing["sharded_scale"] = respawn_scale_cell(
        pkg, *SHARDED_CELL, parallel=parallel
    )
    return record, timing


def _timed_part(part) -> tuple[float, bytes]:
    """CPU seconds of one part of the traffic cells and the JSON bytes of
    its runs' ``as_dict()`` rows (timelines detached).  Garbage left by an
    earlier part is collected before the clock starts."""
    gc.collect()
    c0 = time.process_time()
    rows = []
    for res, extra in part():
        if res.timeline is not None:
            res = dataclasses.replace(res, timeline=None)
        rows.append({**extra, **res.as_dict()})
    blob = json.dumps(rows, indent=1).encode()
    return time.process_time() - c0, blob


def _traffic_pass(pkg: str, make_obs, keep_trace: bool) -> tuple[float, bytes]:
    """One pass of the traffic cells with obs off (``make_obs`` is None) or
    armed (one ``make_obs()`` for the pass, as ``benchmarks/obs_bench.py``
    arms ``traffic_bench.run``): CPU seconds and the rows' JSON bytes."""
    obs = make_obs() if make_obs is not None else None
    timed = [_timed_part(part) for part in traffic_parts(pkg, obs, keep_trace)]
    return sum(t for t, _ in timed), b"".join(b for _, b in timed)


def _process_tick() -> float:
    """The smallest step of ``time.process_time`` seen while spinning."""
    t0 = time.process_time()
    t1 = t0
    while t1 == t0:
        t1 = time.process_time()
    return t1 - t0


def _overhead_pair(pkg: str, make_obs, keep_trace: bool, on_first: bool) -> dict:
    """One off/armed sample pair: ``OBS_PASSES`` passes a side, alternated
    part by part (off, on, on, off, ... or the mirror), so the host's slow
    phases, which last about as long as a pass, weigh on both sides.  Each
    armed pass has one ``make_obs()``.  Returns each side's CPU seconds;
    armed and off must serialize the same bytes."""
    cpu = {"off": 0.0, "on": 0.0}
    for i in range(OBS_PASSES):
        parts = zip(
            traffic_parts(pkg, None, keep_trace),
            traffic_parts(pkg, make_obs(), keep_trace),
        )
        blobs = {"off": [], "on": []}
        for k, (off, on) in enumerate(parts):
            order = ("on", "off") if ((i + k) % 2 == 0) == on_first else ("off", "on")
            for side in order:
                seconds, blob = _timed_part(on if side == "on" else off)
                cpu[side] += seconds
                blobs[side].append(blob)
        check(blobs["on"] == blobs["off"], "obs: the armed run serialized other bytes")
    return cpu


def obs_overhead(pkg: str) -> dict:
    """``benchmarks/obs_bench.py``'s estimator: CPU time, obs-off and armed
    samples alternated, the minimum per side, the pool grown round by round
    (``OBS_REPEATS`` pairs, up to ``OBS_MAX_TRIES``) until both gated ratios
    (default path, span-source path) clear ``OBS_BUDGET``; the audit ratio
    is measured over one round and not gated.  A sample is ``OBS_PASSES``
    passes, interleaved with the other side's part by part, so the process
    clock's tick and the host's slow phases stay small beside it.  No round
    starts that would end past ``OBS_WALL_S``."""
    obs_mod = _mod(pkg, "obs")
    pools = {
        "default": (False, obs_mod.Observability, {"off": [], "on": []}),
        "spans": (True, obs_mod.Observability, {"off": [], "on": []}),
        "audit": (
            False, lambda: obs_mod.Observability(audit=True), {"off": [], "on": []}
        ),
    }

    _traffic_pass(pkg, None, False)  # warm the cost caches, untimed
    tick = _process_tick()
    # the heap so far (torch, the goldens, the cells' results) is frozen, so
    # no collection, timed or not, walks it again
    gc.collect()
    gc.freeze()
    try:
        rounds, wall = _overhead_rounds(pkg, pools)
    finally:
        gc.unfreeze()
    out = {
        "rounds": rounds,
        "budget": OBS_BUDGET,
        "passes": OBS_PASSES,
        "tick_s": tick,
        "wall_s": wall,
    }
    for name, (_, _, samples) in pools.items():
        pair_ratios = [b / a for a, b in zip(samples["off"], samples["on"])]
        out[name] = {
            "ratio": _floor_ratio(samples),
            "median_ratio": statistics.median(pair_ratios),
            "pair_ratios": pair_ratios,
            "cpu_off_s": min(samples["off"]),
            "cpu_on_s": min(samples["on"]),
            "pairs": len(samples["off"]),
        }
    return out


def _floor_ratio(samples: dict) -> float:
    """The armed side's minimum over the off side's."""
    return min(samples["on"]) / min(samples["off"])


def _overhead_rounds(pkg: str, pools: dict) -> tuple[int, float]:
    """Grow ``pools`` round by round for :func:`obs_overhead`; returns the
    rounds run and their wall seconds."""
    start = time.perf_counter()
    rounds = 0
    for attempt in range(OBS_MAX_TRIES):
        gated_s = 0.0  # wall seconds of this round's two gated pools
        for name, (keep_trace, make, samples) in pools.items():
            if name == "audit" and attempt:
                continue
            t0 = time.perf_counter()
            for i in range(OBS_REPEATS):
                cpu = _overhead_pair(pkg, make, keep_trace, on_first=i % 2 == 1)
                for side, seconds in cpu.items():
                    samples[side].append(seconds)
            if name != "audit":
                gated_s += time.perf_counter() - t0
        rounds = attempt + 1
        gated = (_floor_ratio(pools[name][2]) for name in ("default", "spans"))
        if max(gated) <= OBS_BUDGET:
            break
        # a later round grows only the gated pools; start none that would
        # end past the wall budget (the gate then fails on what was measured)
        if time.perf_counter() - start + gated_s > OBS_WALL_S:
            break
    return rounds, time.perf_counter() - start


def obs_split(pkg: str = "repro_torch") -> dict:
    """Where the armed side of the obs overhead pair spends its time, on
    the host that runs it (no card needed).

    For each gated path (``default``, ``spans``): each part of the traffic
    cells, off and armed, ``OBS_SPLIT_PASSES`` passes a side alternated as
    in :func:`_overhead_pair`: CPU seconds summed over the passes (one part
    is a few ticks of a 10 ms process clock) and the median wall seconds a
    pass.  Then one armed and one off pass under ``cProfile``: the seconds
    spent inside each module of the port (own time, summed over its
    functions), and the obs package's ten costliest functions with their
    call counts."""
    import cProfile
    import pstats

    obs_mod = _mod(pkg, "obs")
    names = list(TRAFFIC_PROCESSES) + ["fleet"]
    _traffic_pass(pkg, None, False)  # warm the cost caches, untimed
    out = {"passes": OBS_SPLIT_PASSES}
    gc.collect()
    gc.freeze()
    try:
        for path, keep_trace in (("default", False), ("spans", True)):
            cpu = {n: {"off": 0.0, "on": 0.0} for n in names}
            wall = {n: {"off": [], "on": []} for n in names}
            for i in range(OBS_SPLIT_PASSES):
                offs = traffic_parts(pkg, None, keep_trace)
                ons = traffic_parts(pkg, obs_mod.Observability(), keep_trace)
                for k, (off, on) in enumerate(zip(offs, ons)):
                    order = ("on", "off") if (i + k) % 2 == 0 else ("off", "on")
                    for side in order:
                        t0 = time.perf_counter()
                        seconds, _ = _timed_part(on if side == "on" else off)
                        wall[names[k]][side].append(time.perf_counter() - t0)
                        cpu[names[k]][side] += seconds
            rows = {}
            for n in names:
                off, on = cpu[n]["off"], cpu[n]["on"]
                w_off = statistics.median(wall[n]["off"])
                w_on = statistics.median(wall[n]["on"])
                rows[n] = {
                    "cpu_off_s": off,
                    "cpu_on_s": on,
                    "cpu_ratio": on / off,
                    "wall_off_s": w_off,
                    "wall_on_s": w_on,
                    "wall_ratio": w_on / w_off,
                }
            out[path] = rows
        for side, make in (("on", obs_mod.Observability), ("off", None)):
            prof = cProfile.Profile()
            prof.enable()
            _traffic_pass(pkg, make, False)
            prof.disable()
            by_module: dict[str, float] = {}
            obs_fns = []
            stats = pstats.Stats(prof).stats
            for (file, line, fn), (_cc, nc, tt, _ct, _) in stats.items():
                key = file.split(f"{pkg}/")[-1] if f"{pkg}/" in file else "other"
                by_module[key] = by_module.get(key, 0.0) + tt
                if key.startswith("obs/"):
                    obs_fns.append((tt, nc, f"{key}:{line}:{fn}"))
            top = sorted(by_module.items(), key=lambda kv: -kv[1])[:12]
            out[f"profile_{side}"] = {
                "own_s_by_module": dict(top),
                "obs_s": sum(t for t, _, _ in obs_fns),
                "obs_top": [
                    {"fn": name, "calls": nc, "own_s": tt}
                    for tt, nc, name in sorted(obs_fns, reverse=True)[:10]
                ],
            }
    finally:
        gc.unfreeze()
    return out


def obs_split_main() -> int:
    split = obs_split()
    for path in ("default", "spans"):
        for part, row in split[path].items():
            log(f"obs split {path} {part}: {json.dumps(row)}")
    for side in ("on", "off"):
        log(f"obs split profile {side}: {json.dumps(split[f'profile_{side}'])}")
    print(json.dumps(split), flush=True)
    return 0


def _check_sections(record: dict, golden: dict, path: str) -> None:
    check(set(record) == set(golden), f"cells {sorted(record)} vs {path}")
    for section, want in golden.items():
        got = json.loads(json.dumps(record[section]))
        check(got == want, f"{section}: differs from {path}")


def serve_child() -> int:
    """The serve phase's own process: the card is hidden, the pods fork from
    a process that has never touched CUDA.  Prints its log, then one JSON
    line ``{"serve": timing, "resilience": timing, "obs_overhead": ...}``."""
    import repro_torch.kernels as K

    root = Path(__file__).resolve().parent
    golden = json.loads((root / SERVE_GOLDEN).read_text())
    K.reset_launch_counts()
    t0 = time.perf_counter()
    record, timing = serve_record("repro_torch")
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    check(sum(launches.values()) == 0, f"the serving path launched kernels: {launches}")
    _check_sections(record, golden, SERVE_GOLDEN)
    n_runs = len(record["traffic"]) + len(record["cluster"]) + len(record["armed"]) + 2
    log(f"serve: {n_runs} runs equal {SERVE_GOLDEN}, {launches}, {wall:.1f} s")
    for name in ("scale", "sharded_scale"):
        keys = ("jobs_arrived", "jobs_completed", "deadline_miss_rate")
        log(f"serve {name}: {json.dumps({k: record[name][k] for k in keys})}")

    # -- fault injection, overload control, observability ------------------
    golden = json.loads((root / RESILIENCE_GOLDEN).read_text())
    K.reset_launch_counts()
    t0 = time.perf_counter()
    record, resilience = resilience_record("repro_torch")
    overhead = obs_overhead("repro_torch")
    resilience_wall = time.perf_counter() - t0
    launches = K.launch_counts()
    check(
        sum(launches.values()) == 0,
        f"the chaos/overload/obs paths launched kernels: {launches}",
    )
    _check_sections(record, golden, RESILIENCE_GOLDEN)
    log(
        f"resilience: chaos {len(record['chaos'])}, overload {len(record['overload'])}"
        f", obs, scale and sharded_scale cells equal {RESILIENCE_GOLDEN}, "
        f"{launches}, {resilience_wall:.1f} s"
    )
    log(f"resilience trace: {json.dumps(record['obs']['trace'])}")
    log(f"resilience scale: {json.dumps(record['scale']['chaos_report'])}")
    obs = record["sharded_scale"]["obs"]
    keys = ("events_recorded", "events_dropped", "events_by_kind")
    digest = {k: obs[k] for k in keys}
    digest["counters"] = obs["metrics"]["counters"]
    log(f"resilience sharded_scale obs: {json.dumps(digest)}")
    for name in ("default", "spans", "audit"):
        r = overhead[name]
        gate = f"budget {OBS_BUDGET}" if name != "audit" else "not gated"
        log(
            f"obs overhead {name}: {r['ratio']!r} ({gate}), "
            f"median {r['median_ratio']!r}"
            f", cpu off {r['cpu_off_s']!r} s / armed {r['cpu_on_s']!r} s"
            f", {r['pairs']} pairs"
        )
    log(
        f"obs overhead: {overhead['passes']} passes a sample, process clock tick "
        f"{overhead['tick_s']!r} s, {overhead['rounds']} round(s) in "
        f"{overhead['wall_s']:.1f} s (wall budget {OBS_WALL_S} s)"
    )
    worst = max(overhead["default"]["ratio"], overhead["spans"]["ratio"])
    check(
        worst <= OBS_BUDGET,
        f"armed obs overhead {worst:.4f} over {OBS_BUDGET} after "
        f"{overhead['rounds']} round(s)",
    )
    out = {
        "serve": timing,
        "wall_s": wall,
        "resilience": resilience,
        "resilience_wall_s": resilience_wall,
        "obs_overhead": overhead,
    }
    print(json.dumps(out), flush=True)
    return 0


def serve_phase() -> dict:
    """Run :func:`serve_child` in a fresh interpreter with no card visible,
    in a session of its own, under a time limit (at which the child and its
    pods are killed); relay its log; return its timing."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), SERVE_FLAG],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        env=env,
        start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=SERVE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
        raise AssertionError(f"serve phase over {SERVE_TIMEOUT_S} s:\n{out}\n{err}")
    lines = out.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    check(proc.returncode == 0, f"serve phase failed:\n{out}\n{err}")
    timing = json.loads(lines[-1])
    log(f"serve timing: {json.dumps(timing)}")
    return timing


# ---------------------------------------------------------------------------
# 6. mesh: the mesh backend's constants, measured
# ---------------------------------------------------------------------------


def queued_device_ms(torch, fn, calls: int = 10) -> float:
    """Device ms per call of ``fn`` with the host out of the way: a spin
    kernel holds the stream while ``calls`` calls are enqueued behind it, so
    the CUDA events around them time the device alone.  The start event must
    still be pending once every call is enqueued (else the spin is doubled
    and the sample taken again)."""
    fn()
    torch.cuda.synchronize()
    spin = SPIN_CYCLES
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / calls
        spin *= 2


def mesh_constants(torch, K) -> dict:
    """Measure what ``MeshLatencyModel`` models, each a median of
    ``MESH_REPEATS`` samples; returns name -> (measured, yardstick)."""
    from repro_torch.sim import workloads

    shapes, _ = kernel_mixes(workloads)["heavy_max"]
    xs, ws = operands(torch, shapes, "bfloat16", seed=7)
    flops = sum(2 * t * k * n for t, k, n in shapes)
    fused = statistics.median(
        queued_device_ms(torch, lambda: K.fused_tenant_gemm(xs, ws))
        for _ in range(MESH_REPEATS)
    )
    library = statistics.median(
        queued_device_ms(torch, lambda: [x @ w for x, w in zip(xs, ws)])
        for _ in range(MESH_REPEATS)
    )
    host = torch.empty(H2D_BYTES, dtype=torch.uint8).pin_memory()
    dev = torch.empty(H2D_BYTES, dtype=torch.uint8, device="cuda")
    h2d = time_in_turns(torch, {"h2d": lambda: dev.copy_(host, non_blocking=True)})
    del host, dev
    x1, w1 = xs[0], ws[0]
    one = torch.ones(1, device="cuda")
    launch = statistics.median(
        enqueue_us(torch, lambda: K.fused_tenant_gemm([x1], [w1]))
        for _ in range(MESH_REPEATS)
    )
    tiny = statistics.median(
        enqueue_us(torch, lambda: one.add_(1.0)) for _ in range(MESH_REPEATS)
    )
    return {
        "device_flops": (flops / (fused * 1e-3), flops / (library * 1e-3)),
        "host_bw_bytes": (H2D_BYTES / (h2d["h2d"] * 1e-3), None),
        "launch_overhead_s": (launch * 1e-6, tiny * 1e-6),
    }


def mesh_phase(torch, K) -> dict:
    from repro_torch.api import Session, list_policies
    from repro_torch.distributed.tenancy import MeshLatencyModel

    default = MeshLatencyModel()
    measured = mesh_constants(torch, K)
    report = {}
    for name, (value, yardstick) in measured.items():
        want = getattr(default, name)
        report[name] = {"measured": value, "default": want, "yardstick": yardstick}
        log(f"mesh {name}: measured {value!r}, default {want!r}, beside {yardstick!r}")
    log(f"mesh ici_bw_bytes: {default.ici_bw_bytes!r} (datasheet, not measured)")
    for name, r in report.items():
        ratio = r["measured"] / r["default"]
        check(
            1 / MESH_TOLERANCE <= ratio <= MESH_TOLERANCE,
            f"mesh {name}: measured {r['measured']:.4g} is {ratio:.2f}x the default",
        )
    K.reset_launch_counts()
    rows = []
    for workload in PAPER_WORKLOADS:
        for policy in list_policies():
            res = Session(policy, "mesh").run(workload)
            what = f"mesh {policy}/{workload}"
            done = res.partitioned.completion
            check(res.backend == "mesh", what)
            check(set(done) == set(res.baseline.completion), f"{what}: tenants")
            check(all(0.0 < t < float("inf") for t in done.values()), f"{what}: times")
            rows.append(
                {
                    "policy": policy,
                    "workload": workload,
                    "makespan_s": res.partitioned.makespan,
                    "baseline_makespan_s": res.baseline.makespan,
                    "time_saving": res.time_saving,
                    "turnaround_saving": res.turnaround_saving,
                }
            )
            log(f"mesh: {json.dumps(rows[-1])}")
    launches = K.launch_counts()
    check(sum(launches.values()) == 0, f"the mesh backend launched kernels: {launches}")
    report["runs"] = rows
    return report


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    if sys.argv[1:] == [SERVE_FLAG]:
        return serve_child()
    if sys.argv[1:] == [OBS_SPLIT_FLAG]:
        return obs_split_main()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    import repro_torch.kernels as K
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    card = environment(torch, _build)
    details = build_details(_build)
    kernels = kernel_phase(torch, K, details)
    serving_phase(torch)
    families_phase(torch, K)
    paper_phase(K)
    serve_phase()
    mesh_phase(torch, K)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
