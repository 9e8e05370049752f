"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on a failed
check:

1. Environment: the card (``nvidia-smi`` name and power limit), torch, CUDA,
   ``nvcc``; TF32 is switched off; the CUDA kernels are built from the
   checkout's sources, and ``ptxas -v`` (registers, spills) and the count of
   tensor-core (``HMMA``, ``HGMMA``) instructions in each kernel's SASS are
   logged.
2. Kernels: ``fused_tenant_gemm`` — the port's main kernel path — runs the
   three ``benchmarks/kernel_bench.py`` mixes (block 128), a mix of odd
   depths and widths (every operand row off 16-byte alignment) and two
   full-width rounds of the paper's heavy workload (layer 0 of each of the 8
   tenants, and each tenant's largest GEMM, partition blocks autotuned), and
   two mixes that reach every feed path and tile shape of the kernels (T in
   1, 64, 65, 129, K in 1, 63, 147, 1025, N in 1, 2, 100, 513, contiguous
   and as views whose origins sit 2 or 4 bytes off a 16-byte boundary), in
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
   enqueue time from the host clock.  Every main-path call's launch
   counters (``launch_stats``) are checked: one launch, as many tiles as its
   launch table's grid; the host caches (``snapshot_host_caches``) are
   folded into one ``repro_torch.obs.MetricsRegistry`` outside the timed
   loops and printed with the counters.
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
   Dense: the smoke configs of mistral-nemo-12b, nemotron-4-15b,
   internvl2-26b and deepseek-coder-33b decode on the card and on the CPU
   within 3e-2; then the four at their published widths and full depth,
   random bf16 weights, through ``MultiTenantEngine`` one engine at a time
   (the first two together, 55.8 GB; internvl2-26b's backbone alone;
   deepseek-coder-33b alone, 66.7 GB), each engine freed before the next,
   with the families' slots and requests and the same per-tenant numbers;
   then ``python -m repro_torch.launch.serve``'s ``main`` on the card with
   the JAX launcher's defaults.  No partitioned-GEMM kernel is launched,
   and the phase fits in 180 s.
   Train: the smoke configs of llama3.2-3b, phi3.5-moe, mamba2,
   recurrentgemma, whisper and internvl2 (the vision frontend) take 2 train
   steps on the card and on the CPU from the same parameters and batches;
   losses and gradient norms agree within 3e-2.  A checkpoint saved after
   step 2 on the card and restored into fresh state gives step 3 the loss
   of an uninterrupted run.  Then llama3.2-3b at full width and depth
   (random bf16 weights, f32 AdamW state) trains 6 steps of batch 4 × seq
   512 through the calls of ``python -m repro_torch.launch.train``: per
   step the loss, host ms, tokens/s, the bound (the bf16 and f32 FLOPs of
   forward, remat and backward over their peaks, plus AdamW's 28 bytes a
   parameter over 3.35 TB/s) and peak memory; the last step is profiled
   for its device ms.  Losses are finite, no partitioned-GEMM kernel is
   launched, and the phase fits in 150 s.
   Placement: a one-rank NCCL process group (``init_distributed``, as
   ``torchrun`` starts one) and ``make_host_mesh()`` over it; llama3.2-3b
   at full width trains the train phase's steps through the sharded step
   (DTensor state; each layer's leaves gathered over the axes of more
   than one rank and computed on their split along "model", each
   gradient reduce-scattered back), its losses within 3e-2 of the train
   phase's, host ms a step beside the one-device step's, NCCL kernels a
   step (``torch.profiler``), resident and peak memory; the trained
   params then decode 8 greedy tokens of 4 rows on a 128-token cache
   through ``launch.steps.sharded_decode_fn`` (the cache's KV sequence
   split over "model") against the one-device ``decode_step``, logits
   within 3e-2 and the greedy tokens equal (where they differ, the
   one-device top-2 margin must lie within twice the bf16 band), then one
   more step profiled (NCCL kernels, and the port's collectives by mesh
   axis).  At one rank nothing is issued over an axis of one, so the
   profiled train step and decode step must launch no NCCL kernel, the
   losses must equal the train phase's and the decode logits the
   one-device ones bit for bit.  At smoke size a checkpoint of the
   sharded state round-trips bit for bit and one int8
   ``make_dp_train_step`` step runs.  The card's name and power limit
   are logged with the numbers.  No partitioned-GEMM kernel is launched,
   and the phase fits in 90 s.
   Tenancy, in the same group: ``examples/partitioned_training.py``'s flow
   through the port.  ``TenantMeshManager(make_host_mesh(model=1),
   "model", policy="proportional")`` admits llama3.2-3b (demand 10) and
   mamba2-780m (demand 5); llama gets the column and trains on
   ``submesh("llama")`` the train phase's 6 steps of 4 × 512 (seed,
   batches), mamba time-shares the whole mesh, both at full width and
   depth, their steps interleaved.  llama's losses must be the train
   phase's bit for bit, and its profiled last step launches 0 NCCL and 0
   partitioned-GEMM kernels.  Each tenant's host ms a step and the peak
   with both resident are logged.  Then each saves its params (the f32
   AdamW state is not written: 38.6 GB more to disk), mamba is released,
   ``grow_into_free`` runs, and llama's checkpoint is restored onto its
   sub-mesh, every leaf bit-equal.  The phase fits in 90 s.
   Draw: in a child process under a fake process group, llama3.2-3b's
   shards as ranks 0 and 3 of (1, 4) and 0 and 255 of 16×16 are drawn
   by shard (``init_params_sharded``) and held bit for bit against
   ``init_params`` drawn whole on the card; then dbrx-132b's ranks 0 and
   3 of (1, 4) are drawn for real, one after the other: resident bytes
   against the specs' shard bytes, the peak (at most 1 GB above the
   resident bytes) and the seconds.
   Examples: in a child process (``chip_smoke.py --examples``, in a
   session of its own under ``EXAMPLES_TIMEOUT_S``), each program of
   ``examples_torch/`` through its ``main(argv)``: the six host examples
   with their default flags (host arithmetic; ``overload_serving`` forks
   two pods), then ``multi_tenant_serving`` on the card, on the CPU and on
   the card with ``--full`` (llama3.2-3b, mamba2-780m and
   recurrentgemma-2b at their published widths, 16 GB of bf16 weights),
   ``partitioned_training`` and ``quickstart`` on the card.  Per example:
   wall s, partitioned-GEMM launches by kernel (counters zeroed before
   each) and the card's peak GB.  Every example returns; only
   ``quickstart`` launches a partitioned-GEMM kernel, and each of its
   part-2 outputs equals ``kernels.matmul_ref`` on the same operands
   within 1e-4; ``multi_tenant_serving`` prints the same text on the card
   as on the CPU; ``--full`` drains every tenant (rounds, tokens/s a
   tenant); ``partitioned_training`` restores llama's step 20 and every
   tenant's losses are finite and fall.
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

    python3 chip_smoke.py --kernels

runs phases 1 and 2 alone (the environment and the kernels) and prints the
same last lines.

    python3 chip_smoke.py --obs-split
    python3 chip_smoke.py --obs-pairs N

need no card and are not part of the run above.

    python -m torch.distributed.run --standalone --nproc-per-node N \
        chip_smoke.py --placement-only --mesh DATA,MODEL

runs only the placement phase, one card a rank, on a DATA × MODEL mesh
(:func:`placement_only`): llama3.2-3b trained on rank 0's card alone
first, then through the sharded step on the mesh (its losses within
3e-2 of the one-card run's) and decoded through ``sharded_decode_fn``;
where "model" is 2 wide or more, llama3.2-3b and mamba2-780m trained side
by side on their own column slices (:func:`tenancy_across`); where it is
4 wide or more, phi3.5-moe-42b-a6.6b and dbrx-132b served whole, their
params drawn by shard.  Rank 0 prints the numbers.  The first prints where the
armed side of the obs overhead pair spends its time, part by part and
module by module, and the Python bytecode instructions each side runs
(:func:`obs_split`).  The second runs ``N`` pairs of the gate's own
estimator on each gated path and prints every sample (:func:`obs_pairs`);
copied into an unpacked parent commit, it compares two trees' armed cost on
one host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import hashlib
import importlib
import io
import json
import math
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
# the feed mixes' tenant shapes, and the mix whose operands are views
FEED_T = (1, 64, 65, 129)
FEED_K = (1, 63, 147, 1025)
FEED_N = (1, 2, 100, 513)
VIEW_MIX = "feeds_views"
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
OBS_PAIRS_FLAG = "--obs-pairs"  # N samples of the gate's estimator (not run by default)
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
# the dense phase: the dense configs that fit one card in bf16, at full width
# and depth, one engine at a time (the first two share one, 55.8 GB; the
# 66.7 GB deepseek-coder-33b fits only alone), with FAMILY_SLOTS and the
# families' requests; dbrx-132b (263 GB) does not fit
DENSE_ENGINES = (
    ("mistral-nemo-12b", "nemotron-4-15b"),
    ("internvl2-26b",),
    ("deepseek-coder-33b",),
)
DENSE_PHASE_S = 180.0
# the train phase: the smoke configs of every family (and the vision frontend)
# card vs CPU, a checkpoint round trip on the card, then llama3.2-3b trained at
# full width and depth; the optimizer is launch/train.py's for TRAIN_STEPS
TRAIN_SMOKES = (
    "llama3.2-3b",
    "phi3.5-moe-42b-a6.6b",
    "mamba2-780m",
    "recurrentgemma-2b",
    "whisper-small",
    "internvl2-26b",
)
TRAIN_SMOKE_STEPS = 2
TRAIN_ARCH = "llama3.2-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 6
TRAIN_OPT = dict(lr=3e-3, warmup_steps=5, total_steps=TRAIN_STEPS)  # launch.train's
TRAIN_CKPT_DIR = "build/train_ckpt"  # gitignored; removed after the round trip
TRAIN_PHASE_S = 150.0
# the placement phase: llama3.2-3b at full width through the sharded step on a
# one-rank NCCL mesh (the train phase's batch, seed and steps); then at smoke
# size one int8 DP step and a checkpoint round trip of the sharded state
PLACEMENT_CKPT_DIR = "build/placement_ckpt"  # gitignored; removed after use
PLACEMENT_PHASE_S = 90.0
PLACEMENT_DECODE = (4, 128, 8)  # rows, max_seq, greedy tokens of the sharded decode
PLACEMENT_ONLY_FLAG = "--placement-only"  # with --mesh DATA,MODEL, under torchrun
MOE_WHOLE = "phi3.5-moe-42b-a6.6b"  # served whole where "model" is 4 wide or more
# the tenancy phase: examples/partitioned_training.py's two tenants (name,
# arch, demand, seed) at full width, trained side by side on the one-rank group
TENANTS = (("llama", TRAIN_ARCH, 10.0, SEED), ("mamba", "mamba2-780m", 5.0, 1))
TENANCY_MAMBA_BATCH = TRAIN_BATCH  # mamba's batch beside llama's state (not cut)
TENANCY_CKPT_DIR = "build/tenancy_ckpt"  # gitignored; removed after use
TENANCY_PHASE_S = 90.0
# the draw check: llama3.2-3b's shards of these (mesh, rank), drawn as that
# rank of a fake process group, against the whole draw; then dbrx-132b's
# ranks of (1, 4), each drawn for real
DRAW_FLAG = "--draw-check"  # the child process of the draw check
DRAW_SHARDS = (((1, 4), 0), ((1, 4), 3), ((16, 16), 0), ((16, 16), 255))
DRAW_BIG, DRAW_BIG_RANKS = "dbrx-132b", (0, 3)
DRAW_PEAK_SLACK = 1e9  # a rank's draw peak may exceed its shards by one GB
DRAW_TIMEOUT_S = 300
EXAMPLES_FLAG = "--examples"  # the child process of the examples phase
KERNELS_FLAG = "--kernels"  # phases 1 and 2 only
EXAMPLES_TIMEOUT_S = 180  # the child takes 33-40 s on an H100 80GB HBM3 at 700 W
EXAMPLES_DIR = "build/examples"  # gitignored; trace_viewer writes its files here
HOST_EXAMPLES = (
    "open_loop_serving",
    "fair_sharing",
    "chaos_serving",
    "memory_contention",
    "overload_serving",
    "trace_viewer",
)
EXAMPLE_TOL = 1e-4  # tests/test_kernels.py's f32 rtol and atol
DECODE_HEADROOM = 4e9  # free bytes a rank needs to decode a model served whole
# AdamW's bytes a parameter: the bf16 grad read, the f32 master, m and v read
# and written, the bf16 param written
ADAMW_BYTES_PER_PARAM = 28
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


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()


def environment(torch, build) -> str:
    card = card_line()
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
            elif name and re.search(r"\bHG?MMA", line):
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
    # every feed path and tile shape of the kernels: each T, K and N below
    # beside each of the others' values once (a Latin square)
    feeds = [
        (t, k, FEED_N[(i + j) % len(FEED_N)])
        for i, t in enumerate(FEED_T)
        for j, k in enumerate(FEED_K)
    ]
    return {
        "uniform": ([(256, 256, 256)] * 4, 128),
        "ragged": (capped[:4], 128),
        "ragged_heavy": (capped, 128),
        "unaligned": (unaligned, 32),
        "feeds": (feeds, 64),
        VIEW_MIX: (feeds, 64),
        "heavy_l0": (first, None),
        "heavy_max": (largest, None),
    }


def operands(
    torch, shapes, dtype: str, seed: int, integer: bool = False, views: bool = False
):
    """Each tenant's x and w.  With ``views`` every operand is a view one
    element into a larger buffer, so no origin lies on a 16-byte boundary:
    every other tenant's rows at pitch cols + 1 (``a[:, 1:]``), the rest's
    at pitch cols from a flat buffer's second element."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def fill(shape):
        if integer:
            v = torch.randint(-4, 5, shape, generator=gen, device="cuda")
        else:
            v = torch.randn(shape, generator=gen, device="cuda")
        return v.to(getattr(torch, dtype))

    def draw(shape, i):
        rows, cols = shape
        if not views:
            return fill(shape)
        if i % 2 == 0:
            return fill((rows, cols + 1))[:, 1:]
        return fill((rows * cols + 1,))[1:].view(rows, cols)

    xs = [draw((t, k), i) for i, (t, k, _) in enumerate(shapes)]
    return xs, [draw((k, n), i) for i, (_, k, n) in enumerate(shapes)]


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
    entries as (name, ms per call, records)."""
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
        (e.key, e.self_device_time_total / 1e3 / calls, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    rows.sort(key=lambda r: -r[1])
    return wall_ms, sum(r[1] for r in rows), rows[:6]


def kernel_time(rows: list, mode: str, calls: int) -> float | None:
    """ms a call of ``mode``'s kernel (one launch a call) among a profile of
    ``calls`` calls (``device_profile``'s top entries): its recorded time
    over its records; None where the profile holds no record of it."""
    hits = [(ms, n) for name, ms, n in rows if f"{mode}_kernel" in name]
    records = sum(n for _, n in hits)
    return sum(ms for ms, _ in hits) * calls / records if records else None


def kernel_registry(K, mixes: dict, calls: dict) -> None:
    """Check every main-path call's launch counters (``launch_stats``, read
    before and after it): one launch, and as many tiles as its launch table's
    grid.  Then fold the host caches (``snapshot_host_caches``, the
    autotuner's included) into one ``repro_torch.obs.MetricsRegistry``,
    check that the autotuner was consulted, and print the counters, the
    registry and its summary.  Runs after the main path, outside every timed
    loop."""
    from repro_torch.obs import MetricsRegistry
    from repro_torch.obs.render import render_summary, snapshot_host_caches

    for (mix, dt, mode), (before, after) in calls.items():
        shapes = tuple(mixes[mix][0])
        # the grid follows the shapes and the dtype, whatever the row pitches
        lds = tuple(k for _, k, _ in shapes), tuple(n for _, _, n in shapes)
        bf16, sms = dt == "bfloat16", K.sm_count(0)
        grid = K.tenant_table(shapes, *lds, mode == "dense", bf16, sms).grid
        launches = sum(after["launches"].values()) - sum(before["launches"].values())
        ctas = after["ctas"] - before["ctas"]
        check(
            launches == 1 and ctas == grid,
            f"{mix} {dt} {mode}: {launches} launches, {ctas} tiles, grid {grid}",
        )
    registry = MetricsRegistry()
    snapshot_host_caches(registry)
    counters = {k: c.value for k, c in registry.counters.items()}
    tuned = counters["kernel.autotune.hits"] + counters["kernel.autotune.misses"]
    check(tuned >= 1, "the block autotuner was never consulted")
    log(f"launch stats: {json.dumps(K.launch_stats())}")
    log(f"kernel registry: {json.dumps(registry.as_dict())}")
    log(render_summary(registry, title="kernel path, host caches"))


def kernel_phase(torch, K, details: dict) -> list[dict]:
    from repro_torch.sim import workloads

    mixes = kernel_mixes(workloads)
    blocks, inputs = {}, {}
    for mix, (shapes, block) in mixes.items():
        for dt in DTYPES:
            tuned = K.autotune_blocks(tuple(shapes), dt, dt) if block is None else None
            blocks[mix, dt] = tuned or (block, block, block)
            inputs[mix, dt] = operands(
                torch, shapes, dt, seed=len(inputs), views=mix == VIEW_MIX
            )

    # -- the main path: fused_tenant_gemm, counters zeroed just before ------
    K.reset_launch_counts()
    results, calls = {}, {}
    for (mix, dt), (xs, ws) in inputs.items():
        bt, bk, bn = blocks[mix, dt]
        for mode in MODES:
            before = K.launch_stats()
            results[mix, dt, mode] = K.fused_tenant_gemm(
                xs, ws, block_t=bt, block_k=bk, block_n=bn, grid_mode=mode
            )
            calls[mix, dt, mode] = before, K.launch_stats()
    torch.cuda.synchronize()
    launches = K.launch_counts()
    log(f"main path launches: {launches}")
    check(all(n > 0 for n in launches.values()), f"a kernel never ran: {launches}")
    kernel_registry(K, mixes, calls)

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
            outs = results[mix, dt, mode]
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
        ixs, iws = operands(
            torch, shapes, dt, seed=1000, integer=True, views=mix == VIEW_MIX
        )
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
                prof, kernel_ms = {}, {}
                for name, fn in calls.items():
                    # a profile that kept no record of the kernel is taken
                    # once more; a second one that keeps none reads null
                    for _ in range(2):
                        prof[name] = device_profile(torch, fn, CALLS_PER_SAMPLE)
                        kernel_ms[name] = kernel_time(
                            prof[name][2], mode, CALLS_PER_SAMPLE
                        )
                        if kernel_ms[name] is not None:
                            break
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
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import decode_step, init_params
    from repro_torch.serving.engine import MultiTenantEngine
    from repro_torch.serving.kv_cache import DecodeSession

    spec = get("llama3.2-3b")
    smoke_decode_check(torch, [spec.arch_id])

    cfg = spec.model
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    card = Mesh(device_grid("cuda", 1), ("data", "model"))
    eng = MultiTenantEngine(TenantMeshManager(card), policy="equal")
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


def serve_engine(torch, phase: str, tenants, seed: int) -> dict:
    """One ``MultiTenantEngine`` on the card: each (name, config) of
    ``tenants`` admitted through ``launch.serve.add_tenant`` (random bf16
    weights drawn on the card from ``seed`` on), ``FAMILY_REQUESTS``
    requests of ``FAMILY_PROMPT`` + ``FAMILY_NEW`` tokens each, served to
    completion.  Every request must finish with tokens in the vocab and the
    last logits must be finite.  Per tenant: tokens/s, rounds, decode-step
    host, profiled and device ms (all slots live), busy share, the bytes
    one step must move over 3.35 TB/s, resident and peak memory, init s."""
    from repro_torch.configs import get
    from repro_torch.distributed.tenancy import TenantMeshManager, device_grid
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.serve import add_tenant
    from repro_torch.models.model import decode_step
    from repro_torch.serving.engine import MultiTenantEngine

    card = Mesh(device_grid("cuda", 1), ("data", "model"))
    eng = MultiTenantEngine(TenantMeshManager(card), policy="equal")
    sessions, stats, seconds = {}, {}, {}
    for i, (arch, cfg) in enumerate(tenants):
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        s = add_tenant(eng, arch, cfg, seed + i, FAMILY_SLOTS, FAMILY_MAX_SEQ)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = cfg.param_count()
        full = get(arch).model.n_layers
        stats[arch] = {
            "family": cfg.family,
            "layers": cfg.n_layers,
            "published_layers": full,
            "parameters": n_params,
            "resident_bytes": torch.cuda.memory_allocated() - before,
            "init_s": init_s,
        }
        seconds[arch] = 0.0
        s.admit = _timed(s.admit, seconds, arch)
        s.step = _timed(s.step, seconds, arch)
        sessions[arch] = s
        cut = f", cut to {cfg.n_layers} of {full} layers" if cfg.n_layers < full else ""
        log(
            f"{phase}: {arch} ({cfg.family}), {n_params} parameters{cut}, "
            f"ready in {init_s:.2f} s"
        )

    rng = np.random.default_rng(seed)
    reqs = {}
    for arch, s in sessions.items():
        shape = (FAMILY_REQUESTS, FAMILY_PROMPT)
        prompts = rng.integers(0, s.cfg.vocab, shape).tolist()
        reqs[arch] = [eng.submit(arch, p, FAMILY_NEW) for p in prompts]
    rounds = dict.fromkeys(sessions, 0)
    t0 = time.perf_counter()
    n_rounds = 0
    while eng.tenants:
        check(n_rounds < 500, f"{phase}: the engine did not drain")
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
        log(f"{phase} {arch}: {json.dumps(stats[arch])}")
    emitted = sum(st["tokens_emitted"] for st in stats.values())
    log(
        f"{phase}: {len(sessions)} tenants drained in {n_rounds} rounds, "
        f"{wall:.2f} s, {emitted / wall:.1f} tokens/s"
    )
    return {"tenants": stats, "rounds": n_rounds, "wall_s": wall}


def _engine_freed(torch, what: str) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated() < 1 << 30, f"{what} were not freed")


def families_phase(torch, K) -> dict:
    """Four tenants of the moe, ssm, hybrid and encdec families at their
    published widths, random bf16 weights, through one ``MultiTenantEngine``
    on the card; no partitioned-GEMM kernel is launched (decode is plain
    PyTorch, as the JAX package's is plain ``jnp``)."""
    from repro_torch.configs import get

    t_phase = time.perf_counter()
    _engine_freed(torch, "the llama tenants")
    K.reset_launch_counts()
    smoke_decode_check(torch, FAMILY_SMOKES)
    tenants = []
    for arch, depth in FAMILY_TENANTS:
        cfg = get(arch).model
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        tenants.append((arch, cfg))
    res = serve_engine(torch, "families", tenants, seed=10)
    launches = K.launch_counts()
    check(sum(launches.values()) == 0, f"the families phase launched: {launches}")
    phase_s = time.perf_counter() - t_phase
    log(f"families: {launches}; phase {phase_s:.1f} s")
    check(phase_s <= FAMILY_PHASE_S, f"families phase took {phase_s:.1f} s")
    return {**res, "phase_s": phase_s}


# ---------------------------------------------------------------------------
# 3c. dense: the dense configs that fit one card, at full width and depth
# ---------------------------------------------------------------------------


def serve_cli_on_card() -> dict:
    """``python -m repro_torch.launch.serve`` with the JAX launcher's
    defaults (three smoke-config tenants), called in this process on the
    card; its printout goes to the log."""
    from repro_torch.launch import serve

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main([])
    text = out.getvalue()
    for line in text.splitlines():
        log(f"launch.serve: {line}")
    check(rc == 0, f"launch.serve exited {rc}")
    lines = text.splitlines()
    queued = [ln for ln in lines if ln.startswith("tenant ")]
    drained = re.search(r"drained in (\d+) rounds", text)
    head = "partition width history (round, tenant, cols):"
    printed = len(queued) == 3 and drained and head in lines and lines[-1] != head
    check(bool(printed), "launch.serve: queued lines, rounds or width history")
    return {"queued": queued, "rounds": int(drained.group(1))}


def dense_phase(torch, K) -> dict:
    """The dense configs that fit one card in bf16, at full width and depth
    on random weights, through ``MultiTenantEngine`` one engine at a time
    (``DENSE_ENGINES``), each engine freed before the next; their smoke
    configs card vs CPU; then ``launch.serve`` on the card.  No
    partitioned-GEMM kernel is launched."""
    from repro_torch.configs import get

    t_phase = time.perf_counter()
    K.reset_launch_counts()
    smoke_decode_check(torch, [a for archs in DENSE_ENGINES for a in archs])
    engines = []
    for i, archs in enumerate(DENSE_ENGINES):
        _engine_freed(torch, "the previous engine's tenants")
        tenants = [(a, get(a).model) for a in archs]
        engines.append(serve_engine(torch, "dense", tenants, seed=20 + 10 * i))
    _engine_freed(torch, "the dense tenants")
    cli = serve_cli_on_card()
    launches = K.launch_counts()
    check(sum(launches.values()) == 0, f"the dense phase launched: {launches}")
    phase_s = time.perf_counter() - t_phase
    log(f"dense: {launches}; phase {phase_s:.1f} s")
    check(phase_s <= DENSE_PHASE_S, f"dense phase took {phase_s:.1f} s")
    return {"engines": engines, "launch_serve": cli, "phase_s": phase_s}


# ---------------------------------------------------------------------------
# 3d. train: the full-sequence forward and the single-card training path
# ---------------------------------------------------------------------------


def _train_setup(
    torch, arch: str, device: str, smoke: bool = True, seed: int = 0, params=None
):
    """What ``python -m repro_torch.launch.train`` builds: the mesh, the
    sharded params (or a copy of ``params``) and optimizer state, its train
    step, its batches."""
    from repro_torch.configs import get
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import (
        TrainConfig,
        init_sharded,
        make_train_step,
    )

    cfg = get(arch).smoke if smoke else get(arch).model
    batch, seq = (2, 16) if smoke else (TRAIN_BATCH, TRAIN_SEQ)
    mesh = make_host_mesh(device=device)
    if params is None:
        params, opt_state = init_sharded(cfg, mesh, seed=seed)
    else:
        params = _tree_to(params, device)
        opt_state = init_opt_state(params)
    step, _ = make_train_step(cfg, mesh, TrainConfig(opt=OptConfig(**TRAIN_OPT)))
    dcfg = DataConfig(vocab=cfg.vocab, batch=batch, seq=seq, seed=SEED)
    extras = {}
    if cfg.frontend == "audio":
        extras["frames"] = (batch, cfg.enc_seq, cfg.d_model)
    elif cfg.frontend == "vision":
        extras["patches"] = (batch, cfg.n_patches, cfg.d_model)

    def batch_at(i):
        return make_batch(dcfg, i, mesh, extras)

    return cfg, params, opt_state, step, batch_at


def smoke_train_check(torch) -> None:
    """Each smoke config: ``TRAIN_SMOKE_STEPS`` train steps on the card and on
    the CPU from the same parameters and batches; every step's loss and
    gradient norm agree within ``BF16_TOL``."""
    for arch in TRAIN_SMOKES:
        cpu = _train_setup(torch, arch, "cpu")
        gpu = _train_setup(torch, arch, "cuda", params=cpu[1])
        for i in range(TRAIN_SMOKE_STEPS):
            ref, out = (
                {k: float(v) for k, v in step(p, o, batch_at(i))[2].items()}
                for _, p, o, step, batch_at in (cpu, gpu)
            )
            for key in ("loss", "grad_norm"):
                err = abs(out[key] - ref[key]) / abs(ref[key])
                what = f"{arch} step {i + 1} {key}: card {out[key]} cpu {ref[key]}"
                check(err < BF16_TOL, what)
        log(
            f"train: {arch} smoke, {TRAIN_SMOKE_STEPS} steps on the card match "
            f"the CPU, loss {out['loss']:.4f} (cpu {ref['loss']:.4f})"
        )


def checkpoint_round_trip(torch) -> None:
    """On the card at smoke size: save after step 2, restore into fresh
    state (other seed), run step 3 — the same loss as an uninterrupted run
    (within 1e-6: the same kernels on the same numbers)."""
    import shutil

    from repro_torch.training import checkpoint as ckpt

    _, params, opt_state, step, batch_at = _train_setup(torch, TRAIN_ARCH, "cuda")
    losses = [float(step(params, opt_state, batch_at(i))[2]["loss"]) for i in range(3)]
    _, params, opt_state, step, batch_at = _train_setup(torch, TRAIN_ARCH, "cuda")
    for i in range(2):
        step(params, opt_state, batch_at(i))
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    ckpt.save(TRAIN_CKPT_DIR, 2, {"params": params, "opt": opt_state})
    _, fresh, fresh_opt, step, batch_at = _train_setup(
        torch, TRAIN_ARCH, "cuda", seed=1
    )
    got = ckpt.restore_latest(TRAIN_CKPT_DIR, {"params": fresh, "opt": fresh_opt})
    shutil.rmtree(TRAIN_CKPT_DIR)
    check(got is not None and got[0] == 2, f"checkpoint: restored {got and got[0]}")
    state = got[1]
    check(int(state["opt"]["step"]) == 2, "checkpoint: optimizer step not restored")
    loss = float(step(state["params"], state["opt"], batch_at(2))[2]["loss"])
    err = abs(loss - losses[2]) / abs(losses[2])
    check(err <= 1e-6, f"checkpoint: resumed step 3 loss {loss} vs {losses[2]}")
    log(
        f"train: checkpoint round trip on the card, step 3 loss {loss} resumed "
        f"vs {losses[2]} uninterrupted (rel {err:.2e})"
    )


def train_flops(params, cfg, batch: int, seq: int) -> dict:
    """The operations one train step must do, by type: the bf16 matmuls of
    the layers (forward, remat forward, backward = 4 forwards) and of the
    head (3), and the f32 attention scores and values (4 forwards)."""
    tokens = batch * seq
    blocks = _leaf_items(params["blocks"])
    layer_weights = sum(t.numel() for _, t in blocks if t.dim() == 3)
    head = params["lm_head"].numel()
    attn = 4 * batch * seq * seq * cfg.n_heads * cfg.head_dim * cfg.n_layers
    return {
        "bfloat16": 4 * 2 * tokens * layer_weights + 3 * 2 * tokens * head,
        "float32": 4 * attn,
    }


def _kernel_kind(name: str) -> str:
    """matmul, reduction, elementwise (copies and casts included) or other,
    from a CUDA kernel's name."""
    n = name.lower()
    if any(k in n for k in ("gemm", "cutlass", "nvjet", "xmma")):
        return "matmul"
    if "reduce" in n:
        return "reduction"
    if "elementwise" in n or "copy" in n:
        return "elementwise"
    return "other"


def _stream_ms(torch, fn):
    """(``fn()``, ms between CUDA events recorded before and after it)."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def step_split(torch, cfg, params, opt_state, batch) -> dict:
    """A train step's two halves timed alone on the stream: the forward and
    backward (``loss_and_grads``), then the AdamW update (which updates
    the state once more)."""
    from repro_torch.training.optimizer import OptConfig, adamw_update
    from repro_torch.training.train_loop import loss_and_grads

    (_, grads), fb_ms = _stream_ms(torch, lambda: loss_and_grads(cfg, params, batch))
    opt = OptConfig(**TRAIN_OPT)
    _, adamw_ms = _stream_ms(
        torch, lambda: adamw_update(opt, params, grads, opt_state)
    )
    return {"forward_backward_ms": fb_ms, "adamw_ms": adamw_ms}


def train_phase(torch, K) -> dict:
    """The smoke configs card vs CPU, a checkpoint round trip, then
    llama3.2-3b trained at full width and depth (random bf16 weights, batch
    4 × seq 512, ``TRAIN_STEPS`` steps) through the same calls as
    ``python -m repro_torch.launch.train``; no partitioned-GEMM kernel is
    launched (training is plain PyTorch, as the JAX package's is plain
    ``jnp``)."""
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    freed = torch.cuda.memory_allocated() < 1 << 30
    check(freed, "the families tenants were not freed")
    K.reset_launch_counts()
    smoke_train_check(torch)
    checkpoint_round_trip(torch)
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, opt_state, step, batch_at = _train_setup(
        torch, TRAIN_ARCH, "cuda", smoke=False
    )
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    n_params = sum(t.numel() for _, t in _leaf_items(params))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(params, cfg, TRAIN_BATCH, TRAIN_SEQ)
    flop_ms = sum(f / PEAK_FLOPS[dt] for dt, f in flops.items()) * 1e3
    byte_ms = n_params * ADAMW_BYTES_PER_PARAM / PEAK_BYTES_PER_S * 1e3
    # the matmuls and the optimizer pass run one after the other
    bound_ms = flop_ms + byte_ms
    log(
        f"train: {TRAIN_ARCH} at full width, {cfg.n_layers} layers, "
        f"{n_params} parameters, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}; "
        f"init {init_s:.2f} s, resident "
        f"{resident / 1e9:.2f} GB; bound {bound_ms:.1f} ms (flops {flop_ms:.1f}: "
        f"{flops['bfloat16']:.4g} bf16 + {flops['float32']:.4g} f32; AdamW bytes "
        f"{byte_ms:.1f})"
    )
    rows = []
    for i in range(TRAIN_STEPS):
        batch = batch_at(i)
        torch.cuda.synchronize()
        profiled = i == TRAIN_STEPS - 1
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) if profiled else contextlib.nullcontext() as prof:
            t1 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, batch)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t1) * 1e3
        row = {
            "step": i + 1,
            "loss": loss,
            "grad_norm": gnorm,
            "host_ms": host_ms,
            "profiled": profiled,
            "tokens_per_s": tokens / host_ms * 1e3,
            "bound_ms": bound_ms,
            "flop_bound_ms": flop_ms,
            "byte_bound_ms": byte_ms,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
        }
        if prof is not None:
            dev = [
                (e.key, e.self_device_time_total / 1e3)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
            ]
            dev.sort(key=lambda r: -r[1])
            row["device_ms"] = sum(ms for _, ms in dev)
            check(row["device_ms"] > 0, "train: the profiled step shows no device time")
            row["device_busy_share"] = row["device_ms"] / host_ms
            row["top_device_ms"] = dev[:6]
            kinds: dict = {}
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    kind = kinds.setdefault(_kernel_kind(e.key), [0, 0.0])
                    kind[0] += e.count
                    kind[1] += e.self_device_time_total / 1e3
            row["device_by_kind"] = {
                k: {"kernels": n, "ms": ms} for k, (n, ms) in kinds.items()
            }
        finite = math.isfinite(loss) and math.isfinite(gnorm)
        check(finite, f"train step {i + 1}: {row}")
        rows.append(row)
        log(f"train step: {json.dumps(row)}")
    launches = K.launch_counts()
    check(sum(launches.values()) == 0, f"the train phase launched: {launches}")
    stats = {
        "arch": TRAIN_ARCH,
        "parameters": n_params,
        "init_s": init_s,
        "resident_bytes": resident,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        # steps 2 to 5: neither the first nor the profiled one
        "step_ms_median": statistics.median(r["host_ms"] for r in rows[1:-1]),
        "first_step_ms": rows[0]["host_ms"],
        "device_ms": rows[-1]["device_ms"],
        "bound_ms": bound_ms,
        "losses": [r["loss"] for r in rows],
    }
    stats["tokens_per_s"] = tokens / stats["step_ms_median"] * 1e3
    stats.update(step_split(torch, cfg, params, opt_state, batch))
    del params, opt_state, m, batch
    gc.collect()
    torch.cuda.empty_cache()
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"train: {json.dumps(stats)}; {launches}")
    phase_s = stats["phase_s"]
    check(phase_s <= TRAIN_PHASE_S, f"train phase took {phase_s:.1f} s")
    return stats


# ---------------------------------------------------------------------------
# 3e. placement: the sharded step on a one-rank NCCL mesh
# ---------------------------------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def placement_train(torch, mesh, train: dict) -> dict:
    """llama3.2-3b at full width and depth through the sharded step on
    ``mesh``: params and AdamW state DTensors, each layer's leaves
    gathered over the axes of more than one rank and computed on their
    split over "model"; the train phase's seed, batches and steps, so the
    losses must equal its losses within ``BF16_TOL``.  On one rank nothing
    is issued (``distributed.collectives``: no axis of one is gathered
    over, no "model" axis of one is lent), so the profiled step launches
    no NCCL kernel and the losses are the train phase's bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import (
        TrainConfig,
        init_sharded,
        make_train_step,
    )

    cfg = get(TRAIN_ARCH).model
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt_state = init_sharded(cfg, mesh, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    step, jitted = make_train_step(cfg, mesh, TrainConfig(opt=OptConfig(**TRAIN_OPT)))
    dcfg = DataConfig(vocab=cfg.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=SEED)
    rows = []
    for i in range(TRAIN_STEPS):
        batch = make_batch(dcfg, i, mesh)
        if i == 0:
            jitted(params, opt_state, batch)  # every leaf placed by its spec
        profiled = i == TRAIN_STEPS - 1
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with profile(activities=acts) if profiled else contextlib.nullcontext() as prof:
            t1 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, batch)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t1) * 1e3
        row = {"step": i + 1, "loss": loss, "grad_norm": gnorm, "host_ms": host_ms}
        if prof is not None:
            dev = [
                e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
            ]
            nccl = [e for e in dev if "nccl" in e.key.lower()]
            row["device_ms"] = sum(e.self_device_time_total for e in dev) / 1e3
            row["nccl_kernels"] = sum(e.count for e in nccl)
            row["nccl_ms"] = sum(e.self_device_time_total for e in nccl) / 1e3
            row["kernels"] = sum(e.count for e in dev)
            kinds: dict = {}
            for e in dev:
                kind = "nccl" if e in nccl else _kernel_kind(e.key)
                k = kinds.setdefault(kind, [0, 0.0])
                k[0] += e.count
                k[1] += e.self_device_time_total / 1e3
            row["device_by_kind"] = {
                k: {"kernels": n, "ms": ms} for k, (n, ms) in kinds.items()
            }
            top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
            row["top_device_ms"] = [
                [e.key[:90], e.count, e.self_device_time_total / 1e3] for e in top
            ]
            busy = row["device_ms"] > 0
            check(busy, "placement: the profiled step shows no device time")
        check(math.isfinite(loss) and math.isfinite(gnorm), f"placement step: {row}")
        rows.append(row)
        log(f"placement step: {json.dumps(row)}")
    losses = [r["loss"] for r in rows]
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, train["losses"])]
    what = f"placement losses {losses} vs train {train['losses']}"
    check(max(errs) <= BF16_TOL, what)
    if mesh.size == 1:
        check(rows[-1]["nccl_kernels"] == 0, f"placement at one rank: {rows[-1]}")
        check(losses == train["losses"], f"not bit-equal at one rank: {what}")
    stats = {
        "init_s": init_s,
        "resident_bytes": resident,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "step_ms_median": statistics.median(r["host_ms"] for r in rows[1:-1]),
        "one_device_step_ms_median": train["step_ms_median"],
        "nccl_kernels_a_step": rows[-1]["nccl_kernels"],
        "nccl_ms_a_step": rows[-1]["nccl_ms"],
        "kernels_a_step": rows[-1]["kernels"],
        "device_ms": rows[-1]["device_ms"],
        "one_device_device_ms": train["device_ms"],
        "losses": losses,
        "max_rel_loss_err": max(errs),
        "losses_bit_equal": losses == train["losses"],
    }
    del opt_state, m, batch
    gc.collect()
    stats.update(placement_decode(torch, cfg, mesh, params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def _greedy(torch, fn, rows: slice, n: int, vocab: int) -> tuple[list, list, list]:
    """``n`` greedy decode steps of ``fn(token, cache_len) -> logits`` from
    seeded prompt tokens (this rank's ``rows`` of them): the logits and
    tokens of each step, and each step's host ms."""
    gen = torch.Generator().manual_seed(SEED)
    tok = torch.randint(0, vocab, (PLACEMENT_DECODE[0], 1), generator=gen)[rows].cuda()
    lens = torch.zeros(tok.shape[0], dtype=torch.int32, device=tok.device)
    logits, tokens, ms = [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = fn(tok, lens)
        tok = lg[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg.float())
        tokens.append(tok)
        lens = lens + 1
    return logits, tokens, ms


def _my_rows(t, mesh) -> slice:
    """This rank's rows of a batch-leading ``t`` placed as a batch."""
    from repro_torch.distributed.sharding import batch_shardings

    sh = batch_shardings({"t": t}, mesh)["t"]
    return sh.local_slices(t.shape, mesh.device_mesh.get_coordinate())[0]


def _same_greedy(torch, got, got_tok, ref, ref_tok, rows) -> tuple[list, int, int]:
    """Each step's logits of this rank's ``rows`` within ``BF16_TOL`` of the
    reference's and the greedy tokens equal, by tests/test_torch_serving.py's
    margin rule: where a row's tokens first differ, the reference's top-2
    margin must lie within twice the bf16 band (rounding alone can flip the
    argmax there), and the row is compared no further (its prefixes
    differ).  Returns the errors, the equal tokens and the rows flipped."""
    live = torch.ones(got_tok[0].shape[0], dtype=torch.bool, device=got_tok[0].device)
    errs, equal, flips = [], 0, 0
    for a, ta, b, tb in zip(got, got_tok, ref, ref_tok):
        b, tb = b[rows], tb[rows]
        if live.any():
            errs.append(float((a - b)[live].abs().max() / b[live].abs().max()))
        differ = (ta != tb)[:, 0] & live
        for r in differ.nonzero()[:, 0].tolist():
            top = b[r, -1].topk(2).values
            margin = float(top[0] - top[1])
            bound = 2 * (BF16_TOL + BF16_TOL * abs(float(top[0])))
            check(margin <= bound, f"greedy token differs at margin {margin}")
            flips += 1
        equal += int((live & ~differ).sum())
        live &= ~differ
    check(max(errs) <= BF16_TOL, f"sharded decode logits: {errs}")
    check(equal > 0, "sharded decode: no greedy token compared")
    return errs, equal, flips


def _profiled_decode(torch, mesh, step) -> tuple[int, dict]:
    """One more decode step under the profiler and the port's collective
    log: its NCCL kernels, and its collectives by the mesh axis they run
    over (``{axis: calls}``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.distributed.collectives import count_collectives

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with count_collectives() as log:
            step()
        torch.cuda.synchronize()
    nccl = sum(
        e.count
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and "nccl" in e.key.lower()
    )
    return nccl, log.by_axis(mesh)


def placement_decode(torch, cfg, mesh, params) -> dict:
    """``cfg`` at full width through ``launch.steps.sharded_decode_fn`` on
    ``mesh`` (the heads, ff columns and vocab split over "model", the
    cache's rows over "data" and its KV sequence over "model"):
    ``PLACEMENT_DECODE`` greedy tokens against the one-device
    ``decode_step`` on the whole params, every step's logits within
    ``BF16_TOL`` and the greedy tokens equal (``_same_greedy``); on one
    rank the logits bit for bit, and one more step, profiled, launches no
    NCCL kernel."""
    from torch.distributed.tensor import DTensor

    from repro_torch._tree import tree_map
    from repro_torch.distributed.sharding import (
        cache_shardings,
        locals_of,
        params_shardings,
    )
    from repro_torch.launch.steps import sharded_decode_fn
    from repro_torch.models.model import decode_step, init_cache

    n_rows, max_seq, n = PLACEMENT_DECODE
    p_sh = params_shardings(params, mesh)
    local = locals_of(params, p_sh)
    cache = init_cache(cfg, n_rows, max_seq, device="cuda")
    c_sh = cache_shardings(cache, mesh)
    local_c = tree_map(lambda t: t.clone(), locals_of(cache, c_sh))
    rows = _my_rows(cache["k"][0], mesh)
    fn = sharded_decode_fn(cfg, p_sh, c_sh)
    with torch.no_grad():
        got, got_tok, ms = _greedy(
            torch, lambda t, c: fn(local, local_c, t, c)[0], rows, n, cfg.vocab
        )
        lens = torch.full((got_tok[-1].shape[0],), n, dtype=torch.int32, device="cuda")
        nccl, by_axis = _profiled_decode(
            torch, mesh, lambda: fn(local, local_c, got_tok[-1], lens)
        )
        del local_c
        whole = tree_map(
            lambda t: t.full_tensor() if isinstance(t, DTensor) else t, params
        )
        ref, ref_tok, one_ms = _greedy(
            torch,
            lambda t, c: decode_step(cfg, whole, cache, t, c)[0],
            slice(None),
            n,
            cfg.vocab,
        )
        del whole, cache
    errs, equal, flips = _same_greedy(torch, got, got_tok, ref, ref_tok, rows)
    bit_equal = all(torch.equal(a, b[rows]) for a, b in zip(got, ref))
    if mesh.size == 1:
        check(bit_equal, f"sharded decode logits at one rank differ: {errs}")
        check(nccl == 0, f"sharded decode at one rank launched {nccl} NCCL kernels")
    return {
        "decode_logits_bit_equal": bit_equal,
        "decode_nccl_kernels_a_step": nccl,
        "decode_collectives_a_step": by_axis,
        "decode_tokens": n,
        "decode_rows": n_rows,
        "decode_max_rel_err": max(errs),
        "decode_greedy_equal": equal,
        "decode_greedy_flips_at_a_tie": flips,
        "decode_ms_a_step": sum(ms) / n,
        "decode_tokens_per_s": n_rows * n / sum(ms) * 1e3,
        "one_device_decode_ms_a_step": sum(one_ms) / n,
        # the first step of either run warms what the train step did not
        "decode_ms_median_after_first": statistics.median(ms[1:]),
        "one_device_decode_ms_median_after_first": statistics.median(one_ms[1:]),
    }


def served_whole(torch, mesh, arch: str) -> dict:
    """``arch`` at full width and depth served through
    ``sharded_decode_fn``: its params drawn by shard
    (``init_params_sharded``, as ``init_sharded`` draws them: no rank
    holds a whole leaf; no AdamW state), its experts split over "model",
    ``PLACEMENT_DECODE`` greedy tokens where every rank has
    ``DECODE_HEADROOM`` bytes free after the draw; finite logits of the
    whole vocab."""
    import torch.distributed as dist

    from repro_torch._tree import tree_map
    from repro_torch.configs import get
    from repro_torch.distributed.sharding import (
        cache_shardings,
        locals_of,
        params_shardings,
    )
    from repro_torch.launch.steps import sharded_decode_fn
    from repro_torch.models.model import init_cache, init_params
    from repro_torch.training.train_loop import init_params_sharded

    cfg = get(arch).model
    n_rows, max_seq, n = PLACEMENT_DECODE
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params_sharded(cfg, mesh, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    draw_peak = torch.cuda.max_memory_allocated()
    p_sh = params_shardings(init_params(cfg, device="meta"), mesh)
    stats = {
        "arch": arch,
        "layers": cfg.n_layers,
        "experts_a_rank": p_sh["blocks"]["moe"]["up"].shard_shape(
            params["blocks"]["moe"]["up"].shape
        )[1],
        "shard_bytes": _shard_bytes(cfg, mesh),
        "init_s": init_s,
        "resident_bytes": resident,
        "draw_peak_bytes": draw_peak,
    }
    room = torch.tensor([torch.cuda.mem_get_info()[0]], device=mesh.local_device)
    dist.all_reduce(room, op=dist.ReduceOp.MIN)  # every rank decodes, or none
    stats["decoded"] = int(room) >= DECODE_HEADROOM
    if stats["decoded"]:
        local = locals_of(params, p_sh)
        cache = init_cache(cfg, n_rows, max_seq, device="cuda")
        c_sh = cache_shardings(cache, mesh)
        local_c = tree_map(lambda t: t.clone(), locals_of(cache, c_sh))
        rows = _my_rows(cache["k"][0], mesh)
        del cache
        fn = sharded_decode_fn(cfg, p_sh, c_sh)
        with torch.no_grad():
            logits, _, ms = _greedy(
                torch, lambda t, c: fn(local, local_c, t, c)[0], rows, n, cfg.vocab
            )
        finite = all(bool(torch.isfinite(lg).all()) for lg in logits)
        check(finite and logits[-1].shape[-1] == cfg.vocab, f"{arch}: logits")
        stats["decode_ms_a_step"] = sum(ms) / n
        stats["tokens_per_s"] = n_rows * n / sum(ms) * 1e3
        del local, local_c, logits
    stats["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def placement_smoke(torch, mesh) -> dict:
    """At smoke size on ``mesh``: a checkpoint of the sharded state saved
    and restored onto the mesh (bit-equal, leaf for leaf), and one int8
    ``make_dp_train_step`` step from the restored state, whose loss is the
    sharded step's on the same state and batch."""
    import shutil

    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get
    from repro_torch.distributed.compression import CompressionConfig
    from repro_torch.distributed.sharding import params_shardings
    from repro_torch.models.model import init_params
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import (
        TrainConfig,
        init_dp_error_state,
        init_sharded,
        make_dp_train_step,
        make_train_step,
        opt_shardings,
    )

    cfg = get(TRAIN_ARCH).smoke
    params, opt_state = init_sharded(cfg, mesh, seed=SEED)
    batch = make_batch(DataConfig(vocab=cfg.vocab, batch=2, seq=16, seed=SEED), 0, mesh)
    shutil.rmtree(PLACEMENT_CKPT_DIR, ignore_errors=True)
    ckpt.save(PLACEMENT_CKPT_DIR, 1, {"params": params, "opt": opt_state})
    shapes = init_params(cfg, device="meta")
    like = {"params": shapes, "opt": init_opt_state(shapes)}
    shardings = {
        "params": params_shardings(shapes, mesh),
        "opt": opt_shardings(shapes, mesh),
    }
    state = ckpt.restore(PLACEMENT_CKPT_DIR, 1, like, shardings)
    shutil.rmtree(PLACEMENT_CKPT_DIR)
    saved = dict(_leaf_items({"params": params, "opt": opt_state}))
    for name, t in _leaf_items(state):
        check(isinstance(t, DTensor), f"placement checkpoint: {name} restored unplaced")
        same = torch.equal(t.to_local(), saved[name].to_local())
        check(same, f"placement checkpoint: {name} differs after the round trip")
    opt = OptConfig(**TRAIN_OPT)
    step, _ = make_train_step(cfg, mesh, TrainConfig(opt=opt))
    sharded_loss = float(step(params, opt_state, batch)[2]["loss"])
    int8 = CompressionConfig(kind="int8", block=64)
    dp = make_dp_train_step(cfg, mesh, TrainConfig(opt=opt, compression=int8))
    err = init_dp_error_state(state["params"])
    _, _, err, m = dp(state["params"], state["opt"], err, batch)
    dp_loss = float(m["loss"])
    check(math.isfinite(dp_loss), f"placement: int8 DP step loss {dp_loss}")
    check(any(bool(e.any()) for _, e in _leaf_items(err)), "int8 DP: no residual")
    err_rel = abs(dp_loss - sharded_loss) / abs(sharded_loss)
    check(err_rel <= BF16_TOL, f"placement: DP loss {dp_loss} vs {sharded_loss}")
    return {
        "checkpoint_leaves_bit_equal": len(saved),
        "dp_int8_loss": dp_loss,
        "sharded_loss": sharded_loss,
        "dp_loss_bit_equal": dp_loss == sharded_loss,
    }


def placement_phase(torch, K, train: dict) -> dict:
    """The sharded step, the DP step and the sharded checkpoints through a
    one-rank NCCL group (``launch.mesh.init_distributed``, as ``torchrun
    --nproc-per-node 1`` starts it) and ``make_host_mesh()`` over it: the
    code that runs on several cards, at one.  No partitioned-GEMM kernel
    is launched."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_host_mesh

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated() < 1 << 30, "the train phase was not freed")
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    env.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    os.environ.update(env)
    K.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        dev = init_distributed("cuda")
        mesh = make_host_mesh(device="cuda")
        group_s = time.perf_counter() - t0
        check(mesh.device_mesh is not None, "placement: the mesh has no DeviceMesh")
        log(
            f"placement: {dist.get_backend()} group of {dist.get_world_size()} on "
            f"{dev}, mesh {mesh.axis_sizes}, up in {group_s:.2f} s"
        )
        stats = placement_train(torch, mesh, train)
        stats.update(placement_smoke(torch, mesh))
        stats["card"] = card_line()
        launches = K.launch_counts()
        check(sum(launches.values()) == 0, f"the placement phase launched: {launches}")
        stats["group_s"] = group_s
        stats["phase_s"] = time.perf_counter() - t_phase
        log(f"placement: {json.dumps(stats)}; {launches}")
        phase_s = stats["phase_s"]
        check(phase_s <= PLACEMENT_PHASE_S, f"placement took {phase_s:.1f} s")
        del mesh
        stats["tenancy"] = tenancy_phase(torch, K, train)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    return stats


# ---------------------------------------------------------------------------
# 3f. tenancy: two jobs on sub-meshes of one mesh (examples/partitioned_training.py)
# ---------------------------------------------------------------------------


def _tenant_job(torch, arch: str, mesh, seed: int, batch: int, state=None) -> dict:
    """One tenant's training job on ``mesh`` (its sub-mesh, or the whole
    mesh it time-shares): the params and state drawn there (or ``state``,
    restored there), its step and batches at full width."""
    from repro_torch.configs import get
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import (
        TrainConfig,
        init_sharded,
        make_train_step,
    )

    cfg = get(arch).model
    t0 = time.perf_counter()
    if state is None:
        params, opt_state = init_sharded(cfg, mesh, seed=seed)
    else:
        params, opt_state = state["params"], state["opt"]
    torch.cuda.synchronize()
    step, jitted = make_train_step(cfg, mesh, TrainConfig(opt=OptConfig(**TRAIN_OPT)))
    return {
        "arch": arch,
        "cfg": cfg,
        "mesh": mesh,
        "params": params,
        "opt": opt_state,
        "step": step,
        "jitted": jitted,
        "data": DataConfig(vocab=cfg.vocab, batch=batch, seq=TRAIN_SEQ, seed=SEED),
        "init_s": time.perf_counter() - t0,
        "losses": [],
        "ms": [],
        "groups": set(),
    }


def _step_job(torch, job: dict, i: int, profiled: bool = False) -> dict:
    """Step ``i`` of a tenant's job (its first checks every leaf's
    placement); its host ms, loss and the process groups of every
    collective it issued (the ranks of each); profiled: its NCCL and
    partitioned-GEMM kernels."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.distributed.collectives import count_collectives
    from repro_torch.training.data import make_batch

    batch = make_batch(job["data"], i, job["mesh"])
    if not job["losses"]:
        job["jitted"](job["params"], job["opt"], batch)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) if profiled else contextlib.nullcontext() as prof:
        with count_collectives() as collectives:
            t0 = time.perf_counter()
            job["params"], job["opt"], m = job["step"](job["params"], job["opt"], batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
    check(math.isfinite(loss), f"tenancy: {job['arch']} step {i + 1} loss {loss}")
    job["losses"].append(loss)
    job["ms"].append(ms)
    job["groups"] |= {
        tuple(dist.get_process_group_ranks(g)) for _, g in collectives.groups
    }
    if prof is None:
        return {}
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in prof.key_averages() if e.device_type == cuda]
    check(sum(e.self_device_time_total for e in dev) > 0, "tenancy: no device time")
    return {
        "nccl_kernels": sum(e.count for e in dev if "nccl" in e.key.lower()),
        "partitioned_gemm_kernels": sum(e.count for e in dev if kernel_name(e.key)),
        "kernels": sum(e.count for e in dev),
    }


def _tenant_stats(job: dict) -> dict:
    return {
        "arch": job["arch"],
        "ranks": job["mesh"].device_mesh.mesh.flatten().tolist(),
        "init_s": job["init_s"],
        "losses": job["losses"],
        "step_ms": job["ms"],
        # steps 2 to 5: neither the first nor the profiled one
        "step_ms_median": statistics.median(job["ms"][1:-1]),
        "groups": sorted(job["groups"]),
    }


def tenancy_phase(torch, K, train: dict) -> dict:
    """examples/partitioned_training.py's flow through the port on the
    one-rank NCCL group: ``TenantMeshManager(make_host_mesh(model=1),
    "model", policy="proportional")`` admits llama3.2-3b (demand 10) and
    mamba2-780m (demand 5); llama gets the one column and trains on its
    sub-mesh the train phase's steps (seed, batches), mamba time-shares
    the whole mesh, their steps interleaved; llama's losses must be the
    train phase's bit for bit, and its profiled last step launches 0 NCCL
    and 0 partitioned-GEMM kernels.  Then each saves its params, mamba is
    released, ``grow_into_free`` runs, and llama's checkpoint is restored
    onto its sub-mesh (by its shardings): every leaf bit-equal.  No
    partitioned-GEMM kernel is launched, and the phase fits in
    ``TENANCY_PHASE_S``."""
    import shutil

    from repro_torch.distributed.sharding import params_shardings
    from repro_torch.distributed.tenancy import TenantMeshManager
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import init_params
    from repro_torch.training import checkpoint as ckpt

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated() < 1 << 30, "the placement phase was not freed")
    K.reset_launch_counts()
    mesh = make_host_mesh(model=1, device="cuda")
    mgr = TenantMeshManager(mesh, "model", policy="proportional")
    for name, _, demand, _ in TENANTS:
        mgr.admit(name, demand=demand)
    grants = {k: str(v) for k, v in mgr.rebalance().items()}
    check(list(grants) == ["llama"], f"tenancy: grants {grants}")
    torch.cuda.reset_peak_memory_stats()
    jobs = {}
    for name, arch, _, seed in TENANTS:
        # one column: llama holds it, mamba time-shares the whole mesh
        placed = mgr.tenant(name).partition is not None
        sub = mgr.submesh(name) if placed else mesh
        batch = TRAIN_BATCH if placed else TENANCY_MAMBA_BATCH
        jobs[name] = _tenant_job(torch, arch, sub, seed, batch)
    resident = torch.cuda.memory_allocated()
    profiled = {}
    for i in range(TRAIN_STEPS):
        for name, job in jobs.items():
            last = name == "llama" and i == TRAIN_STEPS - 1
            profiled.update(_step_job(torch, job, i, profiled=last))
    peak = torch.cuda.max_memory_allocated()
    llama = jobs["llama"]
    what = f"tenancy: llama {llama['losses']} vs the train phase {train['losses']}"
    check(llama["losses"] == train["losses"], what)
    check(profiled["nccl_kernels"] == 0, f"tenancy: a sub-mesh step {profiled}")
    check(profiled["partitioned_gemm_kernels"] == 0, f"tenancy: {profiled}")
    stats = {name: _tenant_stats(job) for name, job in jobs.items()}
    stats.update(
        grants=grants,
        resident_bytes_both=resident,
        max_memory_allocated_both=peak,
        profiled_llama_step=profiled,
    )

    # each tenant saves its params when it finishes; mamba drains
    shutil.rmtree(TENANCY_CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    for name, job in jobs.items():
        ckpt.save(f"{TENANCY_CKPT_DIR}/{name}", TRAIN_STEPS, {"params": job["params"]})
        job["opt"] = None
    stats["save_s"] = time.perf_counter() - t0
    del jobs["mamba"]
    mgr.release("mamba")
    stats["grown"] = {k: str(v) for k, v in mgr.grow_into_free().items()}
    gc.collect()
    torch.cuda.empty_cache()
    sub = mgr.submesh("llama")
    shapes = init_params(llama["cfg"], device="meta")
    t0 = time.perf_counter()
    restored = ckpt.restore(
        f"{TENANCY_CKPT_DIR}/llama",
        TRAIN_STEPS,
        {"params": shapes},
        {"params": params_shardings(shapes, sub)},
    )
    torch.cuda.synchronize()
    stats["restore_s"] = time.perf_counter() - t0
    shutil.rmtree(TENANCY_CKPT_DIR)
    saved = dict(_leaf_items(llama["params"]))
    for name, t in _leaf_items(restored["params"]):
        same = torch.equal(t.to_local(), saved[name].to_local())
        check(same, f"tenancy: llama's {name} differs after the restore")
    stats["restored_leaves_bit_equal"] = len(saved)
    del llama, jobs, restored, saved
    gc.collect()
    torch.cuda.empty_cache()
    launches = K.launch_counts()
    check(sum(launches.values()) == 0, f"the tenancy phase launched: {launches}")
    stats["card"] = card_line()
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"tenancy: {json.dumps(stats)}; {launches}")
    phase_s = stats["phase_s"]
    check(phase_s <= TENANCY_PHASE_S, f"tenancy took {phase_s:.1f} s")
    return stats


# ---------------------------------------------------------------------------
# 3g. the sharded draw: a rank draws only its shards
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _as_rank(shape: tuple, rank: int, device: str):
    """A ``shape`` ("data", "model") mesh seen from ``rank`` of a fake
    process group of its size (no other rank exists)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh

    world = math.prod(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield make_mesh(shape, ("data", "model"), device=device)
    finally:
        dist.destroy_process_group()


def _shard_bytes(cfg, mesh) -> int:
    """The bytes of a rank's shards of ``cfg``'s params, from the specs on
    the meta device."""
    from repro_torch.distributed.sharding import params_shardings
    from repro_torch.models.model import init_params

    shapes = init_params(cfg, device="meta")
    sh = dict(_leaf_items(params_shardings(shapes, mesh)))
    return sum(
        math.prod(sh[name].shard_shape(t.shape)) * t.element_size()
        for name, t in _leaf_items(shapes)
    )


def draw_child(device: str = "cuda") -> int:
    """The draw check, in a process of its own (no process group of the
    script's is up): llama3.2-3b drawn whole on the card, then its shards
    for each of ``DRAW_SHARDS`` drawn as that rank of a fake group, each
    bit-equal to the whole draw's slice; then ``DRAW_BIG``'s ranks of
    (1, 4), drawn for real one after the other: the resident bytes against
    the specs' shard bytes, the peak (at most ``DRAW_PEAK_SLACK`` above
    the resident bytes) and the seconds.  Prints one JSON line."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    import repro_torch.kernels as K
    from repro_torch.configs import get
    from repro_torch.distributed.sharding import params_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import init_params
    from repro_torch.training.train_loop import init_params_sharded

    K.reset_launch_counts()
    out: dict = {"shards": [], "big": []}
    cfg = get(TRAIN_ARCH).model
    whole = init_params(cfg, SEED, device=device)
    for shape, rank in DRAW_SHARDS:
        with _as_rank(shape, rank, device) as mesh:
            t0 = time.perf_counter()
            got = init_params_sharded(cfg, mesh, seed=SEED)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            coord = mesh.coordinate()
            sh = dict(_leaf_items(params_shardings(whole, mesh)))
            mine = dict(_leaf_items(got))
            for name, w in _leaf_items(whole):
                box = sh[name].local_slices(w.shape, coord)
                same = torch.equal(mine[name].to_local(), w[box])
                check(same, f"draw: {TRAIN_ARCH} {name} at {shape} rank {rank}")
            out["shards"].append(
                {
                    "arch": TRAIN_ARCH,
                    "mesh": list(shape),
                    "rank": rank,
                    "leaves_bit_equal": len(mine),
                    "shard_bytes": _shard_bytes(cfg, mesh),
                    "s": seconds,
                }
            )
            del got, mine
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    big = get(DRAW_BIG).model
    meta = make_mesh((16, 16), ("data", "model"), device="meta")
    out["big_shard_bytes_16x16"] = _shard_bytes(big, meta)
    for rank in DRAW_BIG_RANKS:
        with _as_rank((1, 4), rank, device) as mesh:
            spec = _shard_bytes(big, mesh)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            got = init_params_sharded(big, mesh, seed=SEED)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            resident = torch.cuda.memory_allocated() - base
            peak = torch.cuda.max_memory_allocated() - base
            row = {
                "arch": DRAW_BIG,
                "mesh": [1, 4],
                "rank": rank,
                "shard_bytes": spec,
                "resident_bytes": resident,
                "peak_bytes": peak,
                "peak_over_resident_bytes": peak - resident,
                "s": seconds,
            }
            check(peak <= resident + DRAW_PEAK_SLACK, f"draw: {row}")
            out["big"].append(row)
            del got
    launches = K.launch_counts()
    check(sum(launches.values()) == 0, f"the draw check launched: {launches}")
    print(json.dumps(out), flush=True)
    return 0


def draw_check(torch) -> dict:
    """The draw check (``draw_child``) in a fresh interpreter on the card,
    within ``DRAW_TIMEOUT_S``: its numbers, or its failure."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), DRAW_FLAG],
        capture_output=True,
        text=True,
        timeout=DRAW_TIMEOUT_S,
    )
    check(run.returncode == 0, f"the draw check failed:\n{run.stderr[-4000:]}")
    stats = json.loads(run.stdout.strip().splitlines()[-1])
    stats["phase_s"] = time.perf_counter() - t0
    stats["card"] = card_line()
    log(f"draw: {json.dumps(stats)}")
    return stats


def _example_runs(device: str) -> list:
    cpu = ["--device", "cpu"]
    card = ["--device", device]
    return [(name, []) for name in HOST_EXAMPLES] + [
        ("multi_tenant_serving", card),
        ("multi_tenant_serving", cpu),
        ("multi_tenant_serving", card + ["--full"]),
        ("partitioned_training", card),
        ("quickstart", card),
    ]


def _finite_and_falling(losses: list, what: str) -> None:
    check(all(math.isfinite(x) for x in losses), f"{what}: losses {losses}")
    check(losses[-1] < losses[0], f"{what}: losses do not fall {losses}")


def examples_child(device: str = "cuda") -> int:
    """The examples phase, in a process of its own: each program of
    ``examples_torch/`` run through its ``main(argv)`` (``_example_runs``),
    its text kept, timed, its partitioned-GEMM launches counted from zero
    and the card's peak read; the checks of the phase on what each
    returns.  The host examples run first, before this process holds any
    CUDA state, since ``overload_serving`` forks pods.  Prints one JSON
    line."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    import repro_torch.kernels as K

    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    out_dir = root / EXAMPLES_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    os.chdir(out_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, texts, got = [], {}, {}
    for name, argv in _example_runs(device):
        main = importlib.import_module(f"examples_torch.{name}").main
        on_card = torch.cuda.is_initialized()
        if on_card:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            data = main(argv)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = K.launch_counts()
        key = " ".join([name, *argv])
        check(isinstance(data, dict) and data, f"examples: {key} returned {data!r}")
        texts[key], got[key] = text.getvalue(), data
        rows.append(
            {
                "example": key,
                "s": seconds,
                "launches": launches,
                "peak_gb": (
                    torch.cuda.max_memory_allocated() / 1e9
                    if torch.cuda.is_initialized()
                    else 0.0
                ),
                "lines": len(texts[key].splitlines()),
            }
        )
        if name == "quickstart":
            check(sum(launches.values()) >= 1, f"examples: {key} launched {launches}")
        else:
            check(sum(launches.values()) == 0, f"examples: {key} launched {launches}")
        if name in HOST_EXAMPLES:
            check(not torch.cuda.is_initialized(), f"examples: {key} used the card")
        print(f"examples: {json.dumps(rows[-1])}", file=sys.stderr, flush=True)

    card, cpu = (f"multi_tenant_serving --device {d}" for d in (device, "cpu"))
    check(texts[card] == texts[cpu], "examples: multi_tenant_serving card != CPU text")
    full = got[f"{card} --full"]
    check(full["drained"], "examples: --full did not drain")
    check(all(n > 0 for n in full["tokens"].values()), f"examples: {full['tokens']}")
    train = got[f"partitioned_training --device {device}"]
    check(train["restored_step"] == 20, f"examples: restored {train['restored_step']}")
    for tenant, losses in train["losses"].items():
        _finite_and_falling(losses, f"examples: partitioned_training {tenant}")
    quick = got[f"quickstart --device {device}"]
    _finite_and_falling(quick["train"]["losses"], "examples: quickstart")
    gemm = quick["gemm"]
    errs = []
    for i, (x, w, o) in enumerate(zip(gemm["xs"], gemm["ws"], gemm["outs"])):
        want = K.matmul_ref(x, w)
        errs.append(float((o - want).abs().max()))
        near = torch.allclose(o, want, rtol=EXAMPLE_TOL, atol=EXAMPLE_TOL)
        check(near, f"examples: quickstart tenant {i} max err {errs[-1]}")
    peak = {r["example"]: r["peak_gb"] for r in rows}
    rate = {k: n / full["decode_s"] for k, n in full["tokens"].items()}
    losses = {f"partitioned_training {k}": v for k, v in train["losses"].items()}
    losses["quickstart"] = quick["train"]["losses"]
    out = {
        "runs": rows,
        "full": {
            "rounds": full["rounds"],
            "decode_s": full["decode_s"],
            "tokens": full["tokens"],
            "tokens_per_s": rate,
            "peak_gb": peak[f"{card} --full"],
        },
        "quickstart_gemm": {
            "shapes": [[*x.shape, w.shape[1]] for x, w in zip(gemm["xs"], gemm["ws"])],
            "max_abs_err_vs_plain": errs,
            "max_err_vs_matmul": gemm["max_err"],
        },
        "first_last_loss": {k: [v[0], v[-1]] for k, v in losses.items()},
    }
    print(json.dumps(out), flush=True)
    return 0


def examples_phase(torch) -> dict:
    """The examples phase (``examples_child``) in a fresh interpreter, in a
    session of its own, within ``EXAMPLES_TIMEOUT_S`` (the child and the
    pods it forks are killed there): its numbers, or its failure."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), EXAMPLES_FLAG],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=EXAMPLES_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
        raise AssertionError(f"examples over {EXAMPLES_TIMEOUT_S} s:\n{err[-4000:]}")
    for line in err.splitlines():
        if line.startswith("examples: "):
            log(line)
    check(proc.returncode == 0, f"the examples phase failed:\n{err[-4000:]}")
    stats = json.loads(out.strip().splitlines()[-1])
    stats["phase_s"] = time.perf_counter() - t0
    stats["card"] = card_line()
    log(f"examples: {json.dumps(stats)}")
    return stats


def tenancy_across(torch, mesh, one: dict) -> dict:
    """On several cards (``--placement-only``): ``TenantMeshManager(mesh,
    "model", policy="equal")`` gives llama3.2-3b and mamba2-780m a column
    slice each (width 2 at (1, 4)); every rank builds both sub-meshes, in
    one order, and trains its own tenant at full width (the two jobs
    side by side, ``TRAIN_STEPS`` steps; llama's losses within
    ``BF16_TOL`` of rank 0's card alone); no collective's group holds a
    rank outside its tenant's slice.  Then each saves its state, mamba is
    released, llama grows over the freed columns, and its checkpoint is
    restored onto the wider sub-mesh and steps once more (within
    ``BF16_TOL`` of the card alone's next step).  Returns every rank's
    numbers."""
    import shutil

    import torch.distributed as dist

    from repro_torch.configs import get
    from repro_torch.distributed.sharding import params_shardings
    from repro_torch.distributed.tenancy import TenantMeshManager
    from repro_torch.models.model import init_params
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import opt_shardings

    mgr = TenantMeshManager(mesh, "model", policy="equal")
    for name, _, demand, _ in TENANTS:
        mgr.admit(name, demand=demand)
    grants = {k: str(v) for k, v in mgr.rebalance().items()}
    check(len(grants) == 2, f"tenancy: grants {grants}")
    subs = {name: mgr.submesh(name) for name, *_ in TENANTS}  # every rank, one order
    (name, arch, _, seed), = [
        t for t in TENANTS if subs[t[0]].device_mesh.get_coordinate() is not None
    ]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    job = _tenant_job(torch, arch, subs[name], seed, TRAIN_BATCH)
    profiled = {}
    for i in range(TRAIN_STEPS):
        profiled.update(_step_job(torch, job, i, profiled=i == TRAIN_STEPS - 1))
    mine = _tenant_stats(job)
    own = set(mine["ranks"])
    check(all(set(g) <= own for g in job["groups"]), f"tenancy: groups {mine}")
    mine.update(
        tenant=name,
        grants=grants,
        profiled_step=profiled,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
    )
    if name == "llama":
        errs = [abs(a - b) / abs(b) for a, b in zip(job["losses"], one["losses"])]
        mine["max_rel_loss_err"] = max(errs)
        check(max(errs) <= BF16_TOL, f"tenancy: llama {job['losses']} vs {one}")
    t0 = time.perf_counter()
    state = {"params": job["params"], "opt": job["opt"]}
    ckpt.save(f"{TENANCY_CKPT_DIR}/{name}", TRAIN_STEPS, state)
    mine["save_s"] = time.perf_counter() - t0
    del job, state
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()  # both checkpoints are written before any rank reads one

    mgr.release("mamba")
    mine["grown"] = {k: str(v) for k, v in mgr.grow_into_free().items()}
    wide = mgr.submesh("llama")  # the width-2 sub-meshes' groups are freed
    cfg = get(TRAIN_ARCH).model
    shapes = init_params(cfg, device="meta")
    t0 = time.perf_counter()
    state = ckpt.restore(
        f"{TENANCY_CKPT_DIR}/llama",
        TRAIN_STEPS,
        {"params": shapes, "opt": init_opt_state(shapes)},
        {"params": params_shardings(shapes, wide), "opt": opt_shardings(shapes, wide)},
    )
    torch.cuda.synchronize()
    mine["restore_s"] = time.perf_counter() - t0
    wide_job = _tenant_job(torch, TRAIN_ARCH, wide, SEED, TRAIN_BATCH, state)
    _step_job(torch, wide_job, TRAIN_STEPS)
    loss = wide_job["losses"][-1]
    mine["resumed"] = {
        "ranks": wide.device_mesh.mesh.flatten().tolist(),
        "loss": loss,
        "one_card_loss": one["next_loss"],
        "step_ms": wide_job["ms"][-1],
        "groups": sorted(wide_job["groups"]),
    }
    err = abs(loss - one["next_loss"]) / abs(one["next_loss"])
    check(err <= BF16_TOL, f"tenancy: {mine['resumed']}")
    del state, wide_job
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(TENANCY_CKPT_DIR)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    return {"ranks": everyone}


def one_card_train(torch) -> dict:
    """llama3.2-3b at full width on this card alone, as the train phase
    trains it (the same seed, batches and steps): the losses, the median
    host ms of steps 2 to 5, the peak memory."""
    from repro_torch.configs import get
    from repro_torch.launch.mesh import _mesh
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import (
        TrainConfig,
        init_sharded,
        make_train_step,
    )

    cfg = get(TRAIN_ARCH).model
    card = _mesh((1, 1), ("data", "model"), "cuda")  # this card, no group
    torch.cuda.reset_peak_memory_stats()
    params, opt_state = init_sharded(cfg, card, seed=SEED)
    step, _ = make_train_step(cfg, card, TrainConfig(opt=OptConfig(**TRAIN_OPT)))
    dcfg = DataConfig(vocab=cfg.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=SEED)
    losses, ms = [], []
    for i in range(TRAIN_STEPS):
        batch = make_batch(dcfg, i, card)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    stats = {
        "losses": losses,
        "step_ms_median": statistics.median(ms[1:-1]),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "device_ms": None,
    }
    # one step more, for the tenant restored onto a wider slice
    batch = make_batch(dcfg, TRAIN_STEPS, card)
    params, opt_state, m = step(params, opt_state, batch)
    stats["next_loss"] = float(m["loss"])
    del params, opt_state, m, batch
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def placement_only(argv: list) -> int:
    """``--placement-only --mesh DATA,MODEL`` under ``python -m
    torch.distributed.run --nproc-per-node N``, one card a rank: the
    placement phase's llama3.2-3b sharded train step and sharded decode
    on that mesh, held against llama3.2-3b trained on rank 0's card alone
    first (its losses within ``BF16_TOL``) and against the one-device
    ``decode_step``; then, where "model" is 4 wide or more,
    ``MOE_WHOLE`` and ``DRAW_BIG`` served whole (``served_whole``);
    where it is 2 wide or more, the tenants side by side
    (``tenancy_across``).  Rank 0 prints the
    numbers and the card line.  No partitioned-GEMM kernel is launched."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    if argv[:1] != ["--mesh"] or len(argv) != 2:
        print(f"usage: {PLACEMENT_ONLY_FLAG} --mesh DATA,MODEL", file=sys.stderr)
        return 2
    data, model = (int(x) for x in argv[1].split(","))
    import repro_torch.kernels as K
    from repro_torch.launch.mesh import init_distributed, make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed("cuda")
    try:
        check(dist.get_world_size() == data * model, f"{data}x{model} mesh")
        mesh = make_host_mesh(model=model, data=data, device="cuda")
        rank = dist.get_rank()
        K.reset_launch_counts()
        one = [one_card_train(torch) if rank == 0 else None]
        dist.broadcast_object_list(one, src=0)
        t0 = time.perf_counter()
        stats = {"mesh": mesh.axis_sizes, "one_card": one[0]}
        stats["placement"] = placement_train(torch, mesh, one[0])
        if model >= 2:
            stats["tenancy"] = tenancy_across(torch, mesh, one[0])
        if model >= 4:
            stats["moe_whole"] = served_whole(torch, mesh, MOE_WHOLE)
            stats["big_whole"] = served_whole(torch, mesh, DRAW_BIG)
        stats["phase_s"] = time.perf_counter() - t0
        launches = K.launch_counts()
        check(sum(launches.values()) == 0, f"placement launched: {launches}")
        dist.barrier()
        if rank == 0:
            card = card_line()
            log(f"placement-only: {json.dumps(stats)}; {launches}")
            print(card)
            print(json.dumps({"ok": True, "placement_only": stats["mesh"]}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


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
        out["instructions"] = {
            path: {
                "off": _pass_instructions(pkg, None, keep),
                "on": _pass_instructions(pkg, obs_mod.Observability, keep),
            }
            for path, keep in (("default", False), ("spans", True))
        }
    finally:
        gc.unfreeze()
    return out


def _pass_instructions(pkg: str, make_obs, keep_trace: bool) -> int:
    """Python bytecode instructions one timed pass of the traffic cells runs
    (``sys.monitoring``): a count that no host's speed moves."""
    mon = sys.monitoring
    tool = mon.PROFILER_ID
    count = [0]

    def tick(code, offset):
        count[0] += 1

    parts = traffic_parts(pkg, make_obs() if make_obs is not None else None, keep_trace)
    mon.use_tool_id(tool, "chip_smoke")
    mon.register_callback(tool, mon.events.INSTRUCTION, tick)
    mon.set_events(tool, mon.events.INSTRUCTION)
    try:
        for part in parts:
            _timed_part(part)
    finally:
        mon.set_events(tool, 0)
        mon.register_callback(tool, mon.events.INSTRUCTION, None)
        mon.free_tool_id(tool)
    return count[0]


def obs_pairs(n: int, pkg: str = "repro_torch") -> int:
    """``n`` off/armed pairs of :func:`_overhead_pair` on each gated path,
    after the same warm-up and frozen heap as :func:`obs_overhead`; prints
    one JSON line: each path's CPU seconds per sample, its floor ratio (the
    gate's) and its median pair ratio."""
    obs_mod = _mod(pkg, "obs")
    _traffic_pass(pkg, None, False)
    gc.collect()
    gc.freeze()
    out = {}
    try:
        for path, keep in (("default", False), ("spans", True)):
            samples = {"off": [], "on": []}
            for i in range(n):
                cpu = _overhead_pair(pkg, obs_mod.Observability, keep, on_first=i % 2 == 1)
                for side, seconds in cpu.items():
                    samples[side].append(seconds)
            out[path] = {
                **samples,
                "ratio": _floor_ratio(samples),
                "median_ratio": statistics.median(
                    b / a for a, b in zip(samples["off"], samples["on"])
                ),
            }
    finally:
        gc.unfreeze()
    print(json.dumps(out), flush=True)
    return 0


def obs_split_main() -> int:
    split = obs_split()
    for path in ("default", "spans"):
        for part, row in split[path].items():
            log(f"obs split {path} {part}: {json.dumps(row)}")
    for side in ("on", "off"):
        log(f"obs split profile {side}: {json.dumps(split[f'profile_{side}'])}")
    for path, n in split["instructions"].items():
        log(f"obs split instructions {path}: {json.dumps(n)}, {n['on'] / n['off']!r}")
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
    if sys.argv[1:2] == [OBS_PAIRS_FLAG] and len(sys.argv) == 3:
        return obs_pairs(int(sys.argv[2]))
    if sys.argv[1:2] == [PLACEMENT_ONLY_FLAG]:
        return placement_only(sys.argv[2:])
    if sys.argv[1:] == [DRAW_FLAG]:
        return draw_child()
    if sys.argv[1:] == [EXAMPLES_FLAG]:
        return examples_child()
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
    if sys.argv[1:] != [KERNELS_FLAG]:
        serving_phase(torch)
        families_phase(torch, K)
        dense_phase(torch, K)
        train = train_phase(torch, K)
        placement_phase(torch, K, train)
        draw_check(torch)
        examples_phase(torch)
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
