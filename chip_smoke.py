"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on a failed
check:

1. Environment: the card (``nvidia-smi`` name and power limit), torch, CUDA,
   ``nvcc``; TF32 is switched off; the CUDA kernels are built from the
   checkout's sources.
2. Kernels: ``fused_tenant_gemm`` — the port's main kernel path — runs the
   three ``benchmarks/kernel_bench.py`` mixes (block 128) and two full-width
   rounds of the paper's heavy workload (layer 0 of each of the 8 tenants,
   and each tenant's largest GEMM, partition blocks autotuned), in float32
   and bfloat16, in dense and in compact mode.  The launch counters are
   zeroed just before that run and read just after it.  Then each kernel is
   held against its plain version on the card: max relative error < 1e-4 on
   random operands, bit-exact dense == compact == plain on integer-valued
   operands, and the compact run list covers exactly the live tiles.  The
   full-width rounds are timed with CUDA events, kernel and plain version in
   turns, beside ``sequential_tenant_gemm`` (one ``torch.matmul`` per tenant)
   as the library yardstick.
3. Serving: a ``MultiTenantEngine`` over the card as one column serves two
   full-width, full-depth llama3.2-3b tenants (random bf16 weights from a
   seeded generator on the card), 3 requests each, to completion; the
   decode step is also checked against the CPU on the smoke config.

The last lines are the kernels' JSON record, the card line, and
``{"ok": true, "device": {...}}``.  Without CUDA the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
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
TIMING_TURNS = 5  # turns of (plain, dense, compact, library) and back
CALLS_PER_SAMPLE = 3
FULL_WIDTH = ("heavy_l0", "heavy_max")
DTYPES = ("float32", "bfloat16")
MODES = ("dense", "compact")
KERNEL_FILE = "src/repro_torch/kernels/csrc/partitioned_matmul.cu"
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
    return {
        "uniform": ([(256, 256, 256)] * 4, 128),
        "ragged": (capped[:4], 128),
        "ragged_heavy": (capped, 128),
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


def bound(shapes, dtype: str, T: int, N: int) -> tuple[float, str]:
    """Least time (ms) the card needs for the fused call: the live operand
    bytes read once and the (T, N) f32 output written once over the memory
    rate, or the live FLOPs over the dtype's peak, whichever is larger."""
    item = 4 if dtype == "float32" else 2
    nbytes = sum((t * k + k * n) * item for t, k, n in shapes) + T * N * 4
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


def kernel_phase(torch, K) -> list[dict]:
    from repro_torch.kernels import _build
    from repro_torch.kernels.partitioned_matmul import _live_extents
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

    # -- each kernel against its plain version ------------------------------
    tile_rows, tile_cols, _, smem = _build.geometry()
    log(f"CTA tile {tile_rows}x{tile_cols}, {smem} B shared memory")
    errs = {m: {"abs": 0.0, "rel": 0.0} for m in MODES}
    rounds = {m: [] for m in MODES}
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
            outs, stats = results[mix, dt, mode]
            col = 0
            for (t, _, n), out in zip(shapes, outs):
                ref = plain[:t, col : col + n]
                abs_err = (out - ref).abs().max().item()
                rel_err = abs_err / (ref.abs().max().item() + 1e-9)
                check(rel_err < MAX_REL_ERR, f"{mix} {dt} {mode}: rel err {rel_err}")
                errs[mode]["abs"] = max(errs[mode]["abs"], abs_err)
                errs[mode]["rel"] = max(errs[mode]["rel"], rel_err)
                col += -(-n // bn) * bn
            if mode == "compact":
                tile = (tile_rows, tile_cols)
                check_run_list(K, _live_extents, stats, padded, kw, tile)
        del plain

        ixs, iws = operands(torch, shapes, dt, seed=1000, integer=True)
        ipad = K.pad_operands(ixs, iws, **kw)
        dense = K.partitioned_matmul(*ipad, grid_mode="dense", **kw)
        compact = K.partitioned_matmul(*ipad, grid_mode="compact", **kw)
        iplain = K.partitioned_matmul_ref(ipad[0], ipad[1], owner_d, vt_d, bn)
        check(torch.equal(dense, compact), f"{mix} {dt}: dense != compact")
        check(torch.equal(dense, iplain), f"{mix} {dt}: kernel != plain")
        del dense, compact, iplain

        if mix in FULL_WIDTH:
            ms = time_in_turns(
                torch,
                {
                    "plain": lambda: K.partitioned_matmul_ref(
                        xs_pad, w_pad, owner_d, vt_d, bn
                    ),
                    "dense": lambda: K.partitioned_matmul(*padded, **kw),
                    "compact": lambda: K.partitioned_matmul(
                        *padded, grid_mode="compact", **kw
                    ),
                    "library": lambda: K.sequential_tenant_gemm(xs, ws),
                },
            )
            bound_ms, bound_by = bound(shapes, dt, T, N)
            for mode in MODES:
                _, dev_ms, top = device_profile(
                    torch,
                    lambda: K.partitioned_matmul(*padded, grid_mode=mode, **kw),
                    CALLS_PER_SAMPLE,
                )
                kernel_ms = sum(t for name, t in top if f"{mode}_kernel" in name)
                rounds[mode].append(
                    {
                        "round": f"{mix}/{dt}",
                        "blocks": [bt, bk, bn],
                        "ms": ms[mode],
                        "kernel_ms": kernel_ms,
                        "device_ms": dev_ms,
                        "plain_ms": ms["plain"],
                        "bound_ms": bound_ms,
                        "bound_by": bound_by,
                        "library_ms": ms["library"],
                    }
                )
            log(f"{mix} {dt} blocks {(bt, bk, bn)}: {ms}, bound {bound_ms} ms")
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
            }
        )
    return record


def check_run_list(K, live_extents, stats, padded, kw, tile) -> None:
    """The compact launch list holds exactly the live (n, t) tiles that
    ``grid_accounting`` counts: disjoint CTA tiles whose live area equals
    the accounting's drained live tiles."""
    xs_pad, _, owner, vt, vk = padded
    T, Kd = xs_pad.shape[1], xs_pad.shape[2]
    bt, bk, bn = kw["block_t"], kw["block_k"], kw["block_n"]
    tile_rows, tile_cols = tile
    tl, kl = live_extents(owner, vt, vk, T=T, K=Kd, block_t=bt, block_k=bk)
    runs = K.compact_run_list(
        tl,
        kl,
        block_t=bt,
        block_k=bk,
        block_n=bn,
        tile_rows=tile_rows,
        tile_cols=tile_cols,
    )
    sub = -(-bn // tile_cols)
    nb, j = np.divmod(runs[:, 0].astype(np.int64), sub)
    cols = np.minimum(tile_cols, bn - j * tile_cols)
    rows = np.minimum(tile_rows, runs[:, 3].astype(np.int64) - runs[:, 1] * tile_rows)
    check((rows > 0).all(), "run list holds a tile with no live row")
    check(len({(a, b) for a, b in runs[:, :2].tolist()}) == len(runs), "tile twice")
    live_elems = stats.accounting.out_bytes_written // 4
    check(int((rows * cols).sum()) == live_elems, "run list != live tiles")
    check(np.array_equal(runs[:, 2], kl[nb] * bk), "run list depth != live depth")


# ---------------------------------------------------------------------------
# 3. serving
# ---------------------------------------------------------------------------


def serving_phase(torch) -> dict:
    from repro_torch.configs import get
    from repro_torch.distributed.tenancy import TenantMeshManager, device_grid
    from repro_torch.models.model import decode_step, init_cache, init_params
    from repro_torch.serving.engine import MultiTenantEngine
    from repro_torch.serving.kv_cache import DecodeSession

    spec = get("llama3.2-3b")

    # the decode step on the card against the same step on the CPU
    smoke = spec.smoke
    cpu_params = init_params(smoke, 0, device="cpu")
    gpu_params = _tree_to(cpu_params, "cuda")
    caches = init_cache(smoke, 3, 16, device="cpu"), init_cache(smoke, 3, 16)
    rng = np.random.default_rng(1)
    lens = np.array([0, 2, 5])
    for _ in range(4):
        tok = torch.from_numpy(rng.integers(0, smoke.vocab, (3, 1)))
        ref, _ = decode_step(smoke, cpu_params, caches[0], tok, torch.from_numpy(lens))
        out, _ = decode_step(
            smoke, gpu_params, caches[1], tok.cuda(), torch.from_numpy(lens).cuda()
        )
        close = torch.allclose(
            out.float().cpu(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL
        )
        check(close, "decode_step on the card disagrees with the CPU")
        lens = lens + 1
    log("serving: smoke decode_step on the card matches the CPU")

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


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch.kernels as K
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    card = environment(torch, _build)
    kernels = kernel_phase(torch, K)
    serving_phase(torch)
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
