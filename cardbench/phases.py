"""Where the program's launch path spends its host time, and what tracing costs.

    python3 cardbench/phases.py --workload heavy-b128 --seed 7 --blocks 6 \\
        --rounds 20 --out build/phases-heavy.json
    python3 cardbench/phases.py --workload heavy-b128 --seed 7 --timeit 2000 \\
        --out build/timeit-heavy.json

In one process, for one cell at its own size and load (the driver's
operands and closed loop, ``rounds_in_flight`` rounds queued), after two
warm rounds:

* ``--blocks`` pairs of ``--rounds`` rounds, tracing off then armed
  (``repro_torch.kernels.set_tracing``): each block's host enqueue time a
  call, as ``enqueue_us`` reads it, and, armed, the four phase means over
  the same calls from the program's store (``launch_stats``);
* one profiled round off and one armed, each with its enqueue time a call;
  the armed round's chrome trace is checked: every ``cardbench.wave<w>``
  span holds one span of each phase, in order, and the kernels lie on the
  same clock.

Then one more block off and one armed whose host time a call is split into
the release of the previous wave's outputs (which ``enqueue_us`` times too)
and the call, and, armed, the call's time outside its four phases.

With ``--timeit N`` it only times the off path: N calls a sample, 50
samples, of every wave of the round cut to one row and at most 64 x 64 a
tenant (the host's work is the same, the kernels too short to hold the
host back); with
``--against ROOT`` another checkout's program (one without tracing too)
is imported beside this one's and the two are timed in turns in one
process, so the two trees are compared on one host at once, each with its
kernel launch stood in for after the warm calls.
The benchmark's own runs never run this.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "src"), str(REPO)]

from cardbench import harness  # noqa: E402
from cardbench import trace as tracing  # noqa: E402

GEMM_SPAN = "repro_torch.gemm."
KERNELS = ("dense_kernel", "compact_kernel")
PHASES = ("prepare", "alloc", "table", "launch")
TIMEIT_SAMPLES = 50


def _setup(cell, seed, device):
    import torch

    from repro_torch.kernels import fused_tenant_gemm

    driver = harness.module("drivers", "gemm_rounds")
    cfg = harness.config(cell["config"])
    mx = harness.mix(cell["traffic"])
    plan = driver.waves(cfg, mx["batch"])
    xs, (ws,) = driver.draw(plan, 1, getattr(torch, cfg["dtype"]), device, seed)
    return driver, plan, xs, ws, mx["rounds_in_flight"], fused_tenant_gemm


class _NoLaunch:
    """Stands in for a built kernel library: the launch returns at once."""

    @staticmethod
    def pm_launch(*args):
        return 0


def _program_and_build(root=None):
    """``fused_tenant_gemm`` and the ``_build`` module of this checkout's
    ``repro_torch`` or, with ``root``, of another checkout's, imported beside
    this one's (whose modules are set aside while it imports)."""
    if root is None:
        from repro_torch.kernels import fused_tenant_gemm

        return fused_tenant_gemm, sys.modules["repro_torch.kernels._build"]

    def ours():
        return {k: sys.modules.pop(k) for k in list(sys.modules)
                if k.split(".")[0] == "repro_torch"}

    mine = ours()
    sys.path.insert(0, str(root / "src"))
    try:
        from repro_torch.kernels import fused_tenant_gemm

        build = sys.modules["repro_torch.kernels._build"]
    finally:
        sys.path.remove(str(root / "src"))
        ours()
        sys.modules.update(mine)
    return fused_tenant_gemm, build


def timeit(cell, seed, calls, device, against=None) -> dict:
    """The off path's host µs a call, wave by wave, cut to one CTA a tenant;
    with ``against`` (another checkout), its program and this one's in turns
    (other, this, this, other, ...) in this one process, on the same
    operands, each library's launch stood in for once the warm calls have
    launched (the same C call in both trees, and the noisiest part)."""
    import torch

    driver, plan, xs, ws, _, _ = _setup(cell, seed, device)
    programs = {"this": _program_and_build()}
    if against is not None:
        programs["other"] = _program_and_build(against)
    # one row and at most 64 x 64 a tenant: one CTA each, so the device
    # never holds the host back; the host's path is the same
    cut = [[x[:1, :64] for x in xw] for xw in xs]
    wcut = [[w[:64, :64] for w in ww] for ww in ws]
    for fn, build in programs.values():  # each cut geometry's autotune, table
        for w in range(len(plan)):
            fn(cut[w], wcut[w], grid_mode="auto")
        if against is not None:
            build.load = lambda: _NoLaunch
    torch.cuda.synchronize(device)
    order = ["other", "this", "this", "other"] if against is not None else ["this"]
    samples: dict = {k: [] for k in programs}
    for i in range(TIMEIT_SAMPLES * len(order)):
        fn = programs[order[i % len(order)]][0]
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        n = 0
        while n < calls:
            for w in range(len(plan)):
                fn(cut[w], wcut[w], grid_mode="auto")
            n += len(plan)
        samples[order[i % len(order)]].append(1e6 * (time.perf_counter() - t) / n)
    torch.cuda.synchronize(device)
    out = {"calls_a_sample": n}
    for k, v in samples.items():
        out[k] = {"us_a_call": v, "min_us": min(v), "median_us": statistics.median(v)}
    if against is not None:
        # each sample of this program against the other's beside it in turn
        a, b = samples["this"], samples["other"]
        diffs = [a[j] - b[j] for j in range(len(a))]
        out["this_minus_other_us"] = {
            "median": statistics.median(diffs),
            "quartiles": statistics.quantiles(diffs, n=4),
        }
    return out


def release_split(driver, program, xs, ws, device, depth, rounds, armed) -> dict:
    """The driver's load, tracing ``armed`` or not: host µs a call spent
    releasing the previous wave's outputs (inside the span ``enqueue_us``
    times, where the driver rebinds ``outs``) and in the call itself; armed,
    also the call's time outside its four phases (entry and return)."""
    from collections import deque

    import repro_torch.kernels as K

    inflight: deque = deque()
    outs, release, call, n = None, 0.0, 0.0, 0
    K.set_tracing(armed)
    before = K.launch_stats()
    for _ in range(rounds):
        for w, xw in enumerate(xs):
            t0 = time.perf_counter()
            outs = None
            t1 = time.perf_counter()
            outs = program(xw, ws[w], grid_mode="auto")
            t2 = time.perf_counter()
            release, call, n = release + t1 - t0, call + t2 - t1, n + 1
        inflight.append(driver._Done(device))
        if len(inflight) >= depth:
            inflight.popleft().wait()
    after = K.launch_stats()
    K.set_tracing(False)
    while inflight:
        inflight.popleft().wait()
    del outs
    out = {"release_us": 1e6 * release / n, "call_us": 1e6 * call / n}
    if armed:
        ns = sum(after["phase_ns"][p] - before["phase_ns"][p] for p in PHASES)
        out["outside_phases_us"] = out["call_us"] - ns / 1e3 / n
    return out


def _spans_by_wave(path: Path) -> dict:
    """Per ``cardbench.wave<w>`` span of the armed round, the program spans
    inside it in start order; the program's kernels, and whether each
    started after its launch span began (one clock)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = sorted(
        (e for e in events if e.get("cat") == "user_annotation"),
        key=lambda e: float(e["ts"]),
    )
    waves = [e for e in spans if e["name"].startswith("cardbench.wave")]
    gemm = [e for e in spans if e["name"].startswith(GEMM_SPAN)]
    out = {}
    for wv in waves:
        a, b = float(wv["ts"]), float(wv["ts"]) + float(wv["dur"])
        inside = [
            e["name"][len(GEMM_SPAN) :]
            for e in gemm
            if a <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= b
        ]
        out[wv["name"]] = inside
    # one kernel a wave, each started after its launch span began
    launches = [e for e in gemm if e["name"] == GEMM_SPAN + "launch"]
    kernels = sorted(
        (e for e in events if e.get("cat") == "kernel"
         and any(k in e.get("name", "") for k in KERNELS)),
        key=lambda e: float(e["ts"]),
    )
    same_clock = len(kernels) == len(launches) and all(
        float(k["ts"]) >= float(s["ts"]) for k, s in zip(kernels, launches)
    )
    return {"waves": out, "kernels": len(kernels), "kernels_after_launch": same_clock}


def _costs(n: int = 20000) -> dict:
    """Host µs, on this host, of a clock read, of one armed call's clock
    (its entry and four marks) with no profiler, and of a span entered and
    left while a profiler records (``n`` of each, the mean)."""
    import torch

    from repro_torch.kernels import tracing as program_tracing

    def mean_us(fn, count):
        t = time.perf_counter()
        for _ in range(count):
            fn()
        return 1e6 * (time.perf_counter() - t) / count

    def clock():
        c = program_tracing.Clock()
        for _ in PHASES:
            c.mark()

    def span():
        with torch.profiler.record_function(GEMM_SPAN + "probe"):
            pass

    out = {
        "clock_read_us": mean_us(time.perf_counter_ns, n),
        "armed_clock_us": mean_us(clock, n),
    }
    with tracing.profiler():
        out["span_profiling_us"] = mean_us(span, n // 10)
    return out


def phases(cell, seed, blocks, rounds, device, out_dir: Path) -> dict:
    import torch

    import repro_torch.kernels as K

    driver, plan, xs, ws, depth, program = _setup(cell, seed, device)
    for _ in range(2):
        warm = driver._Loop(program, xs, device, depth)
        warm.round(ws)
        warm.drain()
    torch.cuda.synchronize(device)

    def block(armed: bool) -> dict:
        K.set_tracing(armed)
        loop = driver._Loop(program, xs, device, depth)
        before = K.launch_stats()
        for _ in range(rounds):
            loop.round(ws)
        after = K.launch_stats()
        loop.drain()
        K.set_tracing(False)
        row = {"enqueue_us": 1e6 * loop.enqueue_s / loop.calls, "calls": loop.calls}
        if armed:
            for p in PHASES:
                n = after["phase_calls"][p] - before["phase_calls"][p]
                ns = after["phase_ns"][p] - before["phase_ns"][p]
                row[f"enqueue_{p}_us"] = ns / n / 1e3 if n else None
            row["table_builds"] = after["table_builds"] - before["table_builds"]
            row["ctas_a_round"] = (after["ctas"] - before["ctas"]) / rounds
            row["fill_ctas"] = after["fill_ctas"] - before["fill_ctas"]
        return row

    rows = []
    for _ in range(blocks):
        rows.append({"armed": False, **block(False)})
        rows.append({"armed": True, **block(True)})
    split_off = release_split(driver, program, xs, ws, device, depth, rounds, False)
    split_on = release_split(driver, program, xs, ws, device, depth, rounds, True)

    def profiled(armed: bool, name: str) -> dict:
        K.set_tracing(armed)
        with tracing.profiler() as prof:
            t = time.perf_counter()
            for w, xw in enumerate(xs):
                with torch.profiler.record_function(f"cardbench.wave{w}"):
                    program(xw, ws[w], grid_mode="auto")
            enqueue = time.perf_counter() - t
            torch.cuda.synchronize(device)
        K.set_tracing(False)
        path = out_dir / f"{name}.json"
        prof.export_chrome_trace(str(path))
        return {"enqueue_us": 1e6 * enqueue / len(xs), "trace": str(path)}

    # the profiler's first rounds pay its own start: each kind twice, the
    # second kept
    for _ in range(2):
        prof_off = profiled(False, "profiled-off")
        prof_on = profiled(True, "profiled-armed")
    nested = _spans_by_wave(Path(prof_on["trace"]))
    whole = all(v == list(PHASES) for v in nested["waves"].values())
    stats = K.launch_stats()
    summary = {
        "off_enqueue_us": statistics.median(r["enqueue_us"] for r in rows if not r["armed"]),
        "armed_enqueue_us": statistics.median(r["enqueue_us"] for r in rows if r["armed"]),
        **{
            f"enqueue_{p}_us": statistics.median(
                r[f"enqueue_{p}_us"] for r in rows if r["armed"]
            )
            for p in PHASES
        },
        "profiled_off_enqueue_us": prof_off["enqueue_us"],
        "profiled_armed_enqueue_us": prof_on["enqueue_us"],
        "every_wave_holds_the_four_phases": whole and len(nested["waves"]) == len(plan),
        "kernels_after_launch": nested["kernels_after_launch"],
        "tile_efficiency": 100 * stats["macs_useful"] / stats["macs_issued"],
        "ctas_a_round": rows[1]["ctas_a_round"],
        "fill_ctas": sum(r.get("fill_ctas", 0) for r in rows),
        "table_builds": sum(r.get("table_builds", 0) for r in rows),
    }
    summary["phase_sum_us"] = sum(summary[f"enqueue_{p}_us"] for p in PHASES)
    summary.update({f"off_{k}": v for k, v in split_off.items()})
    summary.update({f"armed_{k}": v for k, v in split_on.items()})
    summary.update(_costs())
    return {"summary": summary, "blocks": rows, "nesting": nested}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--timeit", type=int, default=0)
    ap.add_argument("--against", type=Path, default=None,
                    help="with --timeit: another checkout, timed in turns")
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import repro_torch.kernels as K

    cell = harness.cell(harness.benchmark(), args.workload)
    device = torch.device("cuda", 0)
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(0)}
    if args.timeit:
        out["timeit"] = timeit(cell, args.seed, args.timeit, device, args.against)
    elif not hasattr(K, "set_tracing"):
        print("the program has no set_tracing", file=sys.stderr)
        return 2
    else:
        out_dir = args.out.parent / f"{args.out.stem}-traces"
        out_dir.mkdir(parents=True, exist_ok=True)
        out.update(phases(cell, args.seed, args.blocks, args.rounds, device, out_dir))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k not in ("blocks", "nesting")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
