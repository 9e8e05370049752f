"""GLM-4.7-Flash prefill rounds: the model's prefill of a batch of prompts,
round after round, closed loop.

The loop is ``prefill_rounds``' (its round seeds, call log, interleaved
lanes and trace matching, imported from it): a round is one forward
(``repro_torch.models.glm4_moe_lite.prefill_steps``) of the mix's
``prompts`` prompts of ``prompt_tokens`` tokens through every layer, ending
in each prompt's last-position logits; every projection is a call of the
program (``fused_tenant_gemm`` by default).  Weights are drawn once at
set-up from the seed, on the device; each round's token ids afresh on the
device from ``(seed, round)``, uniform over the vocabulary, so every round
routes anew.  ``rounds_in_flight`` rounds run interleaved at the MoE
layers' count reads.  The window, the checked round and the traced span
are as there; the check is the configuration's reference's
(``worst_gap``, teacher-forced).

A traced run also matches every kernel the host launched inside the
``cardbench.round`` span to the program's span around its launch, by
correlation id: the MLA blocks' projections and core
(``repro_torch.mla.{proj,core}``), the shared expert
(``repro_torch.moe.shared``) and the expert layer's phases after its count
read (:data:`SPANS`); the MLA blocks
whose core began in the span give the blocks' bound
(``glm_roofline.mla_bound_s``), their kernels the device time that
``mla_roofline`` reads.  ``spans.tsv`` beside the chrome trace gives each
span's kernels and device ms a round, ``calls.tsv`` each program call's.
"""

from __future__ import annotations

import bisect
import json
import random
import time
from pathlib import Path

import torch

from cardbench import glm_roofline, harness, lfm2_roofline, roofline
from cardbench import trace as tracing

# the program's spans whose kernels the traced run sums: none of them nests
# in another or stays open across a lane's pause (the expert layer's route
# phase does both, so its kernels but the shared expert's count as other)
SPANS = (
    "repro_torch.mla.proj",
    "repro_torch.mla.core",
    "repro_torch.moe.shared",
    "repro_torch.moe.dispatch",
    "repro_torch.moe.experts",
    "repro_torch.moe.combine",
)
MLA_SPANS = ("repro_torch.mla.proj", "repro_torch.mla.core")


def _loop():
    """``prefill_rounds``, the driver beside this one."""
    root = Path(__file__).resolve().parents[1]
    return harness.module("drivers", "prefill_rounds", root)


def call_plan(model) -> list[tuple[int, str]]:
    """The program's calls a round in launch order: ``(layer, part)``; layer
    -1 is the output head."""
    plan = []
    for i in range(model.num_hidden_layers):
        plan += [(i, "q_a_kv_a"), (i, "q_b_kv_b"), (i, "o_proj")]
        if model.is_moe(i):
            plan.append((i, "router"))
            if model.shared_width:
                plan += [(i, "shared_gate_up"), (i, "shared_down")]
            plan += [(i, "gate_up"), (i, "down")]
        else:
            plan += [(i, "w1_w3"), (i, "w2")]
    return plan + [(-1, "head")]


def run(
    cfg, mix, reference, *, seed, seconds, trace, device, t_start, program, out_dir
):
    """One run of a cell: set-up, the window, the check.  Returns the run's
    record, which the metric readers read."""
    from repro_torch.kernels import _build, launch_counts, set_tracing
    from repro_torch.models import glm4_moe_lite
    from repro_torch.models.routed_experts import moe_stats, reset_moe_stats

    pr = _loop()
    model = glm4_moe_lite.Glm4MoeLiteConfig.from_config(cfg)
    B, S = mix["prompts"], mix["prompt_tokens"]
    params = glm4_moe_lite.init_params(model, seed=seed, device=device)
    log = pr._CallLog()
    calls = [0]

    def counted(xs, ws, **kw):
        calls[0] += 1
        return program(xs, ws, **kw)

    def steps(r, keep, gemm=program):
        gen = torch.Generator(device=device)
        gen.manual_seed(pr.round_seed(seed, r))
        ids = torch.randint(0, model.vocab_size, (B, S), generator=gen, device=device)
        logits = yield from glm4_moe_lite.prefill_steps(
            params, model, ids, gemm=log.wrap(gemm), keep=keep
        )
        if keep is not None:
            keep["logits"] = logits

    # a warm round fills the launch-table caches, keeps what the checked
    # round will (held until that round starts) and counts the calls
    held: dict = {}
    for _ in steps(-1, held, gemm=counted):
        pass
    pr._sync(device)
    build_s = _build.last_build_seconds

    check_at = random.Random(seed).randrange(pr.CHECK_ROUNDS)
    kept: dict = {}
    launches0 = launch_counts()
    loop = pr._Interleaved(steps, mix["rounds_in_flight"], device, check_at, kept, held)
    t0, t1, window = loop.run(seconds, check_at)
    setup_s = t0 - t_start
    launches = {k: v - launches0[k] for k, v in launch_counts().items()}

    traced = armed = None
    if trace:
        was = set_tracing(True)
        try:
            with tracing.profiler() as prof:
                with pr._span("warmup", True):
                    loop.from_round(loop.next)
                reset_moe_stats()
                log.on = True
                with pr._span("round", True):
                    loop.more(pr.TRACE_ROUNDS)
                log.on = False
                pr._sync(device)
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
            pr, traced, model, cfg, B, S, armed, log.calls, out_dir / "trace.json",
            out_dir,
        )
    return record


def by_span(path) -> dict:
    """Every kernel in the chrome trace at ``path`` whose launch the host
    made inside the ``cardbench.round`` span, matched to its launch by
    correlation id and given to the one of :data:`SPANS` around the launch
    (``other`` where none is): ``{span: [kernels, seconds]}``, and under
    ``mla_blocks`` the ``repro_torch.mla.core`` spans that began in the
    round span.  Empty where the trace holds no launch of a kernel."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, launches, kernels, rounds = [], {}, [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        corr = (e.get("args") or {}).get("correlation")
        ts, dur = float(e["ts"]), float(e["dur"])
        name = e.get("name", "")
        if e.get("cat") == "kernel":
            kernels.append((corr, dur))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches[corr] = ts
        elif e.get("cat") == "user_annotation" and name in SPANS:
            spans.append((ts, ts + dur, name))
        elif e.get("cat") == "user_annotation" and name == "cardbench.round":
            rounds.append((ts, ts + dur))
    if not rounds or not any(c in launches for c, _ in kernels):
        return {}
    a, b = rounds[0]
    spans.sort()
    starts = [s for s, _, _ in spans]
    out: dict = {name: [0, 0.0] for name in (*SPANS, "other")}
    for corr, dur in kernels:
        t = launches.get(corr)
        if t is None or not a <= t <= b:
            continue
        i = bisect.bisect_right(starts, t) - 1
        name = spans[i][2] if i >= 0 and t <= spans[i][1] else "other"
        out[name][0] += 1
        out[name][1] += 1e-6 * dur
    out["mla_blocks"] = sum(
        1 for s, _, n in spans if n == "repro_torch.mla.core" and a <= s <= b
    )
    return out


def _traced(pr, traced, model, cfg, B, S, armed, calls, path, out_dir):
    """The profiled rounds: their FLOPs, the MLA blocks' bound and kernels,
    the expert calls' bound, the per-call table (``prefill_rounds``' rule)
    and the per-span table written beside the chrome trace."""
    plan = call_plan(model)
    routed = (armed or {}).get("routed", [])
    kernels = [e for e in traced["device"] if any(k in e[0] for k in pr.KERNELS)]
    launched = pr._launched(path)
    matched = launched is not None and len(launched[0]) == len(calls)
    bounds: list = [[] for _ in plan]
    times: list = [[] for _ in plan]
    for i, (c, shapes) in enumerate(calls):
        bounds[c].append(roofline.call_bound_s(shapes, cfg["dtype"]))
        if matched:
            times[c].append(launched[0][i])
    lines = ["call\tlayer\tpart\tcalls\tbound_ms\tkernel_ms"]
    for c, (layer, part) in enumerate(plan):
        bound = f"{1e3 * sum(bounds[c]) / len(bounds[c]):.6f}" if bounds[c] else "-"
        kernel = "not measured"
        if times[c]:
            kernel = f"{1e3 * sum(times[c]) / len(times[c]):.6f}"
        lines.append(f"{c}\t{layer}\t{part}\t{len(bounds[c])}\t{bound}\t{kernel}")
    table = out_dir / "calls.tsv"
    table.write_text("\n".join(lines) + "\n")
    spans = by_span(path)
    rows = ["span\tkernels\tdevice_ms_a_round"]
    for name in (*SPANS, "other"):
        if name in spans:
            n, s = spans[name]
            rows.append(f"{name}\t{n}\t{1e3 * s / pr.TRACE_ROUNDS:.6f}")
    (out_dir / "spans.tsv").write_text("\n".join(rows) + "\n")
    blocks = spans.get("mla_blocks", 0)
    d, f = model.hidden_size, model.moe_intermediate_size
    return {
        "window_s": traced["window_s"],
        "busy_s": traced["busy_s"],
        "rounds": pr.TRACE_ROUNDS,
        "flops": pr.TRACE_ROUNDS * glm_roofline.round_flops(cfg, B, S)["total"],
        "mla_blocks": blocks,
        "mla_bound_s": blocks * glm_roofline.mla_bound_s(cfg, B, S),
        "mla_kernel_s": sum(spans[n][1] for n in MLA_SPANS) if spans else None,
        "shared_kernel_s": spans["repro_torch.moe.shared"][1] if spans else None,
        "expert_bound_s": lfm2_roofline.experts_bound_s(routed, d, f, cfg["dtype"]),
        "expert_kernel_s": launched[1] if launched else None,
        "calls": len(calls),
        "kernels": len(kernels),
        "device_ops": traced["device_ops"],
        "idle_gaps": traced["idle_gaps"],
        "table": str(table),
    }
