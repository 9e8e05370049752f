"""Export a Perfetto-loadable trace from a bursty heavy-mix serve run.

The cell is deliberately hostile: an MMPP burst process over the heavy
model pool at 4.4x the per-array service rate, deadline-driven preemption
armed, and an aggressive rebalance cadence — so the exported timeline
shows everything the tracer captures: per-tenant stage-in / compute /
stage-out slices on each array node's track, drain spans where a
preemption cut a segment short, and instant markers for every dispatch
choice, preemption and cross-node migration.

    PYTHONPATH=src python examples_torch/trace_viewer.py
    # then open trace_viewer.perfetto-trace.json at https://ui.perfetto.dev

Spans derive from the scheduler's ``keep_trace=True`` records; per-job
instants derive from the job records the run builds anyway — so the run
itself pays almost nothing for the trace.

The same program as ``examples/trace_viewer.py`` on ``repro_torch``: host
arithmetic, the same text, and the same two files written into the
working directory.  ``main`` returns what it printed.
"""

import argparse

from repro_torch.api import (
    RebalanceConfig,
    SchedulingConfig,
    ServeConfig,
    Session,
    resolve_backend,
)
from repro_torch.core.partition import Partition
from repro_torch.obs import Observability
from repro_torch.sim.workloads import MODEL_POOLS, MODELS

OUT = "trace_viewer.perfetto-trace.json"
CSV = "trace_viewer.timeline.csv"


def mean_service_s(pool):
    """Mean full-array sequential time of one job from ``pool`` — the
    load normaliser (arrival rate = per-array load / service time)."""
    b = resolve_backend("sim")
    time_fn, stage = b.time_fn(), b.stage_model()
    full = Partition(rows=b.array.rows, col_start=0, cols=b.array.cols)
    times = []
    for name in MODEL_POOLS[pool]:
        g = MODELS[name]()
        times.append(
            sum(
                stage.stage_in_s(ls) + time_fn(ls, full) + stage.stage_out_s(ls)
                for ls in g.layers
            )
        )
    return sum(times) / len(times)


def main(argv=None) -> dict:
    argparse.ArgumentParser(description="Perfetto trace export demo").parse_args(argv)
    svc = mean_service_s("heavy")
    rate = 4 * 1.1 / svc  # 1.1x load across 4 arrays

    cfg = ServeConfig(
        scheduling=SchedulingConfig(
            n_arrays=4,
            dispatch="jsq",
            max_concurrent=4,
            queue_cap=8,
            seed=0,
            preemption=True,
            keep_trace=True,
        ),
        rebalance=RebalanceConfig(interval=1e-3),
        obs=Observability(sample_every=1),
    )

    res = Session(policy="deadline_preempt", backend="sim").serve(
        "mmpp",
        config=cfg,
        rate=rate,
        horizon=240 / rate,
        pool="heavy",
        slo_s=3 * svc,
        burst_factor=6.0,
    )

    print(res.timeline.render(title="bursty heavy mix, 4 arrays"))

    blob = res.timeline.write_chrome_trace(OUT)
    kinds = res.timeline.tracer.counts_by_kind()
    print(
        f"\nwrote {OUT}: {len(blob['traceEvents'])} trace events "
        f"({kinds.get('preempt', 0)} preemptions, "
        f"{kinds.get('migrate', 0)} migrations) "
        f"-- open it at https://ui.perfetto.dev"
    )

    with open(CSV, "w") as f:
        f.write(res.timeline.timeline_csv())
    print(f"wrote {CSV} (per-node utilization/queue series)")
    return {"result": res, "trace_events": len(blob["traceEvents"]), "kinds": kinds}


if __name__ == "__main__":
    main()
