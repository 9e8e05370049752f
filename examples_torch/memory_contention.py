"""Memory contention: shared-bandwidth pressure and joint partitioning.

    PYTHONPATH=src python examples_torch/memory_contention.py [--capacity F]

A bursty (MMPP) heavy-model mix with one latency-critical tenant in
three overdrives a 4-array fleet whose shared DRAM/NoC bandwidth is
derated to ``--capacity`` of nominal (default 0.5).  Every stage-in /
stage-out books raw demand into fleet-wide accounting windows; windows
pushed past capacity stretch transfers superlinearly (MoCA-style row-
buffer/backpressure compounding), and the stretch is priced into both
latency and energy.

The same contended stream runs under:

* ``equal``       — compute-only partitioning, bandwidth-blind;
* ``moca``        — joint compute + memory partitioning: tier-first
  placement plus per-tenant bandwidth caps on batch tenants whenever a
  latency tier shares the array (tier 0 is never capped).

The run prints per-policy tier-0 p99 / deadline-miss rate, the fleet
bus-stall seconds, and the worst window overcommit — moca trades batch
bandwidth for tier-0 latency under pressure.  The serving setup is one
:class:`repro_torch.ServeConfig` value, reused across both arms.

The same program as ``examples/memory_contention.py`` on ``repro_torch``:
host arithmetic, the same text.  ``main`` returns what it printed.
"""

import argparse

from repro_torch import ServeConfig, Session
from repro_torch.api import MemoryConfig, SchedulingConfig
from repro_torch.core.scheduler import ContentionModel

N_ARRAYS = 4
RATE = 2700.0  # jobs/s over 4 arrays — ~1.2x what the fleet sustains
HORIZON = 0.22  # s of simulated arrivals (~600 jobs)
SLO_S = 0.007  # tight: contention stalls turn into deadline misses
WINDOW_S = 1e-4  # contention accounting window


def _run(policy: str, cfg: ServeConfig):
    return Session(policy=policy, backend="sim").serve(
        "mmpp",
        config=cfg,
        rate=RATE,
        horizon=HORIZON,
        pool="heavy",
        slo_s=SLO_S,
        tiers=(0, 1, 1),
    )


def _summary(label: str, res) -> None:
    tier0 = res.per("tier")[0]
    m = res.metrics
    print(
        f"{label:>12}: tier0 p99 {tier0.p99_latency_s * 1e3:8.2f}ms  "
        f"miss {tier0.deadline_miss_rate * 100:5.1f}%  |  "
        f"bus stall {m.memory_stall_s:.3f}s, "
        f"peak pressure {m.memory_peak_pressure:.1f}x"
    )


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="memory contention demo")
    parser.add_argument(
        "--capacity",
        type=float,
        default=0.5,
        help="shared bandwidth as a fraction of nominal",
    )
    args = parser.parse_args(argv)

    contention = ContentionModel(window_s=WINDOW_S, capacity=args.capacity)
    cfg = ServeConfig(
        scheduling=SchedulingConfig(
            n_arrays=N_ARRAYS, max_concurrent=4, queue_cap=8, seed=0
        ),
        memory=MemoryConfig(contention=contention),
    )
    print(
        f"shared bus derated to {args.capacity:.0%} of nominal, "
        f"{WINDOW_S * 1e6:.0f}us accounting windows\n"
    )

    results = {p: _run(p, cfg) for p in ("equal", "moca")}
    for label, res in results.items():
        _summary(label, res)

    eq = results["equal"].per("tier")[0].p99_latency_s
    mo = results["moca"].per("tier")[0].p99_latency_s
    print(
        f"\nmoca cuts tier-0 p99 by {(1 - mo / eq) * 100:.1f}% by "
        f"capping batch tenants' bandwidth under pressure"
    )
    return {"results": results, "tier0_p99_cut": 1 - mo / eq}


if __name__ == "__main__":
    main()
