"""Chaos serving: seeded faults, detection, and SLA-preserving recovery.

    PYTHONPATH=src python examples_torch/chaos_serving.py [--seed N] [--none]

Crashes, blackouts and stragglers hit a 4-array fleet mid-run while a
Poisson stream is being served.  Failures are *detected*, not announced:
the HealthMonitor watches heartbeat staleness, failed dispatch RPCs and
service-time outliers, dispatchers route around the belief, and lost
jobs restart warm from their last completed-layer checkpoint under the
``retry_restart`` policy.  The run prints:

* the fault schedule (deterministic under ``--seed``);
* every belief transition the monitor fired, with its cause;
* the chaos accounting (lost / retried / recovered / shed) and per-tier
  availability, next to the same run with ``recovery="none"`` — the
  control arm shows what the retry path buys.

``--none`` skips the recovery arm comparison and only runs the control.

The same program as ``examples/chaos_serving.py`` on ``repro_torch``: host
arithmetic, the same text.  ``main`` returns what it printed.
"""

import argparse

from repro_torch.api import Session
from repro_torch.chaos import FaultPlan

N_ARRAYS = 4
RATE = 1800.0  # jobs/s over 4 arrays — busy but with failover headroom
HORIZON = 0.4  # s of simulated arrivals (~700 jobs)
SLO_S = 0.05  # generous enough that a warm restart can still make it


def _run(plan, recovery):
    return Session(policy="equal", backend="sim").serve(
        "poisson",
        rate=RATE,
        horizon=HORIZON,
        pool="light",
        slo_s=SLO_S,
        tiers=(0, 1, 2),
        n_arrays=N_ARRAYS,
        dispatch="jsq",
        max_concurrent=4,
        queue_cap=16,
        faults=plan,
        recovery=recovery,
    )


def _summary(label, res):
    c, m = res.chaos, res.metrics
    avail = ", ".join(
        f"tier{t}={v:.3f}" for t, v in sorted(m.availability_by_tier.items())
    )
    print(
        f"{label:>14}: {m.jobs_completed}/{m.jobs_arrived} completed, "
        f"miss {m.deadline_miss_rate * 100:.1f}%  |  "
        f"lost {c.jobs_lost}, retried {c.jobs_retried}, "
        f"recovered {c.jobs_recovered}, shed {c.jobs_shed}"
    )
    print(f"{'':>16}availability: {avail}")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="chaos serving demo")
    parser.add_argument(
        "--seed", type=int, default=5, help="fault-plan seed (same seed, same run)"
    )
    parser.add_argument(
        "--none",
        action="store_true",
        help="run only the recovery-disabled control arm",
    )
    args = parser.parse_args(argv)

    plan = FaultPlan.seeded(
        args.seed,
        horizon=HORIZON,
        n_nodes=N_ARRAYS,
        crashes=1,
        blackouts=1,
        stragglers=1,
    )
    print(f"fault plan (seed {args.seed}):")
    for e in plan.events:
        extra = f" for {e.duration_s * 1e3:.1f}ms" if e.duration_s else ""
        print(f"  t={e.t * 1e3:7.2f}ms  {e.kind:<10} node {e.node}{extra}")
    print()

    if args.none:
        arms = [("none", "none")]
    else:
        arms = [("retry_restart", "retry_restart"), ("none", "none")]
    results = {}
    for label, recovery in arms:
        results[label] = _run(plan, recovery)

    res = results[arms[0][0]]
    print("belief transitions (detection, not announcement):")
    churn = 0
    for t, node, old, new, cause in res.chaos.transitions:
        if cause in ("service_outlier", "probe_ok"):
            churn += 1  # gray-failure probation churn; summarized below
            continue
        print(f"  t={t * 1e3:7.2f}ms  node {node}: {old} -> {new}  [{cause}]")
    if churn:
        print(
            f"  (+ {churn} service-outlier suspect/probe cycles under "
            f"co-tenancy load)"
        )
    print()
    for label, _ in arms:
        _summary(label, results[label])
    saved = None
    if len(results) == 2:
        saved = (
            results["none"].metrics.deadline_miss_rate
            - results["retry_restart"].metrics.deadline_miss_rate
        )
        print(f"\nrecovery saves {saved * 100:.2f}pp of deadline misses on this plan")
    return {"plan": plan, "results": results, "churn": churn, "miss_saved": saved}


if __name__ == "__main__":
    main()
