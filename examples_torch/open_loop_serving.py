"""Open-loop serving: Poisson arrivals -> per-policy p99 / miss-rate table.

    PYTHONPATH=src python examples_torch/open_loop_serving.py [--preemption]

The closed-workload quickstart asks "how fast does a fixed batch drain?";
this example asks the serving question: jobs arrive on their own clock
(seeded Poisson stream over the paper's light RNN pool, one DNNG per job,
each with a deadline), the partition policy re-splits the array on every
arrival and completion, and we compare policies on tail latency and SLO
attainment — on the *identical* arrival stream.

Also shown: the same stream over a 4-array fleet behind a
join-shortest-queue dispatcher (`n_arrays=4`), which is how the simulator
scales past one array's saturation point.

With ``--preemption`` the single-array table runs with layer-granular
preemption armed (`PreemptionModel`; only `deadline_preempt` acts on it)
and the fleet run adds cross-node migration (`rebalance_interval`), and
the preemption/migration counters are printed per row.

The same program as ``examples/open_loop_serving.py`` on ``repro_torch``:
host arithmetic, the same text.  ``main`` returns what it printed.
"""

import argparse

from repro_torch.api import Session, list_policies

RATE = 600.0  # jobs/s — near one array's saturation for the light pool
HORIZON = 0.1  # s of simulated arrivals (~60 jobs)
SLO_S = 0.01  # per-job deadline: arrival + 10 ms


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="open-loop serving demo")
    parser.add_argument(
        "--preemption",
        action="store_true",
        help="arm layer-granular preemption (+ migration on the fleet run)",
    )
    args = parser.parse_args(argv)

    print(
        f"Poisson open-loop: rate={RATE:.0f} jobs/s, horizon={HORIZON}s, "
        f"SLO={SLO_S * 1e3:.0f}ms, pool=light, "
        f"preemption={'on' if args.preemption else 'off'}\n"
    )
    print(
        f"{'policy':>16}{'jobs':>6}{'rej%':>7}{'p50ms':>8}{'p95ms':>8}"
        f"{'p99ms':>8}{'miss%':>7}{'goodput/s':>11}{'util%':>7}"
        f"{'npre':>6}"
    )
    rows = {}
    for policy in list_policies():
        res = Session(policy=policy, backend="sim").serve(
            "poisson",
            rate=RATE,
            horizon=HORIZON,
            seed=0,
            pool="light",
            slo_s=SLO_S,
            max_concurrent=4,
            queue_cap=8,
            preemption=args.preemption,
        )
        m = rows[policy] = res.metrics
        print(
            f"{policy:>16}{m.jobs_arrived:>6}{m.rejection_rate * 100:>7.1f}"
            f"{m.p50_latency_s * 1e3:>8.2f}{m.p95_latency_s * 1e3:>8.2f}"
            f"{m.p99_latency_s * 1e3:>8.2f}{m.deadline_miss_rate * 100:>7.1f}"
            f"{m.goodput_jobs_per_s:>11.1f}{m.utilization * 100:>7.1f}"
            f"{m.preemptions:>6}"
        )

    fleet_policy = "deadline_preempt" if args.preemption else "equal"
    fleet_kwargs = {}
    if args.preemption:
        fleet_kwargs = dict(preemption=True, rebalance_interval=2e-3)
    print(
        f"\nSame stream, 4-array fleet (join-shortest-queue, "
        f"policy={fleet_policy}):"
    )
    res = Session(policy=fleet_policy, backend="sim").serve(
        "poisson",
        rate=RATE,
        horizon=HORIZON,
        seed=0,
        pool="light",
        slo_s=SLO_S,
        n_arrays=4,
        dispatch="jsq",
        **fleet_kwargs,
    )
    m = res.metrics
    print(
        f"  p99 {m.p99_latency_s * 1e3:.2f}ms, "
        f"miss {m.deadline_miss_rate * 100:.1f}%, "
        f"goodput {m.goodput_jobs_per_s:.1f}/s, util {m.utilization * 100:.1f}%"
    )
    if args.preemption:
        print(f"  preemptions {m.preemptions}, migrations {m.migrations}")
    per_model = res.per("model")
    print("\nPer-model p99 (fleet run):")
    for model, mm in per_model.items():
        print(
            f"  {model:<18} {mm.p99_latency_s * 1e3:>7.2f}ms "
            f"({mm.jobs_arrived} jobs)"
        )
    return {"policies": rows, "fleet": m, "per_model": per_model}


if __name__ == "__main__":
    main()
