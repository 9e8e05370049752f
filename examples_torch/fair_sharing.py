"""Fair sharing: equal vs DRF vs min-cost flow on a bursty heavy mix.

    PYTHONPATH=src python examples_torch/fair_sharing.py [--trace] [--sharded]

Width-equal splitting looks fair but isn't: a tenant whose layers hammer
the stage-in bus gets the same columns as a compute-bound one and both
stall differently, so per-tenant slowdown (latency vs an isolated run of
the same model on the full array) spreads wide.  This example serves the
*identical* bursty MMPP stream over the paper's heavy pool under three
policies and prints the fairness view next to the SLA view:

* ``equal``         — the paper's baseline width split;
* ``drf``           — dominant-resource fairness over (columns, stage-in
  bus share, SRAM footprint): progressive filling grants columns to the
  tenant with the smallest dominant share, so bus-bound and compute-bound
  tenants equalize on the resource each actually saturates;
* ``min_cost_flow`` — tenants -> partitions as a min-cost max-flow over
  the batch cost oracle: globally cheapest assignment, fairness emergent.

``--trace`` replays a synthetic Alibaba ``batch_instance``-style CSV
(``synth_batch_instance_rows``) instead of MMPP — the production-trace
path.  ``--sharded`` reruns the winner through the sharded fleet
simulator (4 pods over 8 arrays, forked) to show the deterministic-merge
path.

The same program as ``examples/fair_sharing.py`` on ``repro_torch``: host
arithmetic, the same text.  ``main`` returns what it printed.
"""

import argparse

from repro_torch.api import Session

RATE = 1000.0  # jobs/s — ~0.9 rho over 2 arrays; bursts push past 1.0
HORIZON = 0.3  # s of simulated arrivals (~300 jobs)
SLO_S = 0.01  # deadline: arrival + 10 ms (tier-scaled)
POLICIES = ("equal", "drf", "min_cost_flow")


def _row(policy, res):
    m = res.metrics
    rep = res.fairness
    slowdown = rep.per_tenant_slowdown.values()
    print(
        f"{policy:>14}{m.jobs_arrived:>6}{m.p99_latency_s * 1e3:>9.1f}"
        f"{m.deadline_miss_rate * 100:>7.1f}{rep.jain_fairness:>7.3f}"
        f"{max(slowdown):>9.1f}"
        f"{sum(slowdown) / len(rep.per_tenant_slowdown):>9.1f}"
    )


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="fair-sharing demo")
    parser.add_argument(
        "--trace",
        action="store_true",
        help="replay a synthetic batch_instance CSV instead of the MMPP stream",
    )
    parser.add_argument(
        "--sharded",
        action="store_true",
        help="rerun one cell through the sharded fleet simulator (4 pods / 8 arrays)",
    )
    args = parser.parse_args(argv)

    if args.trace:
        from repro_torch.traffic import synth_batch_instance_rows

        rows = synth_batch_instance_rows(400, seed=0)
        arrivals = "batch_instance"
        kwargs = dict(source=rows, pool="heavy", slo_s=SLO_S, seed=0)
        print(
            f"batch_instance trace replay: {len(rows) - 1} rows, "
            f"pool=heavy, SLO={SLO_S * 1e3:.0f}ms\n"
        )
    else:
        arrivals = "mmpp"
        kwargs = dict(
            rate=RATE, horizon=HORIZON, seed=0, pool="heavy", slo_s=SLO_S, tiers=(0, 1)
        )
        print(
            f"MMPP bursty open-loop: mean rate={RATE:.0f} jobs/s, "
            f"horizon={HORIZON}s, SLO={SLO_S * 1e3:.0f}ms, pool=heavy\n"
        )

    print(
        f"{'policy':>14}{'jobs':>6}{'p99ms':>9}{'miss%':>7}{'jain':>7}"
        f"{'slo_max':>9}{'slo_mu':>9}"
    )
    results = {}
    for policy in POLICIES:
        res = Session(policy=policy, backend="sim").serve(
            arrivals, n_arrays=2, dispatch="jsq", fairness=True, **kwargs
        )
        results[policy] = res
        _row(policy, res)

    best = max(POLICIES, key=lambda p: results[p].fairness.jain_fairness)
    print(
        f"\nhighest Jain fairness: {best} "
        f"({results[best].fairness.jain_fairness:.3f} vs "
        f"{results['equal'].fairness.jain_fairness:.3f} for equal)"
    )
    print("per-tenant slowdown under", best, "(latency / isolated run):")
    for model, s in sorted(results[best].fairness.per_tenant_slowdown.items()):
        print(f"  {model:<18}{s:>8.1f}x")

    out = {"results": results, "best": best, "sharded": None}
    if args.sharded:
        from repro_torch.traffic import serve_sharded

        print(
            f"\nsharded rerun of {best}: 8 arrays, 4 pods, rr dispatch "
            f"(byte-identical to the single-process simulator):"
        )
        res = serve_sharded(
            arrivals,
            policy=best,
            backend="sim",
            n_arrays=8,
            n_shards=4,
            dispatch="rr",
            fairness=True,
            **kwargs,
        )
        m = out["sharded"] = res.metrics
        print(
            f"  p99 {m.p99_latency_s * 1e3:.1f}ms, "
            f"miss {m.deadline_miss_rate * 100:.1f}%, "
            f"jain {m.jain_fairness:.3f}"
        )
    return out


if __name__ == "__main__":
    main()
