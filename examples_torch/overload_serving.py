"""Overload survival: admission control, brownout, and pod respawn.

    PYTHONPATH=src python examples_torch/overload_serving.py [--load X]

A 4-array fleet is driven at 1.5x its service capacity with a bursty
MMPP mix (one latency-critical tier-0 stream, two batch tiers).  Three
arms serve the SAME arrival stream:

* ``static``   — admit everything; the bounded queues are the only
  backpressure (jobs die as tier-blind ``queue_full`` rejections);
* ``codel``    — CoDel-style adaptive admission: when fleet queue delay
  sits above target for a full interval, batch arrivals are shed on a
  sqrt-spaced schedule (tier 0 is never shed);
* ``brownout`` — a feedback controller walks a declared degradation
  ladder as pressure rises (shrink batch column floors -> stretch batch
  deadlines -> shed batch), and walks back up when pressure clears.
  Every transition is priced in joules and logged.

The run prints tier-0 p99 / deadline misses / goodput per arm, the
per-cause rejection split, the per-tier shed counts (tier 0 is always
absent — sheds are batch-only by construction), and the brownout
stage log.

The second half kills a pod mid-run in a sharded fleet: without
``respawn=True`` the run aborts with a ``PodFailureError`` carrying the
partial results; with it, the supervisor respawns the pod from the last
epoch boundary and re-admits the lost jobs through the retry path —
and the serial and forked supervisors produce byte-identical results.

The same program as ``examples/overload_serving.py`` on ``repro_torch``:
host arithmetic, the same text.  ``main`` returns what it printed.
"""

import argparse
import json

from repro_torch.api import Session
from repro_torch.chaos import FaultEvent
from repro_torch.overload import BrownoutController, BrownoutStage, CoDelAdmission
from repro_torch.traffic import PodFailureError, ShardedTrafficSimulator

N_ARRAYS = 4
SVC_S = 2.32e-3  # mean light-pool service time on one array
SLO_S = 4 * SVC_S
TIERS = (0, 1, 1)

LADDER = (
    BrownoutStage("shrink_floors", batch_demand_scale=0.5),
    BrownoutStage("stretch_deadlines", batch_demand_scale=0.35, deadline_stretch=2.0),
    BrownoutStage(
        "shed", batch_demand_scale=0.25, deadline_stretch=2.0, shed_batch=True
    ),
)


def _serve(arm, rate):
    knobs = {}
    if arm == "codel":
        # the bounded-queue fleet's delay estimate saturates around
        # 2.5x mean service time, so the setpoint must sit below that
        # ceiling (the stock 5 ms default would never fire here)
        knobs["admission"] = CoDelAdmission(target_delay_s=2e-3, interval_s=5e-3)
    elif arm == "brownout":
        knobs["brownout"] = BrownoutController(delay_target_s=2e-3, stages=LADDER)
    return Session(policy="width_aware", backend="sim").serve(
        "mmpp",
        rate=rate,
        horizon=600 / rate,
        pool="light",
        slo_s=SLO_S,
        tiers=TIERS,
        n_arrays=N_ARRAYS,
        dispatch="jsq",
        max_concurrent=4,
        queue_cap=8,
        seed=0,
        **knobs,
    )


def _tier0_p99(res):
    lat = sorted(
        r.completed - r.arrival
        for r in res.records
        if r.tier == 0 and r.completed is not None
    )
    return lat[min(len(lat) - 1, int(0.99 * len(lat)))]


def _goodput(res):
    horizon = max(r.arrival for r in res.records)
    ok = sum(1 for r in res.records if r.completed is not None and r.met_deadline)
    return ok / horizon


def overload_arms(load):
    rate = N_ARRAYS * load / SVC_S
    print(
        f"== admission / brownout at {load:.2f}x load "
        f"({rate:.0f} jobs/s over {N_ARRAYS} arrays) =="
    )
    arms = {}
    for arm in ("static", "codel", "brownout"):
        res = arms[arm] = _serve(arm, rate)
        m = res.metrics
        print(
            f"{arm:>9}: tier0 p99 {_tier0_p99(res) * 1e3:6.2f} ms  "
            f"miss {m.deadline_miss_rate * 100:5.1f}%  "
            f"goodput {_goodput(res):7.1f} jobs/s"
        )
        print(
            f"{'':>11}rejections {dict(m.rejections_by_cause or {})}  "
            f"shed_by_tier {m.shed_by_tier or {}}"
        )
        if res.brownout is not None:
            rep = res.brownout
            print(
                f"{'':>11}brownout: {rep.transitions} transitions, "
                f"{rep.energy_overhead_j:.2f} J overhead"
            )
            for t, frm, to in rep.log[:6]:
                print(f"{'':>13}t={t * 1e3:7.2f} ms  {frm or 'off'} -> {to or 'off'}")
            if len(rep.log) > 6:
                print(f"{'':>13}... {len(rep.log) - 6} more")
    return arms


def pod_respawn():
    print("\n== pod respawn in the sharded fleet ==")
    kill = FaultEvent(t=0.0, kind="pod_kill", node=1, epoch=1)

    def sharded(**kw):
        return ShardedTrafficSimulator(
            "poisson",
            n_arrays=N_ARRAYS,
            n_shards=2,
            rate=3000.0,
            horizon=0.05,
            pool="light",
            seed=0,
            sync_every=64,
            parallel=False,
            **kw,
        )

    aborted = None
    try:
        sharded(faults=kill).run()
    except PodFailureError as e:
        aborted = e
        print(f"without respawn: aborts — {e}")
        print(
            f"  partial payload: {e.jobs_completed} jobs completed, "
            f"pod status {e.pod_status}"
        )

    res = sharded(faults=kill, respawn=True).run()
    print(
        f"with respawn: completes — {len(res.records)} records, "
        f"recovery={res.recovery!r}"
    )

    forked = ShardedTrafficSimulator(
        "poisson",
        n_arrays=N_ARRAYS,
        n_shards=2,
        rate=3000.0,
        horizon=0.05,
        pool="light",
        seed=0,
        sync_every=64,
        parallel=True,
        pod_timeout_s=60.0,
        faults=kill,
        respawn=True,
    ).run()
    same = json.dumps(res.as_dict()) == json.dumps(forked.as_dict())
    print(f"serial == forked supervisor: {'byte-identical' if same else 'MISMATCH'}")
    return {"aborted": aborted, "respawned": res, "forked_identical": same}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="overload survival demo")
    parser.add_argument(
        "--load",
        type=float,
        default=1.5,
        help="offered load as a multiple of fleet capacity",
    )
    args = parser.parse_args(argv)
    return {"arms": overload_arms(args.load), "respawn": pod_respawn()}


if __name__ == "__main__":
    main()
