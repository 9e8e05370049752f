"""``repro_torch.traffic`` — open-loop arrival-driven serving simulation,
the port's own copy of ``repro.traffic``.

It measures what a serving system is judged on: latency percentiles,
deadline-miss rate and goodput under a live arrival process, with the
partition policy re-running on every arrival and completion.

    from repro_torch.traffic import PoissonArrivals, TrafficSimulator

    arr = PoissonArrivals(rate=2000.0, horizon=0.05, seed=0, pool="light")
    res = TrafficSimulator(arr, policy="proportional").run()
    print(res.metrics.p99_latency_s, res.metrics.deadline_miss_rate)

``arrivals``  — seeded Poisson / MMPP / diurnal / trace-replay job streams
plus ``batch_instance`` production-trace (Alibaba-style CSV) replay.
``simulator`` — the discrete-event loop + admission control + ServeResult.
``sharded``   — pod-per-process fleet simulation, epoch-synced dispatch.
``metrics``   — p50/p95/p99, miss rate, goodput, queue depth, utilization.
``cluster``   — N-array fleets with jsq / p2c / round-robin dispatch.
``rebalance`` — cross-node tenant migration under a checkpoint-cost model.

The whole package is host arithmetic: it launches no kernel.
"""

from repro_torch.traffic.arrivals import (
    ArrivalProcess,
    BatchInstanceArrivals,
    DiurnalArrivals,
    Job,
    MMPPArrivals,
    PoissonArrivals,
    TraceArrivals,
    get_arrival_process,
    list_arrival_processes,
    register_arrivals,
    resolve_arrivals,
    synth_batch_instance_rows,
)
from repro_torch.traffic.cluster import (
    ArrayNode,
    Dispatcher,
    JoinShortestQueue,
    PowerOfTwoChoices,
    RoundRobin,
    list_dispatchers,
    register_dispatcher,
    resolve_dispatcher,
)
from repro_torch.traffic.metrics import (
    JobRecord,
    TrafficMetrics,
    percentile,
    split_by,
    summarize,
)
from repro_torch.traffic.rebalance import (
    MigrateOnPressure,
    MigrationModel,
    Rebalancer,
    list_rebalancers,
    register_rebalancer,
    resolve_rebalancer,
)
from repro_torch.traffic.sharded import (
    PodFailureError,
    ShardedTrafficSimulator,
    serve_sharded,
)
from repro_torch.traffic.simulator import ServeResult, TrafficSimulator, serve

__all__ = [
    # arrivals
    "Job",
    "ArrivalProcess",
    "PoissonArrivals",
    "MMPPArrivals",
    "DiurnalArrivals",
    "TraceArrivals",
    "BatchInstanceArrivals",
    "synth_batch_instance_rows",
    "register_arrivals",
    "get_arrival_process",
    "list_arrival_processes",
    "resolve_arrivals",
    # cluster
    "ArrayNode",
    "Dispatcher",
    "JoinShortestQueue",
    "PowerOfTwoChoices",
    "RoundRobin",
    "register_dispatcher",
    "list_dispatchers",
    "resolve_dispatcher",
    # metrics
    "JobRecord",
    "TrafficMetrics",
    "percentile",
    "summarize",
    "split_by",
    # rebalance
    "Rebalancer",
    "MigrationModel",
    "MigrateOnPressure",
    "register_rebalancer",
    "list_rebalancers",
    "resolve_rebalancer",
    # simulator
    "TrafficSimulator",
    "ServeResult",
    "serve",
    "ShardedTrafficSimulator",
    "serve_sharded",
    "PodFailureError",
]
