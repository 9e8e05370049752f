"""Baseline-vs-partitioned experiment driver — reproduces paper Fig. 9.

The port's own copy of ``repro.sim.runner``: a thin shim over
:class:`repro_torch.api.Session` with the ``sim`` backend.  For each
workload it runs the sequential single-tenancy **baseline** (every layer on
the full array, no ``Mul_En``) and the **partitioned** schedule under the
selected policy, and reports per-DNN completion times (Fig. 9 a–d),
partition-size histograms (Fig. 9 c,d) and the energy totals (Fig. 9 e,f).

    python -m repro_torch.sim.runner

prints the same report as ``python -m repro.sim.runner``.
"""

from __future__ import annotations

from repro_torch.api.backend import SimBackend
from repro_torch.api.session import Session, SessionResult
from repro_torch.sim.energy import EnergyModel
from repro_torch.sim.systolic import SystolicConfig

# the experiment result is the Session result (the JAX package's alias)
ExperimentResult = SessionResult


def run_experiment(
    workload: str,
    cfg: SystolicConfig | None = None,
    energy: EnergyModel | None = None,
    policy="paper",
) -> SessionResult:
    """``Session(policy, backend=SimBackend(cfg, energy)).run(workload)``."""
    backend = SimBackend(config=cfg, energy=energy)
    return Session(policy=policy, backend=backend).run(workload)


def format_report(res: SessionResult) -> str:
    lines = [f"== workload: {res.workload} (policy: {res.policy}) =="]
    lines.append(f"baseline makespan:     {res.baseline.makespan * 1e3:10.3f} ms")
    lines.append(f"partitioned makespan:  {res.partitioned.makespan * 1e3:10.3f} ms")
    lines.append(f"time saving (makespan):{res.time_saving * 100:10.1f} %")
    lines.append(f"time saving (turnarnd):{res.turnaround_saving * 100:10.1f} %")
    lines.append(f"baseline energy:       {res.baseline_energy.total * 1e3:10.3f} mJ")
    lines.append(
        f"partitioned energy:    {res.partitioned_energy.total * 1e3:10.3f} mJ"
    )
    lines.append(f"energy saving:         {res.energy_saving * 100:10.1f} %")
    lines.append(f"baseline utilization:  {res.baseline.utilization * 100:10.1f} %")
    lines.append(f"partition utilization: {res.partitioned.utilization * 100:10.1f} %")
    lines.append("per-DNN completion (ms), baseline vs partitioned:")
    for name in res.baseline.completion:
        b = res.baseline.completion[name] * 1e3
        p = res.partitioned.completion[name] * 1e3
        lines.append(f"  {name:<18} {b:10.3f}  ->  {p:10.3f}")
    lines.append(f"partition sizes used: {res.partition_histogram()}")
    return "\n".join(lines)


def main() -> None:
    for wl in ("heavy", "light"):
        print(format_report(run_experiment(wl)))
        print()


if __name__ == "__main__":
    main()
