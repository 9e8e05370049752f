"""Scale-Sim + Accelergy analogue: the paper's evaluation toolchain.

``systolic``  — analytic weight-stationary cycle model (partition-aware).
``energy``    — 45 nm per-access/per-cycle energy model.
``workloads`` — the paper's 12 DNNs (heavy multi-domain + light RNN) as DNNGs.
``runner``    — baseline-vs-partitioned experiment driver (Fig. 9).

Host arithmetic only (Python ints and floats, NumPy int64): it models the
paper's accelerator and puts nothing on the card.
"""

from repro_torch.sim.energy import EnergyBreakdown, EnergyModel
from repro_torch.sim.runner import ExperimentResult, run_experiment
from repro_torch.sim.systolic import SystolicConfig, layer_time_fn

__all__ = [
    "SystolicConfig",
    "layer_time_fn",
    "EnergyModel",
    "EnergyBreakdown",
    "run_experiment",
    "ExperimentResult",
]
