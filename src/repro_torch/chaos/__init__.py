"""``repro_torch.chaos`` — seeded fault injection, detection and recovery,
the port's own copy of ``repro.chaos``.

The serving stack assumes a healthy fleet; this package breaks it on
purpose, deterministically:

* :mod:`repro_torch.chaos.faults`   — :class:`FaultPlan` schedules (crash,
  blackout, degrade, bus_stall, straggler, pod_kill);
* :mod:`repro_torch.chaos.monitor`  — :class:`HealthMonitor` belief tracking
  (heartbeat staleness, dispatch failures, service outliers);
* :mod:`repro_torch.chaos.recovery` — :class:`RecoveryPolicy` registry
  (``retry_restart`` backoff + checkpoint warm restart + watermark
  shedding; ``none`` for the unrecovered control arm);
* :mod:`repro_torch.chaos.controller` — :class:`ChaosController`, the loop the
  :class:`~repro_torch.traffic.simulator.TrafficSimulator` drives when its
  ``faults=`` knob is armed.

With ``faults=None`` (the default) nothing here is even imported and
every serialized record stays byte-identical to a run without faults.
"""

from repro_torch.chaos.controller import ChaosController, ChaosReport
from repro_torch.chaos.faults import FAULT_KINDS, FaultEvent, FaultPlan, resolve_faults
from repro_torch.chaos.monitor import HealthMonitor
from repro_torch.chaos.recovery import (
    NoRecovery,
    RecoveryPolicy,
    RetryPolicy,
    RetryRestart,
    list_recoveries,
    register_recovery,
    resolve_recovery,
    respawn_backoffs,
    truncate_dnng,
)

__all__ = [
    "FAULT_KINDS",
    "FaultEvent",
    "FaultPlan",
    "resolve_faults",
    "HealthMonitor",
    "RetryPolicy",
    "RecoveryPolicy",
    "RetryRestart",
    "NoRecovery",
    "register_recovery",
    "list_recoveries",
    "resolve_recovery",
    "respawn_backoffs",
    "truncate_dnng",
    "ChaosController",
    "ChaosReport",
]
