"""``repro_torch.api`` — the port's front door: pluggable policies × backends.

    from repro_torch.api import Session
    Session(policy="equal", backend="sim").run("heavy")

* :mod:`repro_torch.api.policy`  — the :class:`PartitionPolicy` protocol and
  the registry (the JAX package's nine policies);
* :mod:`repro_torch.api.backend` — the :class:`Accelerator` protocol and the
  ``sim`` and ``mesh`` backends;
* :mod:`repro_torch.api.session` — the :class:`Session` facade
  (``run`` for a closed workload, ``serve`` for an open-loop stream);
* :mod:`repro_torch.api.config` — the :class:`ServeConfig` value object
  grouping every ``serve()`` knob by subsystem.
"""

from repro_torch.api.backend import (
    Accelerator,
    EnergyReport,
    MeshBackend,
    SimBackend,
    get_backend,
    list_backends,
    register_backend,
    resolve_backend,
)
from repro_torch.api.config import (
    ChaosConfig,
    MemoryConfig,
    OverloadConfig,
    RebalanceConfig,
    SchedulingConfig,
    ServeConfig,
    resolve_serve_config,
)
from repro_torch.api.policy import (
    AssignContext,
    BestFitPolicy,
    DeadlinePreemptPolicy,
    EqualPolicy,
    InFlightLayer,
    MocaPolicy,
    PartitionPolicy,
    PreemptContext,
    PriorityPolicy,
    ProportionalPolicy,
    TenantDemand,
    WidthAwarePolicy,
    get_policy,
    list_policies,
    register_policy,
    resolve_policy,
)
from repro_torch.api.session import BaselineRun, Session, SessionResult

__all__ = [
    # policies
    "PartitionPolicy",
    "TenantDemand",
    "AssignContext",
    "PreemptContext",
    "InFlightLayer",
    "EqualPolicy",
    "ProportionalPolicy",
    "BestFitPolicy",
    "PriorityPolicy",
    "WidthAwarePolicy",
    "DeadlinePreemptPolicy",
    "MocaPolicy",
    "register_policy",
    "get_policy",
    "list_policies",
    "resolve_policy",
    # backends
    "Accelerator",
    "EnergyReport",
    "SimBackend",
    "MeshBackend",
    "register_backend",
    "get_backend",
    "list_backends",
    "resolve_backend",
    # session
    "Session",
    "SessionResult",
    "BaselineRun",
    # serve config
    "ServeConfig",
    "SchedulingConfig",
    "RebalanceConfig",
    "ChaosConfig",
    "MemoryConfig",
    "OverloadConfig",
    "resolve_serve_config",
]
