"""``repro_torch.fairness`` — the port's fairness policies and per-tenant
accounting, as ``repro.fairness``.

* :mod:`repro_torch.fairness.drf` — dominant-resource fairness
  (:class:`DRFPolicy`, registered ``"drf"``) over per-tenant resource
  vectors (:class:`ResourceModel`);
* :mod:`repro_torch.fairness.flow` — min-cost max-flow assignment
  (:class:`MinCostFlowPolicy`, registered ``"min_cost_flow"``);
* :mod:`repro_torch.fairness.accounting` — Jain index, per-tenant slowdown
  vs isolated baselines and dominant-share series
  (:class:`FairnessAccounting`), surfaced through
  ``TrafficSimulator(fairness=True)``.

Importing the package registers both policies; ``repro_torch.api.policy``
does so lazily on a name lookup, so ``get_policy("drf")`` needs no explicit
import.
"""

from repro_torch.fairness.accounting import (
    FairnessAccounting,
    FairnessReport,
    jain_index,
)
from repro_torch.fairness.drf import DRFPolicy, ResourceModel
from repro_torch.fairness.flow import MinCostFlowPolicy, min_cost_assignment

__all__ = [
    "DRFPolicy",
    "ResourceModel",
    "MinCostFlowPolicy",
    "min_cost_assignment",
    "FairnessAccounting",
    "FairnessReport",
    "jain_index",
]
