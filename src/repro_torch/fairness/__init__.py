"""``repro_torch.fairness`` — the port's fairness policies.

Ported so far: :mod:`repro_torch.fairness.drf` (dominant-resource fairness,
:class:`DRFPolicy`, registered ``"drf"``, over :class:`ResourceModel`
vectors) and :mod:`repro_torch.fairness.flow` (min-cost max-flow assignment,
:class:`MinCostFlowPolicy`, registered ``"min_cost_flow"``).  The JAX
package's ``fairness.accounting`` (Jain index, per-tenant slowdown,
dominant-share series) is driven by the traffic simulator and is not ported
yet (ROADMAP.md, "Modules to port").

Importing the package registers both policies; ``repro_torch.api.policy``
does so lazily on a name lookup, so ``get_policy("drf")`` needs no explicit
import.
"""

from repro_torch.fairness.drf import DRFPolicy, ResourceModel
from repro_torch.fairness.flow import MinCostFlowPolicy, min_cost_assignment

__all__ = ["DRFPolicy", "ResourceModel", "MinCostFlowPolicy", "min_cost_assignment"]
