"""``repro_torch.overload`` — closed-loop overload control, the port's own
copy of ``repro.overload``.

The paper keeps SLAs intact by *partitioning* one array; "No DNN Left
Behind" (PAPERS.md) argues the fleet-level corollary: an inference
service is judged under overload, not at nominal load.  This package is
the degrade-before-drop layer the traffic simulator drives when its
``admission=`` / ``brownout=`` knobs are armed:

* :mod:`repro_torch.overload.admission` — the :class:`AdmissionPolicy`
  registry.  ``static`` is the historical behavior (admit everything,
  let the bounded node queue shed); ``codel`` sheds batch tiers on a
  CoDel-style queue-delay target with sqrt-spaced drops; ``token_bucket``
  rate-limits batch tiers through per-tier buckets.  Tier 0 is never
  shed by any registered policy — batch tenants absorb the rejections.
* :mod:`repro_torch.overload.brownout` — :class:`BrownoutController`, a
  feedback loop over queue delay and detected-healthy capacity that
  walks a declared :class:`BrownoutStage` ladder *before* dropping
  anything: tighten batch bandwidth caps, shrink batch column floors,
  stretch batch deadlines, then shed.  Every stage entry/exit is a
  tracer instant and is priced in energy.

With both knobs at their ``None`` defaults nothing here is imported and
every serialized record stays byte-identical to a run without them.
"""

from repro_torch.overload.admission import (
    AdmissionPolicy,
    CoDelAdmission,
    StaticAdmission,
    TokenBucketAdmission,
    list_admissions,
    register_admission,
    resolve_admission,
)
from repro_torch.overload.brownout import (
    DEFAULT_STAGES,
    BrownoutController,
    BrownoutReport,
    BrownoutStage,
)

__all__ = [
    "AdmissionPolicy",
    "StaticAdmission",
    "CoDelAdmission",
    "TokenBucketAdmission",
    "register_admission",
    "list_admissions",
    "resolve_admission",
    "BrownoutStage",
    "BrownoutController",
    "BrownoutReport",
    "DEFAULT_STAGES",
]
