"""Admission policies — the port's own copy of
``repro.overload.admission``: who gets into the fleet when it is overdriven.

The historical admission control is *structural*: a job that finds no
run slot parks in the node's bounded FIFO, and a full FIFO rejects it
(``ArrayNode.offer``).  That is tier-blind — under a 1.5× overdrive the
queue fills with batch work and latency-critical arrivals are shed with
the same probability as throughput tenants.  An :class:`AdmissionPolicy`
sits *in front of* the dispatcher and decides per arrival whether the
job enters the fleet at all, reading the same queue-delay signal CoDel
reads off a router queue (the fleet's best-case
:meth:`~repro_torch.traffic.cluster.ArrayNode.wait_estimate`).

Contract shared by every registered policy: **tier 0 is never shed** —
admission pressure lands entirely on batch tiers, which is the point of
tiered overload control.  All state is deterministic (no rng), so runs
are seed-stable and the serialized records replay byte-identically.

Registry names:

* ``static`` — admit everything; the bounded node queue stays the only
  shedding mechanism (rejection cause ``queue_full``).  This *is* the
  pre-overload behavior, expressed as a policy so arms are comparable.
* ``codel`` — tier-aware CoDel: while the fleet's minimum queue-delay
  estimate has stayed above ``target_delay_s`` for a full
  ``interval_s``, batch arrivals are shed at the sqrt-spaced CoDel drop
  schedule (cause ``admission_shed``).
* ``token_bucket`` — per-tier token buckets (``rate`` admits/s, depth
  ``burst``) on batch tiers; tier 0 bypasses the buckets entirely.
"""

from __future__ import annotations

import abc
import math

from repro_torch.core.registry import Registry


class AdmissionPolicy(abc.ABC):
    """Per-arrival admit/shed decision at the fleet front door.

    ``admit`` sees the job's SLA tier, the arrival instant and the
    fleet's current best-case queue-delay estimate (seconds a queued job
    would wait for a run slot on the least-loaded node).  Implementations
    may keep state across calls — one instance drives one run.
    """

    name: str = ""

    @abc.abstractmethod
    def admit(self, tier: int, now: float, delay_s: float) -> bool:
        """True to let the arrival through to the dispatcher, False to
        shed it (counted under the ``admission_shed`` cause)."""


_REGISTRY = Registry("admission policy")


def register_admission(name: str):
    return _REGISTRY.register(name)


def list_admissions() -> list[str]:
    return _REGISTRY.names()


def resolve_admission(admission) -> AdmissionPolicy:
    return _REGISTRY.resolve(admission, AdmissionPolicy)


@register_admission("static")
class StaticAdmission(AdmissionPolicy):
    """Admit everything — the bounded node queue does the shedding.

    The pre-overload behavior as a named arm: running with
    ``admission="static"`` changes no routing or offer decision, it only
    turns on the gated rejection-cause accounting so the arm is directly
    comparable to ``codel``/``token_bucket`` on the same stream.
    """

    def admit(self, tier: int, now: float, delay_s: float) -> bool:
        return True


@register_admission("codel")
class CoDelAdmission(AdmissionPolicy):
    """Tier-aware CoDel on the fleet queue-delay estimate.

    Classic CoDel watches the *sojourn time* of a router queue: nothing
    happens until the delay has stayed above ``target_delay_s`` for one
    full ``interval_s``; then drops fire at intervals shrinking with
    ``interval_s / sqrt(drop_count)`` until the delay dips back under
    the target.  Here a "drop" sheds a **batch** arrival — tier 0 rides
    through every drop window untouched, which is the tier-awareness the
    plain algorithm lacks.
    """

    def __init__(self, target_delay_s: float = 5e-3, interval_s: float = 10e-3):
        if target_delay_s <= 0 or interval_s <= 0:
            raise ValueError(
                f"target_delay_s and interval_s must be positive, got "
                f"{target_delay_s} / {interval_s}"
            )
        self.target_delay_s = target_delay_s
        self.interval_s = interval_s
        self._first_above: float | None = None
        self._dropping = False
        self._drop_next = 0.0
        self._drop_count = 0

    def admit(self, tier: int, now: float, delay_s: float) -> bool:
        if delay_s < self.target_delay_s:
            # back under target: leave the dropping state entirely
            self._first_above = None
            self._dropping = False
            self._drop_count = 0
            return True
        if tier <= 0:
            # latency-critical arrivals never shed; the delay stays
            # "above target" for the batch bookkeeping either way
            return True
        if self._first_above is None:
            self._first_above = now + self.interval_s
            return True
        if not self._dropping:
            if now >= self._first_above:
                self._dropping = True
                self._drop_count = 1
                self._drop_next = now + self.interval_s
                return False
            return True
        if now >= self._drop_next:
            self._drop_count += 1
            self._drop_next = now + self.interval_s / math.sqrt(self._drop_count)
            return False
        return True


@register_admission("token_bucket")
class TokenBucketAdmission(AdmissionPolicy):
    """Per-tier token buckets on batch tiers; tier 0 is exempt.

    Each batch tier owns a bucket of depth ``burst`` refilled at
    ``rate`` tokens per second of *simulated* time; an arrival spends
    one token or is shed.  The invariant the property test pins: over
    any window, a tier's admits never exceed ``burst + rate × elapsed``,
    and tier-0 admits are a superset of what any capacity-equivalent
    policy admits (they bypass the buckets).
    """

    def __init__(self, rate: float = 500.0, burst: float = 20.0):
        if rate <= 0 or burst < 1:
            raise ValueError(f"need rate > 0 and burst >= 1, got {rate} / {burst}")
        self.rate = rate
        self.burst = burst
        # tier -> [tokens, last refill instant]
        self._buckets: dict[int, list[float]] = {}

    def admit(self, tier: int, now: float, delay_s: float) -> bool:
        if tier <= 0:
            return True
        b = self._buckets.get(tier)
        if b is None:
            b = self._buckets[tier] = [float(self.burst), now]
        tokens = min(float(self.burst), b[0] + self.rate * (now - b[1]))
        b[1] = now
        if tokens >= 1.0:
            b[0] = tokens - 1.0
            return True
        b[0] = tokens
        return False
