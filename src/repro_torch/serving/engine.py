"""Multi-tenant serving engine — Algorithm 1 driving live device tenancy.

Counterpart of ``repro.serving.engine``, with the same behaviour:

* tenants (models) arrive with a request queue; ``demand`` ≙ Opr — the
  total outstanding decode work (tokens × per-token FLOPs);
* ``TenantMeshManager.rebalance`` splits the device columns over live
  tenant demands with the engine's ``policy`` — at admission, on a fault or
  heal, and at the start of the first round after a submit;
* when a tenant's queue drains it releases its slice; adjacent free slices
  merge and ``grow_into_free`` widens the survivors (merge-accelerate);
* a failed device column evicts its tenants, which re-enter the rebalance.

Execution is slice-agnostic, as in the JAX package: the manager
(``TenantMeshManager(mesh, "model")``) decides the grants, but the engine
builds no tenant sub-mesh, and every admitted tenant's
:class:`DecodeSession` runs each round on the session's own device.
``width_history`` records every (round, tenant, width) grant.
"""

from __future__ import annotations

import dataclasses
import itertools

from repro_torch.distributed.tenancy import TenantMeshManager
from repro_torch.serving.kv_cache import DecodeSession, Request


@dataclasses.dataclass
class TenantService:
    name: str
    session: DecodeSession
    queue: list[Request] = dataclasses.field(default_factory=list)
    flops_per_token: float = 1.0
    width: int = 0
    served: int = 0

    @property
    def outstanding_tokens(self) -> int:
        q = sum(r.max_new - len(r.out) + len(r.prompt) for r in self.queue)
        live = sum(r.max_new - len(r.out) for r in self.session.live.values())
        return q + live

    @property
    def demand(self) -> float:
        """Opr analogue: outstanding work in FLOPs."""
        return self.outstanding_tokens * self.flops_per_token

    @property
    def drained(self) -> bool:
        return not self.queue and not self.session.live


class MultiTenantEngine:
    """Round-based multi-tenant decode executor over a device grid.

    ``policy`` selects the partition policy used at every rebalance; it is
    forwarded to :meth:`TenantMeshManager.rebalance` (default ``"equal"``,
    the paper's Algorithm 1).
    """

    def __init__(self, manager: TenantMeshManager, policy="equal"):
        self.manager = manager
        self.policy = policy
        self.tenants: dict[str, TenantService] = {}
        self.width_history: list[tuple[int, str, int]] = []
        self.round = 0
        self._rid = itertools.count()
        self._dirty = False  # demand changed since the last rebalance

    # -- tenancy ------------------------------------------------------------
    def add_tenant(
        self,
        name: str,
        session: DecodeSession,
        flops_per_token: float,
        min_cols: int = 1,
        tier: int = 0,
    ) -> TenantService:
        """Admit a model; ``min_cols``/``tier`` feed policies that use
        reservation floors and SLA classes."""
        svc = TenantService(name=name, session=session, flops_per_token=flops_per_token)
        self.tenants[name] = svc
        self.manager.admit(name, demand=svc.demand, min_cols=min_cols, tier=tier)
        self._rebalance()
        return svc

    def submit(self, tenant: str, prompt: list[int], max_new: int) -> Request:
        """Enqueue a request.  This changes the tenant's demand, so the
        split is re-run at the start of the next :meth:`step` (all submits
        of a round share one rebalance)."""
        req = Request(rid=next(self._rid), prompt=prompt, max_new=max_new)
        self.tenants[tenant].queue.append(req)
        self._dirty = True
        return req

    def _rebalance(self) -> None:
        for name, svc in self.tenants.items():
            self.manager.tenant(name).demand = svc.demand
        grants = self.manager.rebalance(policy=self.policy)
        for name, part in grants.items():
            self.tenants[name].width = part.cols
            self.width_history.append((self.round, name, part.cols))
        self._dirty = False

    def _retire_drained(self) -> list[str]:
        done = [n for n, s in self.tenants.items() if s.drained]
        for n in done:
            self.manager.release(n)
            del self.tenants[n]
        if done:
            # merge-accelerate survivors (paper §3.3) — no re-shard storm
            grown = self.manager.grow_into_free()
            for name, part in grown.items():
                if name in self.tenants:
                    self.tenants[name].width = part.cols
                    self.width_history.append((self.round, name, part.cols))
        return done

    # -- execution ----------------------------------------------------------
    def step(self) -> dict[str, dict[int, int]]:
        """One engine round: admit from queues, decode every tenant, retire.

        Returns {tenant: {rid: token}} of this round's emissions.
        """
        self.round += 1
        if self._dirty:
            self._rebalance()
        out: dict[str, dict[int, int]] = {}
        for name, svc in self.tenants.items():
            while svc.queue and svc.session.can_admit():
                svc.session.admit(svc.queue.pop(0))
            if svc.session.live:
                emitted = svc.session.step()
                svc.served += len(emitted)
                out[name] = emitted
        self._retire_drained()
        return out

    def run_until_drained(self, max_rounds: int = 10_000) -> int:
        """Drive rounds until every tenant drains; returns rounds used."""
        r0 = self.round
        while self.tenants:
            if self.round - r0 >= max_rounds:
                raise RuntimeError(
                    f"engine did not drain in {max_rounds} rounds; "
                    f"live={list(self.tenants)}"
                )
            self.step()
        return self.round - r0

    # -- fault handling -----------------------------------------------------
    def fail_column(self, col: int) -> list[str]:
        """Device-column failure: evict + immediately re-place tenants."""
        evicted = self.manager.mark_unhealthy(col)
        self._rebalance()
        return evicted

    def heal_column(self, col: int) -> None:
        self.manager.mark_healthy(col)
        self._rebalance()
