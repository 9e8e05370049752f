"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

    from repro_torch import FaultPlan, Observability, ServeConfig, Session, serve

    res = Session(policy="equal", backend="sim").run("heavy")
    srv = Session(policy="moca").serve("mmpp", rate=40.0, horizon=1.0, memory=True)

The package mirrors ``repro``'s layout (``kernels``, ``core``, ``sim``,
``api``, ``traffic``, ``fairness``, ``chaos``, ``overload``, ``obs``,
``distributed``, ``models``, ``configs``, ``serving``): each module holds
the counterpart of the module of the same name there.  It imports ``torch``
and ``numpy`` only, never ``jax`` and nothing of ``repro``.

Entry points that create tensors default to ``device="cuda"`` and raise when
CUDA is absent; a caller that wants the CPU passes ``device="cpu"``.
Functions that take tensors run where the tensors are.  The top-level names
are lazy re-exports (PEP 562), so ``import repro_torch`` stays cheap.
"""

from __future__ import annotations

__all__ = [
    "Session",
    "serve",
    "ServeConfig",
    "list_policies",
    "FaultPlan",
    "Observability",
]

#: public name -> defining module (resolved on first attribute access)
_EXPORTS = {
    "Session": "repro_torch.api.session",
    "ServeConfig": "repro_torch.api.config",
    "list_policies": "repro_torch.api.policy",
    "serve": "repro_torch.traffic.simulator",
    "FaultPlan": "repro_torch.chaos",
    "Observability": "repro_torch.obs",
}


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(module), name)
    globals()[name] = value  # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
