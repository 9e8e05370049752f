"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The package mirrors ``repro``'s layout (``kernels``, ``core``, ``sim``,
``api``, ``distributed``, ``models``, ``configs``, ``serving``): each module
holds the counterpart of the module of the same name there.  It imports
``torch`` and ``numpy`` only, never ``jax`` and nothing of ``repro``.

Entry points that create tensors default to ``device="cuda"`` and raise when
CUDA is absent; a caller that wants the CPU passes ``device="cpu"``.
Functions that take tensors run where the tensors are.
"""
