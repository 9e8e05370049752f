"""Carry a JAX parameter tree, or an optimizer state, across to the port.

``params_from_jax`` takes a JAX package pytree of nested dicts with every
leaf as a NumPy array (``jax.tree.map(np.asarray, tree)``) and returns the
same tree of tensors: same keys, stacked layer axis, ``(in, out)`` weights,
same dtypes.  A parameter tree, a gradient tree and an optimizer state
(``init_opt_state``: f32 master, m and v trees and an int32 ``step``
scalar) all go across, so both packages start a train step from the same
numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device


def _leaf(a: np.ndarray, device: torch.device) -> torch.Tensor:
    # NumPy has no native bfloat16: a bf16 leaf arrives as an
    # ``ml_dtypes.bfloat16`` array, or as the same-width uint16 view that
    # the JAX package's checkpoints store.  Either way the bits go across
    # through a 16-bit integer view, never through float.
    a = np.array(a)  # a writable, contiguous copy of the leaf
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, *, device="cuda"):
    """The port's parameter tree on ``device`` for a JAX tree of NumPy
    leaves (nested dicts)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=dev) for k, v in tree.items()}
    return _leaf(tree, dev)
