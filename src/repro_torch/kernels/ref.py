"""Plain PyTorch versions of the partitioned-GEMM kernels.

Semantics contract shared with ``partitioned_matmul.py`` (the same as
``repro.kernels.ref``):

* ``xs``      — (E, T, K): one (padded) activation matrix per tenant.  Rows
  at/after ``valid_t[e]`` and K-columns beyond the tenant's true K MUST be
  zero-padded by the caller.
* ``w``       — (K, N): all tenants' weight matrices concatenated along N.
* ``owner``   — (N // block_n,) int: which tenant owns each column block.
* ``valid_t`` — (E,) int: number of valid streamed rows per tenant.

Output — (T, N) f32: column block j equals ``xs[owner[j]] @ w[:, block j]``
with rows >= valid_t[owner[j]] equal to zero.

The CPU tests use these functions through the kernel wrappers; on a card
only ``chip_smoke.py`` calls them, to hold the kernels against them.
"""

from __future__ import annotations

import torch


def partitioned_matmul_ref(
    xs: torch.Tensor,
    w: torch.Tensor,
    owner: torch.Tensor,
    valid_t: torch.Tensor,
    block_n: int,
) -> torch.Tensor:
    """O(E·T·K·N) reference for the multi-tenant partitioned GEMM."""
    E, T, K = xs.shape
    K2, N = w.shape
    if K2 != K or N % block_n or owner.shape != (N // block_n,):
        raise ValueError(
            f"bad shapes: xs {tuple(xs.shape)}, w {tuple(w.shape)}, "
            f"owner {tuple(owner.shape)}, block_n {block_n}"
        )
    owner = owner.to(device=xs.device, dtype=torch.long)
    valid_t = valid_t.to(device=xs.device, dtype=torch.long)
    # out[:, j] = xs[owner[j]] @ w[:, j] — computed densely, then the owner's
    # plane is selected per column
    full = torch.einsum("etk,kn->etn", xs.float(), w.float())
    owner_per_col = owner.repeat_interleave(block_n)  # (N,)
    out = torch.gather(full, 0, owner_per_col.expand(1, T, N))[0]
    # Mul_En masking: rows past the owning tenant's valid_t are zero
    rows = torch.arange(T, device=xs.device)[:, None]
    live = rows < valid_t[owner_per_col][None, :]
    return torch.where(live, out, 0.0)


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain GEMM oracle (single-tenant baseline)."""
    return x.float() @ w.float()
